"""Sponza-class scale: 260k+ triangles through pack/geometry/binning.

The north-star scene class is ~260k triangles (BASELINE.json); these tests
prove the static pools auto-grow past the 65k default, and that the
hierarchical binner keeps every 1080p tile overflow-free at that density.
The full-frame render at this scale is benched on the GPU (bench.py)."""

import numpy as np
import jax
import jax.numpy as jnp

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.pipeline import scene_pack, stages
from direct12pbrrenderer.tools.stress_scene import build_stress_scene


def test_stress_scene_pools_autogrow_and_bin_1080p():
    scene = build_stress_scene(cells_x=512, cells_y=256)
    cfg = RenderConfig(width=1920, height=1080, max_instances=2)
    packed = scene_pack.pack_scene(scene, cfg, atlas_max_dim=256)
    t_pool = packed.tris.shape[0]
    assert t_pool >= 512 * 256 * 2          # auto-grown past the 65k default
    assert packed.tri_valid.sum() == 512 * 256 * 2

    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    # geometry + hierarchical binning at 1080p (full-frame render at this
    # scale runs on the GPU via bench.py; CPU CI checks the binning contract)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, np.pi, 0.35)
    buffers = {
        "positions": jnp.asarray(packed.positions),
        "normals": jnp.asarray(packed.normals),
        "tangents": jnp.asarray(packed.tangents),
        "uvs": jnp.asarray(packed.uvs),
        "vtx_instance": jnp.asarray(packed.vtx_instance),
        "tris": jnp.asarray(packed.tris),
        "tri_instance": jnp.asarray(packed.tri_instance),
        "tri_valid_pool": jnp.asarray(packed.tri_valid),
    }
    planes = cam.frustum_planes()
    view_proj = jnp.asarray(cam.projection_matrix() @ cam.view_matrix())
    normal_mats = np.ascontiguousarray(
        np.transpose(packed.inv_model_mats[:, :3, :3], (0, 2, 1)))
    setup, _ = jax.jit(
        lambda b, m, n, v, vp: stages.geometry(b, m, n, v, vp, 1920, 1080)
    )(buffers, jnp.asarray(packed.model_mats), jnp.asarray(normal_mats),
      jnp.asarray(packed.instance_visibility(planes)), view_proj)
    assert int(np.asarray(setup.valid).sum()) > 150_000  # most of it on screen

    # horizon tiles legitimately collect thousands of far cells: the scale
    # setting uses bin_cap 8192 (the bench uses the same)
    bins = jax.jit(lambda s: stages.binning(s, 1920, 1080, 24, 128, 8192))(setup)
    counts = np.asarray(bins.counts)
    assert counts.max() <= 8192, f"bin overflow at 1080p: {counts.max()}"
    assert counts.sum() > 150_000
