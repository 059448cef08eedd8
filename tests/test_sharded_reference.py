"""8-virtual-device sharded rendering vs single-device on the REAL scene."""

import numpy as np
import jax
import pytest

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.parallel import frame_sharded


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_reference_scene_matches(asset_loader):
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera
    from direct12pbrrenderer.scene.scene import Scene

    scene = asset_loader.load_resource(Scene, "Asset/Scene/main.json")
    cfg = RenderConfig(
        width=256, height=192, max_triangles=65536, max_vertices=65536,
        max_instances=40,
    )
    # single-device reference render (tile rows must also split into 8 bands:
    # band_h = 24 -> tile_h 12)
    pipe = DeferredRenderPipeline(
        scene, cfg, tile_h=12, tile_w=128, bin_cap=4096,
        prefilter_size=16, brdf_lut_size=64, atlas_max_dim=256,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 3, 10])
    cam.rotate(0, np.pi, 0)
    ref = np.asarray(pipe.render(cam))

    mesh = frame_sharded.make_mesh(8)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    rgb8, avg = frame(*frame_sharded.frame_args(pipe, cam))
    out = np.asarray(rgb8)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert (diff > 1).mean() < 1e-3

    # same equivalence through the GPU route's Triton kernels (interpret
    # mode on the CPU mesh) — pins that the sharded band plumbing feeds the
    # kernels the card runs (anti-drift)
    pipe_k = DeferredRenderPipeline(
        scene, cfg, tile_h=8, tile_w=128, bin_cap=4096,
        prefilter_size=16, brdf_lut_size=64, atlas_max_dim=256,
        pallas_interpret=True, light_tile=(8, 128),
    )
    assert pipe_k.use_pallas
    ref_k = np.asarray(pipe_k.render(cam))
    frame_pl = frame_sharded.build_sharded_frame(mesh, pipe_k)
    rgb8_pl, _ = frame_pl(*frame_sharded.frame_args(pipe_k, cam))
    diff_pl = np.abs(np.asarray(rgb8_pl).astype(int) - ref_k.astype(int))
    assert (diff_pl > 1).mean() < 1e-3
