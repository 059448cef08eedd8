"""Environment-term contribution to END-TO-END error, isolated at the
pipeline stage level.

Same G-buffer, same lights, same exposure: `stages.deferred_shade` with the
f32 environment content (prefiltered cube, BRDF LUT, sky) vs the same
content stored at 16 bits. The reference keeps its prefiltered env / BRDF
LUT as RGBA16F textures (DeferredPipeline.h:38-41), so that storage
precision is the parity budget; and dropping the environment must move the
frame far beyond it, so the env path is shown to be live.
"""

import numpy as np
import jax.numpy as jnp

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.resource import reflection_def  # noqa: F401
from direct12pbrrenderer.resource.default_meshes import sphere_mesh
from direct12pbrrenderer.resource.resources import (
    CubeMapResource,
    MaterialResource,
    MeshResource,
    ModelResource,
)
from direct12pbrrenderer.resource.storage import (
    CubeMapTextureData,
    ETextureFormat,
    TextureData,
)
from direct12pbrrenderer.scene.camera import Camera
from direct12pbrrenderer.scene.scene import Scene, SceneLight, SceneModel


def _sky_cube(size=16):
    """Horizon-gradient HDR sky (nonzero env taps at every roughness)."""
    from direct12pbrrenderer.ops.common import cubemap_face_dirs

    dirs = cubemap_face_dirs(size)
    y = dirs[..., 1:2]
    sky = (np.array([0.4, 0.5, 0.8], np.float32) * np.clip(y, 0, 1)
           + np.array([0.3, 0.25, 0.2], np.float32) * np.clip(-y, 0, 1)
           + 0.2 + 0.3 * np.clip(dirs[..., :1], 0, 1))
    faces = [
        TextureData.from_array(
            np.concatenate([sky[i], np.ones_like(sky[i][..., :1])],
                           -1).astype(np.float32),
            ETextureFormat.R32G32B32A32_FLOAT,
        )
        for i in range(6)
    ]
    return CubeMapTextureData(faces=faces)


def _scene():
    # one sphere with constant roughness under a gradient sky
    scene = Scene("mem/env_iso")
    for i, (x, rough, metal) in enumerate([(0.0, 0.4, 0.3)]):
        mesh_res = MeshResource(f"mem/s{i}", f"mem/s{i}_data")
        mesh_res.mesh = sphere_mesh(1.0, 16, 12)
        mat = MaterialResource(f"mem/m{i}")
        mat.set_shader("gbuffer.hlsl")
        mat.set_parameter("Albedo", np.array([0.8, 0.6, 0.4], np.float32))
        mat.set_parameter("Roughness", rough)
        mat.set_parameter("Metallic", metal)
        model = ModelResource(f"mem/model{i}", mesh_res, [mat])
        sm = SceneModel(f"ball{i}")
        sm.set_model(model)
        sm.translation = np.array([x, 0, 0], np.float32)
        sm.update_transform()
        sm.local_bound_min, sm.local_bound_max = model.bound
        scene.add_model(sm)
    light = SceneLight("key")
    light.translation = np.array([2.0, 2.0, -2.0], np.float32)
    light.update_transform()
    light.color = np.array([1.0, 1.0, 1.0], np.float32)
    light.set_intensity(12.0)
    light.set_radius(2.0)
    scene.add_light(light)
    sky_res = CubeMapResource("mem/sky")
    sky_res.cubemap = _sky_cube(16)
    scene.set_skybox(sky_res)
    return scene


def _quantize_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_env_kernel_isolated_error():
    from direct12pbrrenderer.ops import postprocess
    from direct12pbrrenderer.ops.common import CubeMipAtlas, make_quad_tex2d
    from direct12pbrrenderer.pipeline import stages
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    cfg = RenderConfig(width=128, height=96, max_triangles=2048,
                       max_vertices=2048, max_instances=4, max_lights=4)
    pipe = DeferredRenderPipeline(
        _scene(), cfg, tile_h=16, tile_w=64, bin_cap=256,
        prefilter_size=8, brdf_lut_size=16,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 3])
    cam.rotate(0, np.pi, 0)

    # one G-buffer through the XLA stages, shared by every shade variant
    p = pipe.packed
    planes = cam.frustum_planes()
    view = cam.view_matrix()
    env = dict(pipe.buffers)
    rw, rh = pipe.render_w, pipe.render_h
    setup, vattrs = stages.geometry(
        env, jnp.asarray(p.model_mats),
        jnp.asarray(np.ascontiguousarray(
            np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))),
        jnp.asarray(p.instance_visibility(planes)),
        jnp.asarray(cam.projection_matrix() @ view), cfg.width, cfg.height,
    )
    bins = stages.binning(setup, rw, rh, 16, 64, 256)
    tri_id, depth = stages.rasterize(setup, bins, rw, rh, 16, 64, False)
    gb = stages.gbuffer_shade(tri_id, depth, setup, env, vattrs, rw, rh,
                              texture_filter="trilinear")
    active = stages.active_lights(
        env, jnp.asarray(p.visible_lights(planes)), jnp.asarray(view), 64
    )
    inv_view = jnp.asarray(cam.world_matrix())
    cam_pos = jnp.asarray(cam.position)

    def shade(buffers):
        rt = stages.deferred_shade(
            gb, buffers, active, inv_view, cam_pos, cfg, rw, rh,
            full_height=cfg.height, full_width=cfg.width,
        )
        # fixed exposure so the comparison is on shading alone
        img = postprocess.tone_map(rt[: cfg.height, : cfg.width],
                                   jnp.asarray(0.18, jnp.float32))
        return np.asarray(img, np.float64)

    def with_content(pf, sky, lut):
        out = dict(env)
        out["PrefilterEnvMap"] = CubeMipAtlas([jnp.asarray(m) for m in pf])
        out["SkyBoxTexture"] = CubeMipAtlas([jnp.asarray(sky)])
        out["PrecomputeBRDF"] = (make_quad_tex2d(jnp.asarray(lut)),
                                 lut.shape[0])
        return out

    pf = [np.asarray(m) for m in pipe.prefiltered_mip_faces]
    sky = np.asarray(pipe.skybox_faces_mip0)
    lut = np.asarray(pipe.brdf_lut)
    a = shade(env)
    # rebuilding the atlases from the same content is the identity
    np.testing.assert_array_equal(shade(with_content(pf, sky, lut)), a)

    b_q = shade(with_content([_quantize_bf16(m) for m in pf],
                             _quantize_bf16(sky), _quantize_bf16(lut)))
    rmse_q = float(np.sqrt(np.mean((a - b_q) ** 2)))
    # storage-precision budget (16-bit env store vs f32)
    assert 0.0 < rmse_q <= 1.5e-3, rmse_q

    b_0 = shade(with_content([np.zeros_like(m) for m in pf],
                             np.zeros_like(sky), lut))
    rmse_0 = float(np.sqrt(np.mean((a - b_0) ** 2)))
    assert rmse_0 > 100 * rmse_q, (rmse_0, rmse_q)
