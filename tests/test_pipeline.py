"""End-to-end pipeline test on a synthetic in-memory scene."""

import numpy as np
import pytest

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.resource import reflection_def  # noqa: F401
from direct12pbrrenderer.resource.default_meshes import sphere_mesh
from direct12pbrrenderer.resource.resources import (
    MaterialResource,
    MeshResource,
    ModelResource,
)
from direct12pbrrenderer.scene.camera import Camera
from direct12pbrrenderer.scene.scene import Scene, SceneLight, SceneModel


def build_scene(emissive=False):
    mesh_res = MeshResource("mem/sphere", "mem/sphere_data")
    mesh_res.mesh = sphere_mesh(1.0, 16, 12)

    mat = MaterialResource("mem/mat")
    mat.set_shader("gbuffer.hlsl")
    mat.set_parameter("Albedo", np.array([0.8, 0.2, 0.2], np.float32))
    mat.set_parameter("Roughness", 0.4)
    mat.set_parameter("Metallic", 0.1)
    if emissive:
        mat.set_parameter("Emission", 1.0)
    model = ModelResource("mem/model", mesh_res, [mat])

    scene = Scene("mem/scene")
    sm = SceneModel("ball")
    sm.set_model(model)
    sm.translation = np.array([0, 0, 0], np.float32)
    sm.update_transform()
    sm.local_bound_min, sm.local_bound_max = model.bound
    scene.add_model(sm)

    light = SceneLight("key")
    light.translation = np.array([2.0, 2.0, -2.0], np.float32)
    light.update_transform()
    light.color = np.array([1.0, 1.0, 1.0], np.float32)
    light.set_intensity(20.0)
    light.set_radius(2.0)
    scene.add_light(light)
    return scene


CFG = RenderConfig(
    width=320, height=240, max_triangles=2048, max_vertices=2048,
    max_instances=4, max_lights=16,
)


@pytest.fixture(scope="module")
def pipeline():
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    return DeferredRenderPipeline(
        build_scene(), CFG, tile_h=60, tile_w=160, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32,
    )


@pytest.fixture(scope="module")
def camera():
    cam = Camera(CFG.fov, CFG.width, CFG.height, CFG.near, CFG.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)  # look down -z toward the origin
    return cam


def test_renders_lit_sphere(pipeline, camera):
    img = np.asarray(pipeline.render(camera))
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    cy, cx = 120, 160
    sphere_region = img[cy - 55 : cy + 55, cx - 55 : cx + 55]
    border = img[:10, :10]
    # lit sphere visible, black sky at the border (no skybox)
    assert sphere_region.mean() > 5
    # faint bloom spill is expected at the border; it must stay far dimmer
    # than the subject
    assert border.mean() < 6
    assert sphere_region.mean() > border.mean() * 2
    # light at world (2,2,-2); the pi-yaw camera mirrors +x to image-left:
    # the lit crescent must be on the upper-left of the sphere
    left = img[cy - 30 : cy + 30, cx - 60 : cx - 20].mean()
    right = img[cy - 30 : cy + 30, cx + 20 : cx + 60].mean()
    assert left > right * 1.5
    # red-dominant material where lit
    lit = img.reshape(-1, 3)[img.reshape(-1, 3).sum(1) > 30]
    assert lit[:, 0].mean() >= lit[:, 2].mean()
    stats = pipeline.last_stats
    assert stats.visible_instances == 1 and stats.visible_lights == 1


def test_exposure_adapts_over_frames(pipeline, camera):
    a0 = float(pipeline.avg_luminance)
    for _ in range(3):
        pipeline.render(camera, delta_time=0.5)
    a1 = float(pipeline.avg_luminance)
    assert a1 != a0
    assert a1 > 0


def test_render_sequence_matches_per_frame(camera):
    """render_sequence (N frames in one dispatch, scan over camera packs)
    must reproduce N per-frame render() calls exactly: same frames, same
    exposure-EMA carry chain. Fresh pipelines (the shared fixture's EMA
    state is test-order dependent)."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    mk = lambda: DeferredRenderPipeline(
        build_scene(), CFG, tile_h=60, tile_w=160, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32,
    )
    cams = []
    for i in range(3):
        c = Camera(CFG.fov, CFG.width, CFG.height, CFG.near, CFG.far)
        c.move([0.1 * i, 0, 4])
        c.rotate(0, np.pi + 0.02 * i, 0)
        cams.append(c)

    a = mk()
    singles = [np.asarray(a.render(c, delta_time=0.25)) for c in cams]
    avg_a = float(a.avg_luminance)

    b = mk()
    seq = np.asarray(b.render_sequence(cams, delta_time=0.25))
    assert seq.shape == (3, CFG.height, CFG.width, 3)
    for i in range(3):
        np.testing.assert_array_equal(seq[i], singles[i])
    assert float(b.avg_luminance) == avg_a


def test_camera_behind_culls_everything(pipeline):
    cam = Camera(CFG.fov, CFG.width, CFG.height, CFG.near, CFG.far)
    cam.move([0, 0, 4])  # looking +z, sphere is behind
    img = np.asarray(pipeline.render(cam))
    assert pipeline.last_stats.visible_instances == 0
    assert img.max() == 0  # nothing but black sky


def test_dynamic_scene_object_motion(pipeline, camera):
    """Per-frame transform upload: moving the object moves its pixels
    (the reference's per-object instance-cbuffer path)."""
    sm = pipeline.scene.models[0]
    base = np.asarray(pipeline.render(camera))
    xs0 = np.nonzero(base.sum(-1).sum(0) > 10)[0]

    sm.translation = np.array([1.2, 0.0, 0.0], np.float32)
    sm.update_transform()
    pipeline.packed.model_mats[0] = sm.world_matrix
    pipeline.packed.inv_model_mats[0] = np.linalg.inv(sm.world_matrix)
    bmin, bmax = sm.world_bound()
    pipeline.packed.instance_bounds[0] = np.stack([bmin, bmax])
    moved = np.asarray(pipeline.render(camera))
    xs1 = np.nonzero(moved.sum(-1).sum(0) > 10)[0]

    # world +x maps to image-left under the pi-yaw camera
    assert xs1.mean() < xs0.mean() - 10

    # restore for other tests
    sm.translation = np.zeros(3, np.float32)
    sm.update_transform()
    pipeline.packed.model_mats[0] = sm.world_matrix
    pipeline.packed.inv_model_mats[0] = np.linalg.inv(sm.world_matrix)
    bmin, bmax = sm.world_bound()
    pipeline.packed.instance_bounds[0] = np.stack([bmin, bmax])


def test_kernel_paths_match_xla_paths(camera):
    """The Triton kernel route (raster tile kernel + tile light kernel, in
    Pallas interpret mode) must reproduce the plain XLA frame.

    Fresh pipelines on both sides: earlier tests mutate the shared fixture's
    scene in place."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    mk = lambda **kw: DeferredRenderPipeline(
        build_scene(), CFG, tile_h=16, tile_w=64, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32, **kw,
    )
    kpipe = mk(pallas_interpret=True, light_tile=(16, 64))
    assert kpipe.use_pallas and kpipe.route == "triton"
    assert "pallas-triton-interpret" in kpipe.kernels
    xpipe = mk()
    assert not xpipe.use_pallas and xpipe.kernels == (
        "route=xla raster=xla lights=xla-fori")
    ref = np.asarray(xpipe.render(camera)).astype(np.float32)
    got = np.asarray(kpipe.render(camera)).astype(np.float32)
    rmse = float(np.sqrt(np.mean((ref - got) ** 2))) / 255.0
    assert rmse < 1e-3, rmse


def test_device_cull_matches_host(camera):
    """The on-device Cull pass (ops/common.frustum_cull_aabbs) must agree
    with the host twin (utils/mathlib) over a camera sweep — same p-vertex
    selection, same fp32 op order, so the masks match exactly."""
    import jax.numpy as jnp

    from direct12pbrrenderer.ops import common
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    pipe = DeferredRenderPipeline(
        build_scene(), CFG, tile_h=60, tile_w=160, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32,
    )
    p = pipe.packed
    cam = Camera(CFG.fov, CFG.width, CFG.height, CFG.near, CFG.far)
    cam.move([0, 0, 4])
    for i in range(8):
        cam.rotate(0.05, np.pi / 4, 0.0)
        planes = cam.frustum_planes()
        host = p.instance_visibility(planes)
        dev = np.zeros_like(host)
        n = p.instance_count
        dev[:n] = np.asarray(common.frustum_cull_aabbs(
            jnp.asarray(planes), jnp.asarray(p.instance_bounds[:n, 0]),
            jnp.asarray(p.instance_bounds[:n, 1]),
        ))
        np.testing.assert_array_equal(dev, host)
        # FrameStats counts come from the device now: cross-check one pose
        pipe.render(cam)
        assert pipe.last_stats.visible_instances == int(host.sum())


def test_arbitrary_resolution_pad_and_crop():
    """Any width x height renders (the reference renders at any window size,
    App.h:77-78): the raster canvas pads to the tile grid and the RT is
    cropped before post. A non-divisible-width pipeline must agree with the
    divisible-path render of the same logical frame."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.config import RenderConfig

    scene = build_scene()
    cfg = RenderConfig(width=320, height=240, max_triangles=2048,
                       max_vertices=2048, max_instances=4, max_lights=16)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)

    def render(tile_h, tile_w):
        pipe = DeferredRenderPipeline(
            scene, cfg, tile_h=tile_h, tile_w=tile_w, bin_cap=256,
            prefilter_size=16, brdf_lut_size=32,
        )
        return np.asarray(pipe.render(cam)).astype(int)

    ref = render(60, 160)        # 320x240 divides exactly
    padded = render(48, 128)     # width pads 320 -> 384, cropped back
    assert padded.shape == (240, 320, 3)
    # identical frame up to texture-LOD quad derivatives at the crop
    # boundary (the padded canvas extends the last derivative quad)
    assert np.abs(padded - ref).max() <= 2
    assert np.mean(np.abs(padded - ref) > 1) < 0.001

    # fully odd size end-to-end (pads in both axes)
    cfg_odd = RenderConfig(width=317, height=233, max_triangles=2048,
                           max_vertices=2048, max_instances=4, max_lights=16)
    cam_odd = Camera(cfg_odd.fov, cfg_odd.width, cfg_odd.height,
                     cfg_odd.near, cfg_odd.far)
    cam_odd.move([0, 0, 4])
    cam_odd.rotate(0, np.pi, 0)
    pipe = DeferredRenderPipeline(
        scene, cfg_odd, tile_h=60, tile_w=160, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32,
    )
    img = np.asarray(pipe.render(cam_odd))
    assert img.shape == (233, 317, 3)
    assert img[60:180, 80:240].mean() > 5  # sphere visible
