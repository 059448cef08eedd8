"""Multi-device (8 virtual CPU devices) frame rendering: sharded == single.

`build_sharded_frame(mesh, pipe)` reads every knob off the pipeline it
shards, so these tests construct ONE pipeline per case and assert the
sharded frame reproduces its single-chip render — the anti-drift contract.
"""

import numpy as np
import jax
import pytest

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.parallel import frame_sharded
from test_pipeline import build_scene


CFG = RenderConfig(
    width=128, height=96, max_triangles=2048, max_vertices=2048,
    max_instances=4, max_lights=16,
)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_single_chip():
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    pipe = DeferredRenderPipeline(
        build_scene(), CFG, tile_h=12, tile_w=64, bin_cap=512,
        prefilter_size=16, brdf_lut_size=32,
    )
    cam = Camera(CFG.fov, CFG.width, CFG.height, CFG.near, CFG.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)

    ref = np.asarray(pipe.render(cam))

    mesh = frame_sharded.make_mesh(8)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    rgb8, avg = frame(*frame_sharded.frame_args(pipe, cam))
    out = np.asarray(rgb8)
    assert out.shape == ref.shape
    # identical math, identical result (up to reduction-order noise in u8)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert (diff > 1).mean() < 1e-3
    assert float(avg) > 0

    # FrameStats threaded through the sharded path: per-band bin counts
    # concatenate to the full tile grid; tile overflow is the worst band's
    frame_s = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    rgb8_s, avg_s, bin_counts, light_trunc = frame_s(
        *frame_sharded.frame_args(pipe, cam)
    )
    assert np.array_equal(np.asarray(rgb8_s), out)
    n_tiles = (CFG.height // 12) * (CFG.width // 64)
    assert np.asarray(bin_counts).shape == (n_tiles,)
    assert int(np.asarray(bin_counts).sum()) > 0
    assert int(light_trunc) == 0


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 virtual devices")
def test_sharded_with_kernels_matches_single_chip():
    """The sharded path routes through the SAME Triton kernels as the single
    device (interpret mode): per-band tiling + y_offset plumbing through the
    raster tile kernel and the tile light kernel."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    cfg = RenderConfig(
        width=128, height=96, max_triangles=2048, max_vertices=2048,
        max_instances=4, max_lights=16,
    )
    pipe = DeferredRenderPipeline(
        build_scene(), cfg, tile_h=16, tile_w=64, bin_cap=512,
        prefilter_size=16, brdf_lut_size=32, pallas_interpret=True,
        light_tile=(16, 64),
    )
    assert pipe.use_pallas and pipe.light_tile == (16, 64)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    ref = np.asarray(pipe.render(cam))

    mesh = frame_sharded.make_mesh(2)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    rgb8, avg = frame(*frame_sharded.frame_args(pipe, cam))
    out = np.asarray(rgb8)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert (diff > 1).mean() < 1e-3


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_replicate_places_buffers_on_every_device():
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    pipe = DeferredRenderPipeline(
        build_scene(), CFG, tile_h=16, tile_w=64, bin_cap=256,
        prefilter_size=8, brdf_lut_size=16,
    )
    mesh = frame_sharded.make_mesh(4)
    bufs = frame_sharded.replicate(mesh, pipe.buffers)
    want = set(mesh.devices.flat)
    leaves = jax.tree_util.tree_leaves(bufs)
    assert leaves
    for leaf in leaves:
        assert set(leaf.sharding.device_set) == want
        assert leaf.sharding.is_fully_replicated


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_pad_to_tile_bands():
    """Band heights that are not tile multiples pad to the tile grid inside
    each band and crop back (the 1080p-on-4-cards case: 270-row bands on a
    272-row canvas)."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    cfg = RenderConfig(
        width=128, height=120, max_triangles=2048, max_vertices=2048,
        max_instances=4, max_lights=16,
    )
    # 120 / 4 devices = 30-row bands; tile_h 12 -> 36-row band canvases
    pipe = DeferredRenderPipeline(
        build_scene(), cfg, tile_h=12, tile_w=64, bin_cap=512,
        prefilter_size=16, brdf_lut_size=32,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    ref = np.asarray(pipe.render(cam))

    mesh = frame_sharded.make_mesh(4)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    rgb8, _ = frame(*frame_sharded.frame_args(pipe, cam))
    out = np.asarray(rgb8)
    assert out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert (diff > 1).mean() < 1e-3
