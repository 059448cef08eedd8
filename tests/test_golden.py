"""Golden-frame regression: deterministic render pinned as a PNG.

Regenerate after an INTENTIONAL image change with:
  UPDATE_GOLDENS=1 python -m pytest tests/test_golden.py
"""

import os
from pathlib import Path

import numpy as np
import pytest

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.utils.fidelity import compare_to_golden, rmse
from test_pipeline import build_scene

GOLDEN_DIR = Path(__file__).parent / "goldens"
UPDATE = bool(os.environ.get("UPDATE_GOLDENS"))


def test_rmse_metric():
    a = np.zeros((4, 4, 3), np.uint8)
    b = a.copy()
    b[0, 0] = 255
    assert rmse(a, a) == 0.0
    assert rmse(a, b) == pytest.approx(np.sqrt(3 / 48), rel=1e-6)


def test_golden_sphere_frame():
    """Lit-sphere frame with bloom + exposure, 2 frames of EMA settling.

    Tolerance 2e-3: fp reassociation across XLA versions/backends lands well
    under it; real shading changes land far over it."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    cfg = RenderConfig(
        width=256, height=192, max_triangles=2048, max_vertices=2048,
        max_instances=4, max_lights=16,
    )
    pipe = DeferredRenderPipeline(
        build_scene(), cfg, tile_h=24, tile_w=128, bin_cap=512,
        prefilter_size=16, brdf_lut_size=32,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    img = None
    for _ in range(2):
        img = np.asarray(pipe.render(cam, delta_time=0.25))
    err = compare_to_golden(img, GOLDEN_DIR / "sphere_256x192.png", tol=2e-3,
                            update=UPDATE)
    assert err <= 2e-3


def test_golden_emissive_frame():
    """Emissive-sphere frame (exercises emission + bloom + the RGBA8 emission
    saturation quirk)."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera

    cfg = RenderConfig(
        width=256, height=192, max_triangles=2048, max_vertices=2048,
        max_instances=4, max_lights=16,
    )
    pipe = DeferredRenderPipeline(
        build_scene(emissive=True), cfg, tile_h=24, tile_w=128, bin_cap=512,
        prefilter_size=16, brdf_lut_size=32,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    img = None
    for _ in range(2):
        img = np.asarray(pipe.render(cam, delta_time=0.25))
    err = compare_to_golden(img, GOLDEN_DIR / "emissive_256x192.png", tol=2e-3,
                            update=UPDATE)
    assert err <= 2e-3
