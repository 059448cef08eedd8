"""Interactive viewer (app/viewer.py): HTTP endpoints + input semantics."""

import json
import threading
import time
import types
import urllib.request

import numpy as np

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.scene.camera import Camera
from test_pipeline import build_scene

PORT = 8765


def _make_app():
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    cfg = RenderConfig(width=160, height=120, max_triangles=2048,
                       max_vertices=2048, max_instances=4, max_lights=16)
    pipe = DeferredRenderPipeline(
        build_scene(), cfg, tile_h=60, tile_w=160, bin_cap=256,
        prefilter_size=16, brdf_lut_size=32,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    return types.SimpleNamespace(pipeline=pipe, camera=cam)


def test_viewer_serves_page_and_steps_camera():
    from direct12pbrrenderer.app import viewer

    app = _make_app()
    t = threading.Thread(target=viewer.serve, args=(app, PORT), daemon=True)
    t.start()
    for _ in range(50):
        try:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{PORT}/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.2)
    assert b"direct12pbrrenderer" in page

    pos0 = np.asarray(app.camera.position).copy()

    def step(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{PORT}/step",
            data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read(), json.loads(r.headers["X-Stats"])

    jpeg, stats = step({"w": True})
    assert jpeg[:2] == b"\xff\xd8"  # JPEG magic
    assert "fps" in stats["caption"] and "drawed" in stats["caption"]
    pos1 = np.asarray(app.camera.position)
    # W moves 0.05 units along the camera forward axis (App.cpp:125-145)
    assert np.isclose(np.linalg.norm(pos1 - pos0), 0.05, atol=1e-5)

    yaw0 = app.camera.rotation[1] if hasattr(app.camera, "rotation") else None
    step({"rmb": True, "dx": 100, "dy": 0})
    pos2 = np.asarray(app.camera.position)
    assert np.allclose(pos1, pos2)  # rotation does not translate


def test_viewer_input_semantics_stub_pipeline():
    """Fast tier: HTTP endpoints + App::Update input constants without a real
    pipeline compile (the rendering path is pinned by the slow e2e test
    above; this stub keeps the viewer module covered in the <2-min core)."""
    from direct12pbrrenderer.app import viewer

    class StubStats:
        visible_instances = 3
        total_instances = 5

    class StubPipe:
        last_stats = StubStats()

        def render(self, cam, delta_time=1.0 / 60.0):
            return np.zeros((12, 16, 3), np.uint8)

    cfg = RenderConfig(width=16, height=12)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    app = types.SimpleNamespace(pipeline=StubPipe(), camera=cam)
    port = PORT + 1
    t = threading.Thread(target=viewer.serve, args=(app, port), daemon=True)
    t.start()
    page = None
    for _ in range(50):
        try:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.2)
    assert page and b"direct12pbrrenderer" in page

    def step(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/step",
            data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read(), json.loads(r.headers["X-Stats"])

    pos0 = np.asarray(app.camera.position).copy()
    jpeg, stats = step({"w": True})
    assert jpeg[:2] == b"\xff\xd8"
    assert "culled: 2 drawed: 3" in stats["caption"]
    pos1 = np.asarray(app.camera.position)
    assert np.isclose(np.linalg.norm(pos1 - pos0), 0.05, atol=1e-5)
    step({"rmb": True, "dx": 50, "dy": -20})
    assert np.allclose(pos1, np.asarray(app.camera.position))
