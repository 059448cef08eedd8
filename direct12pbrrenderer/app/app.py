"""Application shell: scene loading, frame loop, camera scripting, stats.

The headless counterpart of `Engine/Source/App.cpp`: where the reference
opens a Win32 window, pumps WM_PAINT and drives a WASD fly camera
(App.cpp:117-152, 334-404), this app renders N frames to PNGs/video frames
with an optional scripted camera path, and reports the FPS + culling counters
the reference shows in its window title.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np

from ..config import (
    DEFAULT_FAR,
    DEFAULT_FOV,
    DEFAULT_NEAR,
    RenderConfig,
)
from ..resource import reflection_def  # noqa: F401
from ..resource.loader import ResourceLoader
from ..scene.camera import Camera
from ..scene.scene import Scene
from ..utils.mathlib import Deg2Rad


@dataclass
class AppConfig:
    asset_root: str = "."
    scene: str = "Asset/Scene/main.json"
    width: int = 1440
    height: int = 960
    frames: int = 60
    output_dir: str | None = None
    camera_pos: tuple = (0.0, 3.0, 10.0)
    camera_yaw_deg: float = 180.0
    camera_pitch_deg: float = 0.0
    orbit_deg_per_frame: float = 0.0  # scripted fly-around
    # 32x32 tiles: the fastest of the four power-of-two tiles measured on
    # the H100 at 1080p (PERF.md, PR 1 tile sweep)
    tile_h: int = 32
    tile_w: int = 32
    bin_cap: int = 2048
    atlas_max_dim: int | None = 1024
    prefilter_size: int | None = None
    max_triangles: int = 65536
    max_vertices: int = 65536
    route: str | None = None  # kernel route; None = the platform's


class App:
    """Load -> compile -> frame loop (App::Run / InternalRun analog)."""

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        loader = ResourceLoader.set_instance(ResourceLoader(cfg.asset_root))
        self.scene = loader.load_resource(Scene, cfg.scene)

        render_cfg = RenderConfig(
            width=cfg.width,
            height=cfg.height,
            max_triangles=cfg.max_triangles,
            max_vertices=cfg.max_vertices,
            max_instances=max(len(self.scene.models), 1),
        )
        from ..pipeline.deferred import DeferredRenderPipeline

        self.pipeline = DeferredRenderPipeline(
            self.scene,
            render_cfg,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            bin_cap=cfg.bin_cap,
            atlas_max_dim=cfg.atlas_max_dim,
            prefilter_size=cfg.prefilter_size,
            route=cfg.route,
        )
        # camera defaults match App::Initialize (App.cpp:99-101)
        self.camera = Camera(DEFAULT_FOV, cfg.width, cfg.height, DEFAULT_NEAR, DEFAULT_FAR)
        self.camera.move(cfg.camera_pos)
        self.camera.rotate(
            0.0, cfg.camera_yaw_deg * Deg2Rad, cfg.camera_pitch_deg * Deg2Rad
        )

    def run(self) -> dict:
        cfg = self.cfg
        out_dir = Path(cfg.output_dir) if cfg.output_dir else None
        if out_dir:
            out_dir.mkdir(parents=True, exist_ok=True)

        # warmup/compile frame
        t0 = time.perf_counter()
        jax.block_until_ready(self.pipeline.render(self.camera))
        compile_s = time.perf_counter() - t0

        frame_times = []
        writes = []
        for i in range(cfg.frames):
            if cfg.orbit_deg_per_frame:
                self.camera.rotate(0.0, cfg.orbit_deg_per_frame * Deg2Rad, 0.0)
            t0 = time.perf_counter()
            img = jax.block_until_ready(
                self.pipeline.render(self.camera, delta_time=1.0 / 60.0))
            frame_times.append(time.perf_counter() - t0)
            img_np = np.asarray(img)
            if out_dir:
                # PNG encodes ride the worker pool (TaskScheduler analog) so
                # disk IO never blocks the frame loop
                from PIL import Image

                from ..utils.threading import shared_pool

                path = out_dir / f"frame_{i:04d}.png"
                writes.append(
                    shared_pool().schedule(
                        lambda a=img_np, p=path: Image.fromarray(a).save(p)
                    )
                )

        for f in writes:
            f.result()
        times = np.asarray(frame_times)
        stats = self.pipeline.last_stats
        report = {
            "frames": cfg.frames,
            "resolution": f"{cfg.width}x{cfg.height}",
            "compile_s": round(compile_s, 3),
            "mean_frame_ms": round(float(times.mean()) * 1e3, 3),
            "p50_frame_ms": round(float(np.percentile(times, 50)) * 1e3, 3),
            "fps": round(1.0 / float(times.mean()), 2),
            "visible_instances": stats.visible_instances if stats else 0,
            "total_instances": stats.total_instances if stats else 0,
            "visible_lights": stats.visible_lights if stats else 0,
            "bin_overflow": stats.bin_overflow if stats else 0,
            "kernels": self.pipeline.kernels,
            "device": f"{jax.devices()[0].platform} "
                      f"{jax.devices()[0].device_kind}",
        }
        return report


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="direct12pbrrenderer — deferred PBR renderer in JAX"
    )
    ap.add_argument("--asset-root", default="/root/reference/DeferredRendering")
    ap.add_argument("--scene", default="Asset/Scene/main.json")
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--orbit", type=float, default=0.0, help="deg/frame camera orbit")
    ap.add_argument("--camera", type=float, nargs=3, default=(0.0, 3.0, 10.0))
    ap.add_argument("--yaw", type=float, default=180.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--bin-cap", type=int, default=2048)
    ap.add_argument("--tile", type=int, nargs=2, default=(32, 32))
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run the interactive browser viewer instead of "
                         "writing frames (WASD + right-drag fly camera)")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    app = App(
        AppConfig(
            asset_root=args.asset_root,
            scene=args.scene,
            width=args.width,
            height=args.height,
            frames=args.frames,
            output_dir=args.out,
            camera_pos=tuple(args.camera),
            camera_yaw_deg=args.yaw,
            camera_pitch_deg=args.pitch,
            orbit_deg_per_frame=args.orbit,
            tile_h=args.tile[0],
            tile_w=args.tile[1],
            bin_cap=args.bin_cap,
        )
    )
    if args.serve:
        from .viewer import serve

        serve(app, port=args.serve)
        return None
    report = app.run()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
