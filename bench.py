"""Frame-rate benchmark of the deferred renderer.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N, ...}

Baseline: the north star of 60 FPS at 1920x1080 on a Sponza-class scene
(BASELINE.json; the reference publishes no numbers of its own), so
vs_baseline = sponza_class_fps / 60. Cells:

* sponza_class: the 262,144-triangle terrain under the procedural sky
  (tools/stress_scene.bench_pipeline), the headline;
* lights1k: the 1024-light terrain;
* reference_scene: the reference asset tree's main.json, only with
  --asset-root (the tree is not part of the repository).

Each cell times the same 32-frame yaw path twice: per-call render() (frames
pipelined, the loop ended by block_until_ready) and one render_sequence()
dispatch. Each cell also renders its bench pose through the plain XLA route
and reports the RMSE on the normalized uint8 frame; a cell over 1e-3 makes
the run exit non-zero after the JSON line. Every result carries the device
(platform, kind, count) and the card's name and power limit.

Usage: python bench.py [--smoke] [--frames N] [--width W --height H]
                       [--asset-root DIR] [--skip-secondary]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_FPS = 60.0
GATE_RMSE = 1e-3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--asset-root", default=None,
                    help="reference asset tree; adds the reference_scene cell")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny synthetic scene + small frame (CPU smoke run)")
    ap.add_argument("--skip-secondary", action="store_true",
                    help="headline cell only (skip lights1k / reference)")
    args = ap.parse_args()

    import jax

    from direct12pbrrenderer.utils.compile_cache import enable_compile_cache
    from direct12pbrrenderer.utils.device_info import card_line

    enable_compile_cache()
    devs = jax.devices()
    result = {
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "card": card_line() if devs[0].platform == "gpu" else None,
    }

    if args.smoke:
        import __graft_entry__ as graft

        pipe, cam, _ = graft._tiny_pipeline()
        loop_fps, seq_fps = _measure_fps(pipe, cam, 4)
        result.update({
            "metric": "deferred PBR frame rate, synthetic sphere scene @ "
                      f"{pipe.config.width}x{pipe.config.height}",
            "value": loop_fps, "unit": "fps",
            "vs_baseline": loop_fps / BASELINE_FPS,
            "sequence_fps": seq_fps, "kernels": pipe.kernels,
        })
        print(json.dumps(result))
        return 0

    from direct12pbrrenderer.tools import stress_scene

    cells = [("sponza_class", lambda: stress_scene.bench_pipeline(
        "sponza_class", args.width, args.height))]
    if not args.skip_secondary:
        cells.append(("lights1k", lambda: stress_scene.bench_pipeline(
            "lights1k", args.width, args.height)))
        if args.asset_root:
            cells.append(("reference_scene",
                          lambda: _reference_pipeline(args)))

    failed = []
    for name, build in cells:
        pipe, cam = build()
        out = _cell(name, pipe, cam, args.frames)
        result.update(out)
        if out[f"{name}_rmse_vs_xla"] > GATE_RMSE:
            failed.append(name)
        del pipe
        jax.clear_caches()

    fps = result["sponza_class_fps"]
    result.update({
        "metric": "deferred PBR frame rate, sponza_class @ "
                  f"{args.width}x{args.height}",
        "value": fps, "unit": "fps", "vs_baseline": fps / BASELINE_FPS,
        "rmse_gate": "FAIL " + ",".join(failed) if failed else "pass",
    })
    print(json.dumps(result))
    if failed:
        print(f"bench: fidelity gate failed in {failed} (rmse > {GATE_RMSE})",
              file=sys.stderr)
        return 1
    return 0


def _reference_pipeline(args):
    from direct12pbrrenderer.app.app import App, AppConfig

    app = App(AppConfig(asset_root=args.asset_root, width=args.width,
                        height=args.height))
    return app.pipeline, app.camera


def _cell(name: str, pipe, cam, frames: int) -> dict:
    t0 = time.perf_counter()
    pipe.compile(cam)
    compile_s = time.perf_counter() - t0
    loop_fps, seq_fps = _measure_fps(pipe, cam, frames)
    pipe.render(cam, collect_stats=True)
    st = pipe.last_stats
    return {
        f"{name}_fps": loop_fps,
        f"{name}_sequence_fps": seq_fps,
        f"{name}_compile_s": compile_s,
        f"{name}_kernels": pipe.kernels,
        f"{name}_bin_overflow": st.bin_overflow,
        f"{name}_light_tile_overflow": st.light_tile_overflow,
        f"{name}_visible_lights": st.visible_lights,
        f"{name}_rmse_vs_xla": _rmse_vs_xla(pipe, cam),
    }


def _measure_fps(pipe, cam, frames: int):
    """(per-call loop fps, sequence-dispatch fps) over the same yaw path.

    Per-call loop: render() per pose, frames pipelined asynchronously, the
    loop ended by block_until_ready. Sequence: the same poses in ONE
    render_sequence() dispatch (the playback analog of the reference's
    frame loop, App.cpp:354-380)."""
    import jax

    from direct12pbrrenderer.tools.stress_scene import yaw_path

    cams = yaw_path(cam, frames)
    for c in cams[:2]:  # compile is shared; warm the per-pose upload path
        jax.block_until_ready(pipe.render(c, collect_stats=False))
    t0 = time.perf_counter()
    img = None
    for c in cams:
        img = pipe.render(c, 1.0 / 60.0, collect_stats=False)
    jax.block_until_ready(img)
    loop_fps = frames / (time.perf_counter() - t0)

    jax.block_until_ready(pipe.render_sequence(cams))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(pipe.render_sequence(cams))
    seq_fps = frames / (time.perf_counter() - t0)
    return loop_fps, seq_fps


def _rmse_vs_xla(pipe, cam) -> float:
    """One-pose RMSE of `pipe` vs the same pipeline on the plain XLA route,
    on the normalized uint8 back buffer, from the same exposure carry."""
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    ref_pipe = DeferredRenderPipeline(
        pipe.scene, pipe.config, route="xla",
        texture_filter=pipe.texture_filter,
        tile_h=pipe.tile_h, tile_w=pipe.tile_w, bin_cap=pipe.bin_cap,
        max_active_lights=pipe.max_active_lights,
        atlas_max_dim=pipe.atlas_max_dim,
    )
    prev = pipe.avg_luminance
    ref_pipe.avg_luminance = prev
    a = np.asarray(pipe.render(cam, 1.0 / 60.0, collect_stats=False))
    pipe.avg_luminance = prev
    b = np.asarray(ref_pipe.render(cam, 1.0 / 60.0, collect_stats=False))
    return float(np.sqrt(np.mean(
        (a.astype(np.float64) / 255.0 - b.astype(np.float64) / 255.0) ** 2
    )))


if __name__ == "__main__":
    sys.exit(main())
