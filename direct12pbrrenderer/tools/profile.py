"""Per-pass timing harness — the PIX-marker analog.

The reference wraps every pass in PIXScopedEvent GPU markers
(DeferredPipeline.cpp:8 `PIXScope`, used throughout). XLA fuses our whole
frame into one program, so to attribute time per pass we jit each stage from
`pipeline.stages` separately, feed it the (device-resident) outputs of the
previous stage, and time it over N iterations, each ended by
`block_until_ready`.

Usage:
  python -m direct12pbrrenderer.tools.profile \
      [--scene sponza_class|lights1k|reference] [--width W --height H] \
      [--iters N] [--json FILE]

Prints the per-stage table and one JSON line with the raw milliseconds.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def time_fn(fn, args, iters: int, warmup: int = 2):
    """Median wall ms/iter of fn(*args), each call ended by
    block_until_ready (fn should be jitted; warmup absorbs the compile)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(samples))


def stage_inputs(pipe, camera) -> dict:
    """The per-frame device inputs the frame graph's stages read, computed
    on the host for one camera pose (culling included)."""
    p = pipe.packed
    planes = camera.frustum_planes()
    view = camera.view_matrix()
    normal_mats = np.ascontiguousarray(
        np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1))
    )
    return {
        "buffers": pipe.buffers,
        "model_mats": jnp.asarray(p.model_mats),
        "normal_mats": jnp.asarray(normal_mats),
        "visible": jnp.asarray(p.instance_visibility(planes)),
        "light_valid": jnp.asarray(p.visible_lights(planes)),
        "view": jnp.asarray(view),
        "inv_view": jnp.asarray(camera.world_matrix()),
        "view_proj": jnp.asarray(camera.projection_matrix() @ view),
        "camera_pos": jnp.asarray(camera.position),
    }


def profile_pipeline(pipe, camera, iters: int = 5):
    """Per-stage timings (ms) for one frame configuration.

    Returns an ordered {stage: ms} dict. Stage outputs are computed once
    (device-resident) and reused as the next stage's inputs, so each timing
    isolates that stage's cost like a GPU pass marker would.
    """
    from ..ops import bloom as bloom_ops
    from ..ops import postprocess
    from ..pipeline import stages

    cfg = pipe.config
    w, h = cfg.width, cfg.height
    rw, rh = pipe.render_w, pipe.render_h  # pad-to-tile raster canvas
    ins = stage_inputs(pipe, camera)
    buffers = ins["buffers"]
    dt = jnp.asarray(1.0 / 60.0, jnp.float32)
    prev_avg = jnp.asarray(0.18, jnp.float32)

    timings: dict[str, float] = {}

    def run(name, fn, *args):
        jfn = jax.jit(fn)
        timings[name] = time_fn(jfn, args, iters)
        return jfn(*args)

    setup, vattrs = run(
        "geometry",
        lambda b, m, n, v, vp: stages.geometry(b, m, n, v, vp, w, h),
        buffers, ins["model_mats"], ins["normal_mats"], ins["visible"],
        ins["view_proj"],
    )
    bins = run("binning", lambda s: stages.binning(
        s, rw, rh, pipe.tile_h, pipe.tile_w, pipe.bin_cap), setup)
    tri_id, depth = run("raster", lambda s, b: stages.rasterize(
        s, b, rw, rh, pipe.tile_h, pipe.tile_w, pipe.use_pallas,
        pallas_interpret=pipe.pallas_interpret), setup, bins)
    gb = run("gbuffer_shade", lambda t, d, s, b, va: stages.gbuffer_shade(
        t, d, s, b, va, rw, rh, texture_filter=pipe.texture_filter),
        tri_id, depth, setup, buffers, vattrs)
    active = run("light_cull", lambda b, lv, v: stages.active_lights(
        b, lv, v, pipe.max_active_lights),
        buffers, ins["light_valid"], ins["view"])
    rt = run("deferred_shade", lambda g, b, a, iv, cp: stages.deferred_shade(
        g, b, a, iv, cp, cfg, rw, rh, full_height=h, full_width=w,
        light_tile=pipe.light_tile, light_cap=pipe.light_cap,
        pallas_interpret=pipe.pallas_interpret),
        gb, buffers, active, ins["inv_view"], ins["camera_pos"])
    rt = rt[:h, :w]
    if cfg.enable_bloom:
        rt = run("bloom", bloom_ops.bloom, rt)

    def post(rt_, prev, dt_):
        avg = postprocess.average_luminance_direct(rt_, float(w * h), prev, dt_)
        out = postprocess.tone_map(rt_, avg)
        return (out * 255.0 + 0.5).astype(jnp.uint8), avg

    run("exposure_tonemap", post, rt, prev_avg, dt)

    # whole-frame reconciliation: the fused frame the pipeline actually runs
    timings["full_frame"] = time_fn(
        lambda: pipe.render(camera, collect_stats=False), (), max(iters, 2))
    return timings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sponza_class",
                    choices=["sponza_class", "lights1k", "reference"])
    ap.add_argument("--asset-root", default="/root/reference/DeferredRendering")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--route", default=None, choices=["triton", "xla"],
                    help="kernel route (default: the platform's)")
    ap.add_argument("--tile", type=int, nargs=2, default=None,
                    metavar=("H", "W"), help="screen tile (default: 32 32)")
    ap.add_argument("--json", default=None, help="also write timings to FILE")
    args = ap.parse_args()

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kw = {"route": args.route}
    if args.tile:
        kw.update(tile_h=args.tile[0], tile_w=args.tile[1])
    if args.scene == "reference":
        from ..app.app import App, AppConfig

        app = App(AppConfig(asset_root=args.asset_root, width=args.width,
                            height=args.height, **kw))
        pipe, camera = app.pipeline, app.camera
    else:
        from . import stress_scene

        pipe, camera = stress_scene.bench_pipeline(
            args.scene, args.width, args.height, **kw)

    t = profile_pipeline(pipe, camera, iters=args.iters)
    total = sum(v for k, v in t.items() if k != "full_frame")
    dev = jax.devices()[0]
    print(f"\nPer-stage timings, {args.scene} @ {args.width}x{args.height} "
          f"(tile {pipe.tile_h}x{pipe.tile_w}, bin_cap {pipe.bin_cap}, "
          f"{pipe.kernels}) on {dev.platform} {dev.device_kind}:\n")
    print(f"| {'stage':<18} | {'ms':>8} |")
    print("|--------------------|----------|")
    for k, v in t.items():
        if k == "full_frame":
            print("|--------------------|----------|")
        print(f"| {k:<18} | {v:8.3f} |")
    print(f"| {'(sum of stages)':<18} | {total:8.3f} |")
    print()
    print(json.dumps({"timings_ms": t, "device_kind": dev.device_kind,
                      "platform": dev.platform, "kernels": pipe.kernels}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"timings_ms": t, "config": vars(args)}, f, indent=1)


if __name__ == "__main__":
    main()
