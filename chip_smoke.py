"""On-card smoke run of the deferred renderer.

Drives `DeferredRenderPipeline.render` and `render_sequence` at 1920x1080 on
one GPU through the normal entry points, in the two repository-built scenes
(tools/stress_scene.bench_pipeline: the 262,144-triangle Sponza-class
terrain and the 1024-light terrain, both lit by the in-memory procedural
sky), checks every hand-written kernel against its plain XLA reference at
those shapes, and renders one small frame on the GPU and on the CPU in the
same process. Any failed check ends the run with a non-zero exit.

Usage:
  python chip_smoke.py               # phases 1-4 on one GPU
  python chip_smoke.py --four-cards  # phase 5 only: the sharded frame on
                                     # four GPUs against one

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU the script exits non-zero before any phase and prints none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

FRAMES = 8
TIMING_RUNS = 10


def rmse_u8(a, b) -> float:
    """RMSE of two uint8 frames on the normalized [0, 1] scale."""
    a = np.asarray(a).astype(np.float64) / 255.0
    b = np.asarray(b).astype(np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def frame_phase(name: str, pipe, cam, label: str, frames: int = FRAMES,
                lights: bool = False) -> dict:
    """Render `frames` frames through render() and `frames` through
    render_sequence(), then check the output and the frame stats."""
    import jax

    from direct12pbrrenderer.tools.stress_scene import yaw_path

    cfg = pipe.config
    t0 = time.perf_counter()
    compiled = pipe.compile(cam)
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    cams = yaw_path(cam, frames)

    img = jax.block_until_ready(pipe.render(cams[0], collect_stats=False))
    ms = []
    for c in cams:
        t0 = time.perf_counter()
        img = jax.block_until_ready(pipe.render(c, collect_stats=False))
        ms.append((time.perf_counter() - t0) * 1e3)
    pipe.render(cams[-1], collect_stats=True)
    stats = pipe.last_stats

    t0 = time.perf_counter()
    seq = jax.block_until_ready(pipe.render_sequence(cams))
    seq_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = jax.block_until_ready(pipe.render_sequence(cams))
    seq_ms = (time.perf_counter() - t0) * 1e3 / frames

    img = np.asarray(img)
    seq = np.asarray(seq)
    lit = float((img.max(-1) > 16).mean())
    avg = float(np.asarray(pipe.avg_luminance))
    check(img.shape == (cfg.height, cfg.width, 3) and img.dtype == np.uint8,
          f"{name}: frame {img.shape} {img.dtype}")
    check(seq.shape == (frames, cfg.height, cfg.width, 3)
          and seq.dtype == np.uint8, f"{name}: sequence {seq.shape}")
    check(lit > 0.05, f"{name}: lit fraction {lit:.4f} <= 0.05")
    check(bool(np.isfinite(avg)), f"{name}: average luminance {avg}")
    check(stats.bin_overflow == 0, f"{name}: bin_overflow {stats.bin_overflow}")
    if lights:
        check(stats.light_tile_overflow == 0,
              f"{name}: light_tile_overflow {stats.light_tile_overflow}")
    peak = jax.devices()[0].memory_stats() or {}
    out = {
        "phase": name, "kernels": pipe.kernels,
        "compile_s": round(compile_s, 3),
        "sequence_compile_s": round(seq_compile_s, 3),
        "render_ms": [round(m, 3) for m in ms],
        "render_ms_median": round(float(np.median(ms)), 3),
        "sequence_ms_per_frame": round(seq_ms, 3),
        "lit_fraction": round(lit, 4), "avg_luminance": avg,
        "visible_lights": stats.visible_lights,
        "bin_overflow": stats.bin_overflow,
        "light_tile_overflow": stats.light_tile_overflow,
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        "peak_bytes_in_use": peak.get("peak_bytes_in_use"),
        "card": label,
    }
    print(json.dumps(out), flush=True)
    return out


def _gbuffer_inputs(pipe, cam):
    """Geometry, bins, G-buffer and active lights for one pose, through the
    pipeline's own stages and route."""
    import jax

    from direct12pbrrenderer.pipeline import stages
    from direct12pbrrenderer.tools.profile import stage_inputs

    cfg, rw, rh = pipe.config, pipe.render_w, pipe.render_h
    ins = stage_inputs(pipe, cam)

    @jax.jit
    def front(ins):
        setup, vattrs = stages.geometry(
            ins["buffers"], ins["model_mats"], ins["normal_mats"],
            ins["visible"], ins["view_proj"], cfg.width, cfg.height)
        bins = stages.binning(setup, rw, rh, pipe.tile_h, pipe.tile_w,
                              pipe.bin_cap)
        active = stages.active_lights(ins["buffers"], ins["light_valid"],
                                      ins["view"], pipe.max_active_lights)
        return setup, vattrs, bins, active

    setup, vattrs, bins, active = front(ins)
    return ins, setup, vattrs, bins, active


def raster_check(pipe, cam, label: str, runs: int = TIMING_RUNS) -> dict:
    """Tile kernel vs raster.rasterize, both followed by interp_from_rows:
    triangle ids may differ on <= 1e-4 of pixels (fp32 edge rounding on
    exact edges), depth by <= 1e-6 where the ids agree."""
    import jax

    from direct12pbrrenderer.ops import gbuffer, raster, raster_pallas
    from direct12pbrrenderer.pipeline import stages
    from direct12pbrrenderer.tools.profile import time_fn

    rw, rh, th, tw = pipe.render_w, pipe.render_h, pipe.tile_h, pipe.tile_w
    ins, setup, vattrs, bins, _ = _gbuffer_inputs(pipe, cam)
    rows = stages.pack_rows64(setup, ins["buffers"], vattrs)

    def with_interp(ids_z):
        ids, z = ids_z
        return ids, z, gbuffer.interp_from_rows(ids, rows, rw, rh)[0]

    ref_fn = jax.jit(lambda s, b: with_interp(
        raster.rasterize(s, b, rw, rh, th, tw)))
    ker_fn = jax.jit(lambda s, b: with_interp(raster_pallas.rasterize_pallas(
        s, b, rw, rh, th, tw, interpret=pipe.pallas_interpret)))
    ids_r, z_r, in_r = jax.block_until_ready(ref_fn(setup, bins))
    ids_k, z_k, in_k = jax.block_until_ready(ker_fn(setup, bins))
    ids_r, ids_k = np.asarray(ids_r), np.asarray(ids_k)
    agree = ids_r == ids_k
    mismatch = float(1.0 - agree.mean())
    dz = float(np.abs(np.asarray(z_r) - np.asarray(z_k))[agree].max())
    dinterp = float(np.abs(np.asarray(in_r) - np.asarray(in_k))[agree].max())
    check(mismatch <= 1e-4, f"raster: id mismatch {mismatch:.2e} > 1e-4")
    check(dz <= 1e-6, f"raster: depth diff {dz:.2e} > 1e-6")
    out = {
        "phase": "raster_kernel_vs_xla",
        "tile": f"{th}x{tw}", "bin_cap": pipe.bin_cap,
        "max_bin_count": int(np.asarray(bins.counts).max()),
        "covered_fraction": round(float((ids_r >= 0).mean()), 4),
        "id_mismatch_fraction": mismatch, "depth_max_abs_diff": dz,
        "interp_max_abs_diff": dinterp,
        "kernel_ms": round(time_fn(ker_fn, (setup, bins), runs), 3),
        "xla_ms": round(time_fn(ref_fn, (setup, bins), runs), 3),
        "card": label,
    }
    print(json.dumps(out), flush=True)
    return out


def lights_check(pipe, cam, label: str, runs: int = TIMING_RUNS) -> dict:
    """Tile light kernel vs the fori path on the same G-buffer: HDR radiance
    max relative error <= 1e-4 where radiance > 1e-3, and RMSE <= 1e-3 on
    the presented uint8 frame."""
    import jax
    import jax.numpy as jnp

    from direct12pbrrenderer.ops import bloom, postprocess
    from direct12pbrrenderer.pipeline import stages
    from direct12pbrrenderer.tools.profile import time_fn

    cfg, rw, rh = pipe.config, pipe.render_w, pipe.render_h
    w, h = cfg.width, cfg.height
    ins, setup, vattrs, bins, active = _gbuffer_inputs(pipe, cam)
    gb = jax.jit(lambda s, b, va, bu: stages.gbuffer_shade(
        *stages.rasterize(s, b, rw, rh, pipe.tile_h, pipe.tile_w,
                          pipe.use_pallas,
                          pallas_interpret=pipe.pallas_interpret),
        s, bu, va, rw, rh, texture_filter=pipe.texture_filter,
    ))(setup, bins, vattrs, ins["buffers"])

    def shade(light_tile):
        return jax.jit(lambda g, bu, a, iv, cp: stages.deferred_shade(
            g, bu, a, iv, cp, cfg, rw, rh, full_height=h, full_width=w,
            light_tile=light_tile, light_cap=pipe.light_cap,
            pallas_interpret=pipe.pallas_interpret)[:h, :w])

    args = (gb, ins["buffers"], active, ins["inv_view"], ins["camera_pos"])
    ref_fn, ker_fn = shade(None), shade((pipe.tile_h, pipe.tile_w))
    hdr_r = np.asarray(ref_fn(*args))
    hdr_k = np.asarray(ker_fn(*args))
    check(bool(np.isfinite(hdr_k).all()), "lights: non-finite radiance")
    sel = np.abs(hdr_r) > 1e-3
    rel = float((np.abs(hdr_k - hdr_r)[sel] / np.abs(hdr_r[sel])).max())

    @jax.jit
    def present(rt):
        if cfg.enable_bloom:
            rt = bloom.bloom(rt)
        avg = postprocess.average_luminance_direct(
            rt, float(w * h), jnp.float32(0.0), jnp.float32(1.0 / 60.0))
        return (postprocess.tone_map(rt, avg) * 255.0 + 0.5).astype(jnp.uint8)

    rmse = rmse_u8(present(hdr_r), present(hdr_k))
    check(rel <= 1e-4, f"lights: max relative error {rel:.2e} > 1e-4")
    check(rmse <= 1e-3, f"lights: frame rmse {rmse:.2e} > 1e-3")
    out = {
        "phase": "lights_kernel_vs_fori",
        "active_lights": int((np.asarray(active)[:, 13] > 0).sum()),
        "light_cap": pipe.light_cap,
        "max_relative_error": rel, "frame_rmse_u8": rmse,
        "kernel_ms": round(time_fn(ker_fn, args, runs), 3),
        "fori_ms": round(time_fn(ref_fn, args, runs), 3),
        "card": label,
    }
    print(json.dumps(out), flush=True)
    return out


def _small_scenes(sky_size: int):
    """The phase-4 scenes: the sphere of __graft_entry__._tiny_pipeline and
    a 128 x 64-cell terrain at 480x270, both under the procedural sky."""
    import __graft_entry__ as graft
    from direct12pbrrenderer.tools import stress_scene

    pipe, cam, _ = graft._tiny_pipeline(sky_size=sky_size)
    yield "sphere", pipe, cam
    pipe, cam = stress_scene.bench_pipeline(
        "sponza_class", 480, 270, cells=(128, 64), sky_size=sky_size,
        bin_cap=1024, brdf_lut_size=64)
    yield "terrain", pipe, cam


def cpu_gpu_check(label: str, sky_size: int = 64) -> list:
    """The same frame rendered on the default device and on the CPU, in one
    process: RMSE <= 1e-3 on the uint8 frame (catches TF32 and
    reduction-order drift)."""
    import jax

    cpu = jax.devices("cpu")[0]
    out = []
    dev = [(name, np.asarray(pipe.render(cam)), pipe.kernels)
           for name, pipe, cam in _small_scenes(sky_size)]
    with jax.default_device(cpu):
        host = [(np.asarray(pipe.render(cam)), pipe.kernels)
                for _, pipe, cam in _small_scenes(sky_size)]
    for (name, a, k_dev), (b, k_cpu) in zip(dev, host):
        rmse = rmse_u8(a, b)
        check(rmse <= 1e-3, f"{name}: device vs cpu rmse {rmse:.2e} > 1e-3")
        row = {"phase": "device_vs_cpu", "scene": name, "shape": a.shape,
               "rmse_u8": rmse, "device_kernels": k_dev,
               "cpu_kernels": k_cpu, "card": label}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def four_cards_check(label: str, n: int = 4, width: int = 1920,
                     height: int = 1080, cells=None, sky_size: int = 512,
                     runs: int = TIMING_RUNS, **pipeline_kw) -> dict:
    """The Sponza-class frame row-band sharded over an n-card mesh against
    the same frame on one card: RMSE <= 1e-3, and the replicated scene
    buffers live on every card of the mesh."""
    import jax

    from direct12pbrrenderer.parallel import frame_sharded
    from direct12pbrrenderer.tools import stress_scene
    from direct12pbrrenderer.tools.profile import time_fn

    check(len(jax.devices()) >= n, f"need {n} devices, have "
          f"{len(jax.devices())}")
    pipe, cam = stress_scene.bench_pipeline(
        "sponza_class", width, height, cells=cells, sky_size=sky_size,
        **pipeline_kw)
    ref = np.asarray(pipe.render(cam))
    single_ms = time_fn(lambda: pipe.render(cam, collect_stats=False), (),
                        runs)

    mesh = frame_sharded.make_mesh(n)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    args = list(frame_sharded.frame_args(pipe, cam))
    args[0] = frame_sharded.replicate(mesh, args[0])
    want = set(mesh.devices.flat)
    for leaf in jax.tree_util.tree_leaves(args[0]):
        check(set(leaf.sharding.device_set) == want,
              f"replicated buffer on {leaf.sharding.device_set}")
    rgb8, avg = jax.block_until_ready(frame(*args))
    out_img = np.asarray(rgb8)
    check(len(rgb8.sharding.device_set) == n, "output not sharded")
    rmse = rmse_u8(out_img, ref)
    check(out_img.shape == ref.shape, f"sharded frame {out_img.shape}")
    check(rmse <= 1e-3, f"sharded vs single rmse {rmse:.2e} > 1e-3")
    out = {
        "phase": "four_cards", "cards": n, "kernels": pipe.kernels,
        "rmse_u8": rmse, "avg_luminance": float(avg),
        "sharded_ms": round(time_fn(lambda: frame(*args)[0], (), runs), 3),
        "single_ms": round(single_ms, 3), "card": label,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded-frame phase on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (first device is {devices[0].platform!r});"
              " refusing to run on another platform", file=sys.stderr)
        return 2

    from direct12pbrrenderer.tools import stress_scene
    from direct12pbrrenderer.utils.compile_cache import enable_compile_cache
    from direct12pbrrenderer.utils.device_info import card_line

    cache = enable_compile_cache()
    label = card_line()
    print(f"card: {label}")
    print(f"jax {jax.__version__}; devices {len(devices)} x "
          f"{devices[0].device_kind}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}", flush=True)

    if args.four_cards:
        four_cards_check(label, n=4)
    else:
        pipe_s, cam_s = stress_scene.bench_pipeline("sponza_class")
        print(f"kernels: {pipe_s.kernels}", flush=True)
        frame_phase("sponza_class", pipe_s, cam_s, label)
        pipe_l, cam_l = stress_scene.bench_pipeline("lights1k")
        frame_phase("lights1k", pipe_l, cam_l, label, lights=True)
        raster_check(pipe_s, cam_s, label)
        lights_check(pipe_l, cam_l, label)
        del pipe_s, pipe_l
        cpu_gpu_check(label)

    print(f"card: {label}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
