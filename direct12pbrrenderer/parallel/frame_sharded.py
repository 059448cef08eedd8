"""Multi-card frame rendering: the framebuffer sharded across a device mesh.

The reference is a single-GPU program (SURVEY.md §2.8); this rebuild's
scaling axis is the screen: a 1D `jax.sharding.Mesh` over axis ``"sp"``
(screen/space parallelism — the renderer's analog of data parallelism) splits
the framebuffer into row bands. A 1D mesh fits cards that reach each other
all to all (NVLink). The frame is one jit in two regimes:

* **shard_map band render** — each card runs the (cheap, replicated)
  frustum cull + vertex transform + triangle setup, bins triangles against
  *its* rows only, and rasterizes + G-buffer-shades + deferred-shades its
  band (the heavy, perfectly parallel work). The band leaves the shard_map
  still sharded (`out_specs=P("sp")`) — no gather, no replication.
* **GSPMD post chain** — bloom, auto-exposure and tone mapping run as
  ordinary global-semantics ops annotated with row shardings
  (`ops/bloom.bloom(row_sharding=...)`): the partitioner keeps every
  full-/half-res blur row-parallel and auto-inserts the 4-row halo
  exchanges and the exposure psum as collectives. Only the tiny deep
  pyramid mips (<1% of pixel work) replicate.

Feature parity with the single-card pipeline is BY CONSTRUCTION:
`build_sharded_frame(mesh, pipe)` reads every knob (kernel route, tiles,
bin capacity, light-tile kernel) off the `DeferredRenderPipeline` it
shards, and the band body calls the same `pipeline.stages` entry points the
single-card graph does — so a kernel added to the pipeline is automatically
the one the sharded frame multiplies.

Scene buffers and lights are replicated (tens of MB — the natural choice at
this scale; texture-atlas sharding over a second axis is the growth path).
Culling runs ON DEVICE (replicated, vectorized AABB-vs-planes) exactly like
the single-card Cull pass, so the host uploads only bounds + matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bloom as bloom_ops
from ..ops import common, postprocess
from ..pipeline import stages


def build_sharded_frame(mesh: Mesh, pipe, collect_stats: bool = False):
    """jit(frame) rendering `pipe`'s scene row-band-sharded over mesh axis
    'sp', with the SAME kernels and knobs as `pipe`'s single-card graph.

    frame(buffers, model_mats, normal_mats, instance_bounds, light_bounds,
          frustum_planes, view, inv_view, view_proj, camera_pos,
          prev_avg_lum, delta_time)
      -> (rgb8 (H, W, 3) row-sharded, avg_luminance)
      [+ (bin_counts (tiles,), light_trunc) with collect_stats]

    Frustum culling happens on device inside the band body (replicated) —
    the host ships bounds and matrices only, matching the single-card Cull
    pass. Bands pad to whole tiles internally (H must split into n_dev
    equal bands; each band's canvas rounds up to the tile grid and crops
    back), so 1080p runs on 4 cards (270-row bands on a 272-row canvas).
    """
    n_dev = mesh.shape["sp"]
    cfg = pipe.config
    w, h = cfg.width, cfg.height
    tile_h, tile_w, bin_cap = pipe.tile_h, pipe.tile_w, pipe.bin_cap
    assert h % n_dev == 0, f"height {h} must split into {n_dev} equal bands"
    band_h = h // n_dev
    band_rh = -(-band_h // tile_h) * tile_h  # pad-to-tile band canvas
    rw = -(-w // tile_w) * tile_w

    def band_render(
        buffers, model_mats, normal_mats, instance_bounds, light_bounds,
        frustum_planes, view, inv_view, view_proj, camera_pos,
    ):
        band = jax.lax.axis_index("sp")
        y0 = (band * band_h).astype(jnp.float32)

        # device-side frustum cull (replicated — the single-card Cull pass);
        # pool-padding rows (zero AABBs at the origin) are masked off by
        # index exactly like the Cull pass's [:n] slice
        n_inst, n_lgt = pipe.packed.instance_count, pipe.packed.light_count
        instance_visible = common.frustum_cull_aabbs(
            frustum_planes, instance_bounds[:, 0], instance_bounds[:, 1]
        ) & (jnp.arange(instance_bounds.shape[0]) < n_inst)
        light_valid = common.frustum_cull_aabbs(
            frustum_planes, light_bounds[:, 0], light_bounds[:, 1]
        ) & (jnp.arange(light_bounds.shape[0]) < n_lgt)

        # replicated vertex/setup work (small vs. per-pixel work); the heavy
        # per-pixel stages below are the SAME functions the single-card
        # pipeline runs (pipeline.stages), with y_offset/band plumbing — the
        # only sharding-specific code here is the mesh glue.
        setup, vattrs = stages.geometry(
            buffers, model_mats, normal_mats, instance_visible, view_proj,
            w, h,
        )
        bins = stages.binning(
            setup, rw, band_rh, tile_h, tile_w, bin_cap, y_offset=y0
        )
        tri_id, depth = stages.rasterize(
            setup, bins, rw, band_rh, tile_h, tile_w, pipe.use_pallas,
            y_offset=y0, pallas_interpret=pipe.pallas_interpret,
        )
        gb = stages.gbuffer_shade(
            tri_id, depth, setup, buffers, vattrs, rw, band_rh,
            texture_filter=pipe.texture_filter, y_offset=y0,
        )
        active = stages.active_lights(
            buffers, light_valid, view, pipe.max_active_lights
        )
        rt_band = stages.deferred_shade(
            gb, buffers, active, inv_view, camera_pos, cfg, rw, band_rh,
            y_offset=y0, full_height=h, full_width=w,
            light_tile=pipe.light_tile, light_cap=pipe.light_cap,
            pallas_interpret=pipe.pallas_interpret,
        )
        rt_band = rt_band[:band_h, :w]  # crop the band's pad-to-tile canvas
        if not collect_stats:
            return rt_band
        trunc = stages.light_tile_overflow(
            active, cfg, rw, band_rh, pipe.light_tile, pipe.light_cap, w, h,
            y_offset=y0,
        )
        return rt_band, bins.counts, trunc[None]

    out_specs = ((P("sp"),) * 3 if collect_stats else P("sp"))
    shard_fn = jax.shard_map(
        band_render,
        mesh=mesh,
        in_specs=(P(),) * 10,
        out_specs=out_specs,
        check_vma=False,
    )

    sp = NamedSharding(mesh, P("sp"))

    def frame(
        buffers, model_mats, normal_mats, instance_bounds, light_bounds,
        frustum_planes, view, inv_view, view_proj, camera_pos,
        prev_avg_lum, delta_time,
    ):
        out = shard_fn(
            buffers, model_mats, normal_mats, instance_bounds, light_bounds,
            frustum_planes, view, inv_view, view_proj, camera_pos,
        )
        rt = out[0] if collect_stats else out
        rt = jax.lax.with_sharding_constraint(rt, sp)

        # post chain: global-semantics ops, row-sharded by GSPMD (bloom
        # crosses band boundaries only through 4-row blur halos and the
        # tiny deep mips; exposure is a global reduction -> psum)
        if cfg.enable_bloom:
            rt = bloom_ops.bloom(rt, row_sharding=sp)
        avg = postprocess.average_luminance_direct(
            rt, float(w * h), prev_avg_lum, delta_time
        )
        img = postprocess.tone_map(rt, avg)
        rgb8 = jax.lax.with_sharding_constraint(
            (img * 255.0 + 0.5).astype(jnp.uint8), sp
        )
        if collect_stats:
            # bin counts concatenate to the full tile grid; tile overflow
            # is the worst band's
            return rgb8, avg, out[1], out[2].max()
        return rgb8, avg

    return jax.jit(frame)


def frame_args(pipe, camera, prev_avg_lum: float = 0.0,
               delta_time: float = 1.0 / 60.0) -> tuple:
    """The sharded frame's arguments for one camera pose (bounds and
    matrices from the pipeline's packed scene; culling runs on device)."""
    p = pipe.packed
    normal_mats = np.ascontiguousarray(
        np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))
    view = camera.view_matrix()
    return (
        pipe.buffers,
        jnp.asarray(p.model_mats),
        jnp.asarray(normal_mats),
        jnp.asarray(p.instance_bounds),
        jnp.asarray(p.light_bounds),
        jnp.asarray(np.asarray(camera.frustum_planes(), np.float32)),
        jnp.asarray(view),
        jnp.asarray(camera.world_matrix()),
        jnp.asarray(camera.projection_matrix() @ view),
        jnp.asarray(camera.position),
        jnp.asarray(prev_avg_lum, jnp.float32),
        jnp.asarray(delta_time, jnp.float32),
    )


def replicate(mesh: Mesh, tree):
    """Place every array of `tree` on all devices of `mesh` (the band
    body's replicated inputs), so no card reads them from another's memory."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("sp",))
