"""Tile-clustered point-light kernel: Pallas through Triton.

The reference sizes its clustered pipeline for <=1024 scene lights with <=32
per cluster (DeferredPipeline.h:326-330, clustered_culling.hlsl,
deferred_shading.hlsl:159-186). The plain path (`shading.point_lights_fori`)
sweeps the whole frame once per active light: at the 1024-light operating
point that is ~900 full-frame passes, each re-reading the G-buffer.

This kernel reads the G-buffer once. One program per screen tile:

  grid = (num_tiles,)
  program t: load the tile's G-buffer planes and per-pixel cluster ids into
    registers; walk the tile's light list (clustered.tile_light_lists, light
    index order) one light at a time; per light, read its row and the
    cluster hit bits of the tile's pixels (clustered.cluster_light_hits),
    apply the per-pixel counter (<32 per cluster, in light order), and
    accumulate Cook-Torrance radiance in registers.

The counter and the hit table are the fori path's, so cluster membership,
light order and the cap agree exactly; the BRDF arithmetic agrees to fp32
rounding. Tile pixel counts must be powers of two (Triton block shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import MAX_LIGHTS_PER_CLUSTER
from . import clustered, common

NUM_WARPS = 4


def _kernel(counts_ref, ids_ref, lights_ref, hits_ref, cid_ref, gb_ref,
            out_ref, *, tile_h, tile_w, tiles_x):
    t = pl.program_id(0)
    rows = pl.ds((t // tiles_x) * tile_h, tile_h)
    cols = pl.ds((t % tiles_x) * tile_w, tile_w)

    def plane(c):
        return gb_ref[c, rows, cols]

    alb = [plane(0), plane(1), plane(2)]
    nx, ny, nz = plane(3), plane(4), plane(5)
    rough, metal = plane(6), plane(7)
    posx, posy, posz = plane(8), plane(9), plane(10)
    vdx, vdy, vdz = plane(11), plane(12), plane(13)
    cid = cid_ref[rows, cols]

    # light-independent BRDF terms (common.brdf, same formulas)
    n_dot_v = jnp.maximum(nx * vdx + ny * vdy + nz * vdz, 0.0)
    f0 = [0.04 * (1.0 - metal) + a * metal for a in alb]
    a = rough * rough
    a2 = a * a
    k = (rough + 1.0) ** 2 / 8.0
    g_v = n_dot_v / jnp.maximum(n_dot_v * (1.0 - k) + k, common.EPSILON)

    def body(i, carry):
        acc_r, acc_g, acc_b, counter = carry
        lid = ids_ref[t, i]

        def lp(j):
            return lights_ref[lid, j]

        hit = (hits_ref[cid, lid] != 0) & (counter < MAX_LIGHTS_PER_CLUSTER)

        ldx, ldy, ldz = lp(0) - posx, lp(1) - posy, lp(2) - posz
        dist = jnp.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
        inv = jnp.maximum(dist, 1e-20)
        ldx, ldy, ldz = ldx / inv, ldy / inv, ldz / inv
        n_dot_l = jnp.maximum(nx * ldx + ny * ldy + nz * ldz, 0.0)
        att = 1.0 / jnp.maximum(
            lp(7) + lp(8) * dist + lp(9) * dist * dist, common.EPSILON)

        hx, hy, hz = ldx + vdx, ldy + vdy, ldz + vdz
        hn = jnp.maximum(jnp.sqrt(hx * hx + hy * hy + hz * hz),
                         common.EPSILON)
        hx, hy, hz = hx / hn, hy / hn, hz / hn
        n_dot_h = jnp.maximum(nx * hx + ny * hy + nz * hz, 0.0)
        tt = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
        d = a2 / jnp.maximum(common.PI * tt * tt, common.EPSILON)
        g_l = n_dot_l / jnp.maximum(n_dot_l * (1.0 - k) + k, common.EPSILON)
        spec = d * (g_v * g_l) / jnp.maximum(4.0 * n_dot_l * n_dot_v, 1e-4)
        pow5 = jnp.power(jnp.maximum(1.0 - n_dot_l, common.EPSILON), 5.0)
        lum = lp(6) * att * n_dot_l

        def channel(c):
            f = f0[c] + (1.0 - f0[c]) * pow5
            kd = (1.0 - f) * (1.0 - metal)
            brdf = kd * alb[c] * common.INV_PI + f * spec
            return jnp.where(hit, brdf * (lp(3 + c) * lum), 0.0)

        return (acc_r + channel(0), acc_g + channel(1), acc_b + channel(2),
                counter + hit.astype(jnp.int32))

    z = jnp.zeros((tile_h, tile_w), jnp.float32)
    acc_r, acc_g, acc_b, _ = jax.lax.fori_loop(
        0, counts_ref[t], body, (z, z, z, jnp.zeros((tile_h, tile_w),
                                                    jnp.int32)))
    out_ref[0, rows, cols] = acc_r
    out_ref[1, rows, cols] = acc_g
    out_ref[2, rows, cols] = acc_b


@functools.partial(
    jax.jit,
    static_argnames=("fov", "ratio", "near", "far", "full_width",
                     "full_height", "tile_h", "tile_w", "cap", "interpret"),
)
def point_lights_tiled(
    rows,          # (N, 14) active-light rows
    hits,          # (NUM_CLUSTERS, N) bool, clustered.cluster_light_hits
    cid,           # (H, W) int32 pixel cluster ids
    albedo,        # (H, W, 3) linear
    normal,        # (H, W, 3) decoded world normal
    roughness,     # (H, W)
    metallic,      # (H, W)
    position,      # (H, W, 3) world position
    view_dir,      # (H, W, 3) unit pixel->camera
    fov: float, ratio: float, near: float, far: float,
    full_width: int, full_height: int,
    tile_h: int = 32,
    tile_w: int = 32,
    y_offset=0,
    cap: int = 256,
    interpret: bool = False,
):
    """Clustered point-light radiance (H, W, 3), equal to
    shading.point_lights_fori up to fp32 rounding; cost O(lights per tile).
    Tiles whose culled list exceeds `cap` drop the excess (surfaced through
    FrameStats.light_tile_overflow)."""
    height, width = cid.shape
    tiles_y, tiles_x = height // tile_h, width // tile_w
    if (tile_h * tile_w) & (tile_h * tile_w - 1):
        raise ValueError(f"tile {tile_h}x{tile_w}: pixel count must be a "
                         "power of two")
    ids, counts = clustered.tile_light_lists(
        rows, tiles_y, tiles_x, tile_h, tile_w, full_width, full_height,
        fov, ratio, near, far, cap, y_offset=y_offset,
    )
    gb = jnp.concatenate([
        jnp.moveaxis(albedo, -1, 0), jnp.moveaxis(normal, -1, 0),
        roughness[None], metallic[None], jnp.moveaxis(position, -1, 0),
        jnp.moveaxis(view_dir, -1, 0),
    ])  # (14, H, W)
    kernel = functools.partial(_kernel, tile_h=tile_h, tile_w=tile_w,
                               tiles_x=tiles_x)
    out = pl.pallas_call(
        kernel,
        grid=(tiles_y * tiles_x,),
        out_shape=jax.ShapeDtypeStruct((3, height, width), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="tile_point_lights",
    )(
        jnp.minimum(counts, cap), ids, rows, hits.astype(jnp.int32), cid, gb,
    )
    return jnp.moveaxis(out, 0, -1)
