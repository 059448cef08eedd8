"""Tile raster kernel: Pallas through Triton, one program per screen tile.

The plain XLA raster (`raster.rasterize`) evaluates every tile against its
full bin capacity and writes (tiles, pixels, chunk) depth grids to device
memory on every scan step. This kernel keeps the whole depth fold in
registers and walks only its own tile's list:

  grid = (num_tiles,)
  program t: count = min(bin count, cap); for each chunk of CHUNK ids,
    gather the chunk's raster rows (raster.pack_raster_rows) by id,
    evaluate raster.candidate_depth on the (pixels, CHUNK) grid in fp32
    FMAs, and fold with raster.depth_fold (LESS, lowest id wins ties).

The tile's pixel count must be a power of two (Triton block shapes), and
the bin capacity a multiple of CHUNK. The arithmetic is the XLA raster's,
shared through `raster.candidate_depth` / `raster.depth_fold`, so the two
agree up to the compiler's FMA contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import raster

CHUNK = 8
NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(counts_ref, ids_ref, rows_ref, yoff_ref, z_ref, id_ref, *,
            tile_h, tile_w, tiles_x, chunk):
    t = pl.program_id(0)
    p = tile_h * tile_w
    lin = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    px = ((t % tiles_x) * tile_w + lin % tile_w).astype(jnp.float32) + 0.5
    py = ((t // tiles_x) * tile_h + lin // tile_w).astype(jnp.float32)
    py = py + 0.5 + yoff_ref[0]
    px, py = px[:, None], py[:, None]

    count = counts_ref[t]
    lane = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)

    def body(c, carry):
        base = c * chunk
        ids = ids_ref[t, pl.ds(base, chunk)]
        live = (base + lane < count) & (ids >= 0)
        idc = jnp.where(live, ids, 0)
        zc = raster.candidate_depth(px, py, lambda j: rows_ref[idc, j][None, :])
        zc = jnp.where(live[None, :], zc, jnp.inf)
        return raster.depth_fold(*carry, zc, idc[None, :])

    init = (jnp.full((p,), jnp.inf, jnp.float32),
            jnp.full((p,), -1, jnp.int32))
    zbuf, idbuf = jax.lax.fori_loop(0, (count + chunk - 1) // chunk, body,
                                    init)
    z_ref[t, :] = zbuf
    id_ref[t, :] = idbuf


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w", "interpret"),
)
def rasterize_pallas(
    setup: raster.TriangleSetup,
    bins: raster.Bins,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    y_offset=0,
    interpret: bool = False,
):
    """Drop-in replacement for raster.rasterize (same outputs)."""
    tiles_y = height // tile_h
    tiles_x = width // tile_w
    num_tiles = tiles_y * tiles_x
    p = tile_h * tile_w
    cap = bins.ids.shape[1]
    if p & (p - 1):
        raise ValueError(f"tile {tile_h}x{tile_w}: pixel count must be a "
                         "power of two")
    if cap % CHUNK:
        raise ValueError(f"bin cap {cap} must be a multiple of {CHUNK}")

    kernel = functools.partial(_kernel, tile_h=tile_h, tile_w=tile_w,
                               tiles_x=tiles_x, chunk=CHUNK)
    z_tiles, id_tiles = pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=[
            jax.ShapeDtypeStruct((num_tiles, p), jnp.float32),
            jax.ShapeDtypeStruct((num_tiles, p), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="raster_tiles",
    )(
        jnp.minimum(bins.counts, cap),
        bins.ids,
        raster.pack_raster_rows(setup),
        jnp.asarray(y_offset, jnp.float32).reshape(1),
    )
    z_img = raster.untile(z_tiles, tiles_y, tiles_x, tile_h, tile_w)
    id_img = raster.untile(id_tiles, tiles_y, tiles_x, tile_h, tile_w)
    return id_img, jnp.where(jnp.isinf(z_img), 1.0, z_img)
