"""Tile-based triangle rasterizer.

Replaces the D3D12 raster stage used by the G-buffer pass (`gbuffer.hlsl`
vertex/pixel shaders + fixed-function raster) with a tile-based SPMD design:

1. **Vertex stage** (`vertex_transform`): per-instance model transforms and
   the view-projection applied as batched matmuls over the packed vertex pool.
2. **Triangle setup** (`setup_triangles`): CLIPLESS homogeneous setup
   (Olano-Greer style). Edge functions are rows of adj([X;Y;W])/det over
   viewport-scaled clip coordinates, so triangles crossing the near plane
   rasterize correctly with NO geometric clipping and no extra triangles:
   the per-pixel 0 <= z <= 1 and W > 0 tests reproduce the D3D clipper's
   visible region exactly (gbuffer.hlsl:75-83 emits clip positions; the
   fixed-function clipper does the rest). Back-face culling via det > 0
   (== clockwise front faces in y-down screen space for w > 0).
3. **Binning** (`bin_triangles`): triangles scattered into fixed-capacity
   per-tile lists, draw order preserved (stable cumsum positions).
4. **Raster** (`rasterize`): `lax.scan` over bin-list chunks; each step
   evaluates the edge functions of a chunk of every tile's candidates against
   the tile's pixels in fp32 and folds depth (depth func LESS, the lowest
   triangle id wins ties, matching command order). `raster_pallas` is the
   GPU tile kernel with the same arithmetic.

Differences vs. the reference hardware rasterizer (documented quirks):
* fp32 edge functions instead of D3D's 16.8 fixed point snapping -> sub-pixel
  silhouette differences.
* inclusive edge test instead of the top-left fill rule -> shared edges are
  double-covered (harmless under LESS depth with opaque draws).
* near-plane-crossing triangles use homogeneous (clipless) rasterization
  instead of geometric clipping: identical visible region, but their screen
  AABBs are conservative (clamped projections of the w=eps crossing points),
  so a camera inside geometry bins those triangles to more tiles.
* per-tile triangle lists have a static capacity; overflow drops the excess
  (reported via the bin stats so callers can size capacity).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TriangleSetup(NamedTuple):
    """Homogeneous (clipless) triangle setup.

    `edges` rows are B_i(p) = cross(v_j, v_k)/det evaluated as a*x + b*y + c
    over PIXEL coordinates, where v_i = (X_i, Y_i, w_i) are viewport-scaled
    clip vectors. At a covered pixel all B_i >= 0 (front faces have det > 0);
    perspective-correct barycentrics are B_i / sum(B); the hardware depth is
    z_ndc = sum(B*z_clip) / sum(B*w_clip); the near/far clip planes become
    per-pixel 0 <= z_ndc <= 1 (+ sum(B*w) > 0) tests — exact D3D clip
    semantics with no clipping stage."""

    xy: jnp.ndarray        # (T, 3, 2) screen positions (garbage where w<=eps)
    z: jnp.ndarray         # (T, 3) CLIP z (= ndc_z * w)
    w_clip: jnp.ndarray    # (T, 3) clip w
    edges: jnp.ndarray     # (T, 3, 3) homogeneous edge rows (see above)
    aabb: jnp.ndarray      # (T, 4) xmin, ymin, xmax, ymax (pixels, conservative)
    valid: jnp.ndarray     # (T,) bool


def vertex_transform(positions, instance_ids, model_mats, view_proj):
    """positions (V, 3), instance_ids (V,), model_mats (I, 4, 4) -> clip (V, 4).

    Column-vector convention throughout (clip = P*V*M*pos), matching
    gbuffer.hlsl:75-83 with DXC row-major packing."""
    m = model_mats[instance_ids]  # (V, 4, 4)
    ph = jnp.concatenate([positions, jnp.ones_like(positions[..., :1])], axis=-1)
    # geometry transforms must stay full fp32 (a bf16 or TF32 matmul would
    # quantize screen positions to ~1/256 or ~1/1024 of their magnitude)
    world = jnp.einsum("vij,vj->vi", m, ph, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("ij,vj->vi", view_proj, world, precision=jax.lax.Precision.HIGHEST)


def transform_directions(dirs, instance_ids, normal_mats):
    """Normals/tangents via transpose(inverse(M)) (gbuffer.hlsl:77-79).
    normal_mats: (I, 3, 3) = inverse(M)[:3,:3].T precomputed on host."""
    m = normal_mats[instance_ids]
    return jnp.einsum("vij,vj->vi", m, dirs, precision=jax.lax.Precision.HIGHEST)


def setup_triangles(
    verts_clip, tris, tri_valid, width: int, height: int, w_eps: float = 1e-4
) -> TriangleSetup:
    v = verts_clip[tris]  # (T, 3, 4)
    w = v[..., 3]
    z = v[..., 2]  # CLIP z — no division, finite for any w
    in_front = w > w_eps

    # screen positions of in-front vertices (for AABBs, anchoring, debug);
    # garbage (but finite) where w <= eps
    inv_w = 1.0 / jnp.where(in_front, w, 1.0)
    x = (v[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (1.0 - (v[..., 1] * inv_w * 0.5 + 0.5)) * height
    xy = jnp.stack([x, y], -1)  # (T, 3, 2)

    # viewport-scaled homogeneous coords ANCHORED at the first in-front
    # vertex's projection: X'_i/w_i = px_i - anchor_x. Local-scale coords keep
    # the cross products cancellation-free for small/far triangles (the raw
    # screen-scale form loses ~3 digits and visibly jitters silhouettes).
    ax = jnp.where(in_front[:, 0], x[:, 0],
                   jnp.where(in_front[:, 1], x[:, 1], x[:, 2]))
    ay = jnp.where(in_front[:, 0], y[:, 0],
                   jnp.where(in_front[:, 1], y[:, 1], y[:, 2]))
    hx, hy = 0.5 * width, 0.5 * height
    vx = v[..., 0] * hx + (hx - ax[:, None]) * w
    vy = -(v[..., 1] * hy) + (hy - ay[:, None]) * w

    # B_i = cross(v_j, v_k) (cyclic), det = dot(v_0, B_0)
    def cross(j, k):
        return jnp.stack(
            [
                vy[:, j] * w[:, k] - vy[:, k] * w[:, j],
                w[:, j] * vx[:, k] - w[:, k] * vx[:, j],
                vx[:, j] * vy[:, k] - vx[:, k] * vy[:, j],
            ],
            -1,
        )

    b0 = cross(1, 2)
    b1 = cross(2, 0)
    b2 = cross(0, 1)
    det = b0[:, 0] * vx[:, 0] + b0[:, 1] * vy[:, 0] + b0[:, 2] * w[:, 0]
    # normalize by det: front faces (det > 0) get all-nonnegative B inside;
    # also tames magnitudes (raw cross entries scale like local^2 * w^2)
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    edges = jnp.stack([b0, b1, b2], 1) * inv_det[:, None, None]
    # translate evaluation from anchored coords to pixel coords:
    # e(px, py) with c' = c - a*anchor_x - b*anchor_y
    edges = edges.at[:, :, 2].add(
        -(edges[:, :, 0] * ax[:, None] + edges[:, :, 1] * ay[:, None])
    )

    # conservative screen AABB: in-front vertex projections plus the
    # projections of the w = eps crossing points of sign-changing edges
    big = jnp.float32(3e38)
    xmin_v = jnp.where(in_front, x, big).min(-1)
    xmax_v = jnp.where(in_front, x, -big).max(-1)
    ymin_v = jnp.where(in_front, y, big).min(-1)
    ymax_v = jnp.where(in_front, y, -big).max(-1)

    xmin, xmax, ymin, ymax = xmin_v, xmax_v, ymin_v, ymax_v
    for a, b in ((0, 1), (1, 2), (2, 0)):
        crossing = in_front[:, a] != in_front[:, b]
        t = (w_eps - w[:, a]) / jnp.where(
            w[:, b] == w[:, a], 1.0, w[:, b] - w[:, a]
        )
        cx_h = v[:, a, 0] + t * (v[:, b, 0] - v[:, a, 0])
        cy_h = v[:, a, 1] + t * (v[:, b, 1] - v[:, a, 1])
        cx = (cx_h / w_eps * 0.5 + 0.5) * width
        cy = (1.0 - (cy_h / w_eps * 0.5 + 0.5)) * height
        xmin = jnp.where(crossing, jnp.minimum(xmin, cx), xmin)
        xmax = jnp.where(crossing, jnp.maximum(xmax, cx), xmax)
        ymin = jnp.where(crossing, jnp.minimum(ymin, cy), ymin)
        ymax = jnp.where(crossing, jnp.maximum(ymax, cy), ymax)

    aabb = jnp.stack(
        [
            jnp.clip(jnp.floor(xmin), 0, width),
            jnp.clip(jnp.floor(ymin), 0, height),
            jnp.clip(jnp.ceil(xmax), 0, width),
            jnp.clip(jnp.ceil(ymax), 0, height),
        ],
        -1,
    )

    any_crossing = (in_front != in_front[:, :1]).any(-1)
    # far-plane whole-triangle reject only when safely decidable (all in
    # front): z_ndc_i <= 1  <=>  z_i <= w_i
    far_ok = (z <= w).any(-1) | any_crossing
    valid = (
        tri_valid
        & in_front.any(-1)          # fully behind the camera -> drop
        & (det > 0)                 # back-face + degenerate cull
        & (aabb[:, 2] > aabb[:, 0]) & (aabb[:, 3] > aabb[:, 1])
        & far_ok
    )
    return TriangleSetup(xy, z, w, edges, aabb, valid)


class Bins(NamedTuple):
    ids: jnp.ndarray      # (num_tiles, cap) int32 triangle ids (draw order), -1 pad
    counts: jnp.ndarray   # (num_tiles,) int32 (pre-clamp counts; > cap = overflow)


def bin_triangles(
    setup: TriangleSetup,
    tiles_y: int,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    cap: int,
    y_offset=0,
) -> Bins:
    """Compact triangle ids into per-tile lists (stable draw order).

    The compaction is a per-tile `top_k` over `score = overlap ? T - id : 0`:
    descending score = ascending triangle id, so each tile's list preserves
    submission order (the reference's command order), with no atomics (the
    InterlockedAdd compaction analog).
    """
    num_tiles = tiles_y * tiles_x
    t = setup.aabb.shape[0]

    tx0 = (jnp.arange(tiles_x) * tile_w).astype(jnp.float32)
    # y_offset: global row of this framebuffer slice (sharded rendering)
    ty0 = (jnp.arange(tiles_y) * tile_h).astype(jnp.float32) + y_offset
    # tile rects vs triangle aabbs: (tiles_y, tiles_x, T)
    xmin, ymin, xmax, ymax = (setup.aabb[:, i] for i in range(4))
    ov_x = (xmin[None, :] < (tx0 + tile_w)[:, None]) & (xmax[None, :] > tx0[:, None])
    ov_y = (ymin[None, :] < (ty0 + tile_h)[:, None]) & (ymax[None, :] > ty0[:, None])
    overlap = (
        ov_y[:, None, :] & ov_x[None, :, :] & setup.valid[None, None, :]
    ).reshape(num_tiles, t)

    counts = overlap.sum(axis=1).astype(jnp.int32)
    score = jnp.where(overlap, t - jnp.arange(t, dtype=jnp.int32)[None, :], 0)
    if t < cap:  # tiny pools: top_k needs k <= axis size
        score = jnp.pad(score, ((0, 0), (0, cap - t)))
    top, _ = jax.lax.top_k(score, cap)
    ids = jnp.where(top > 0, t - top, -1).astype(jnp.int32)
    return Bins(ids, counts)


def bin_triangles_hier(
    setup: TriangleSetup,
    tiles_y: int,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    cap: int,
    y_offset=0,
    super_h: int = 8,
    super_w: int = 4,
    cap1: int = 16384,
) -> Bins:
    """Two-level binning for large triangle pools (Sponza-class scenes).

    The flat path's per-tile `top_k` sorts every tile row over the FULL pool
    (tiles x T log T); here a coarse pass first compacts each (super_h x
    super_w)-tile supertile's overlap set to <= cap1 candidates, and the
    per-tile top_k then runs over cap1 instead of T — ~T/cap1 x less sort
    volume at 260k+ triangles. Same output contract as bin_triangles (ids in
    submission order, pre-clamp counts; supertile overflow surfaces as
    count > cap so callers' bin_overflow stat reports it).

    The fine pass is additionally RUNTIME-adaptive: coarse candidates come
    out of top_k ordered ascending-id with the invalid tail last, so when
    every supertile's overlap count fits in cap1//4 the fine top_k runs over
    just the first cap1//4 candidate columns — a `lax.cond` picks the
    variant per frame (the reference scene at 1080p peaks at ~3.4k
    candidates per supertile vs the 16k safety cap; sparse frames pay 4x
    less fine-pass sort, dense frames keep the full path)."""
    num_tiles = tiles_y * tiles_x
    t = setup.aabb.shape[0]
    cap1 = min(cap1, t)
    sy = -(-tiles_y // super_h)
    sx = -(-tiles_x // super_w)

    xmin, ymin, xmax, ymax = (setup.aabb[:, i] for i in range(4))
    sx0 = (jnp.arange(sx) * (super_w * tile_w)).astype(jnp.float32)
    sy0 = (jnp.arange(sy) * (super_h * tile_h)).astype(jnp.float32) + y_offset
    ov_x1 = (xmin[None, :] < (sx0 + super_w * tile_w)[:, None]) & (
        xmax[None, :] > sx0[:, None]
    )
    ov_y1 = (ymin[None, :] < (sy0 + super_h * tile_h)[:, None]) & (
        ymax[None, :] > sy0[:, None]
    )
    ov1 = (ov_y1[:, None, :] & ov_x1[None, :, :] & setup.valid[None, None, :]
           ).reshape(sy * sx, t)
    cnt1 = ov1.sum(axis=1).astype(jnp.int32)
    score1 = jnp.where(ov1, t - jnp.arange(t, dtype=jnp.int32)[None, :], 0)
    top1, _ = jax.lax.top_k(score1, cap1)
    cand = jnp.where(top1 > 0, t - top1, 0).astype(jnp.int32)  # (S, cap1) asc ids
    cand_valid = top1 > 0

    # per-supertile candidate AABBs (contiguous-ish gather, S*cap1 rows)
    aabb_c = setup.aabb[cand]                                   # (S, cap1, 4)

    # fine pass: every tile tests only its supertile's candidates
    tx0 = (jnp.arange(tiles_x) * tile_w).astype(jnp.float32)
    ty0 = (jnp.arange(tiles_y) * tile_h).astype(jnp.float32) + y_offset
    s_of_tile = (
        (jnp.arange(tiles_y) // super_h)[:, None] * sx
        + (jnp.arange(tiles_x) // super_w)[None, :]
    ).reshape(num_tiles)
    tile_x0 = jnp.tile(tx0, tiles_y)[:, None]                   # (tiles, 1)
    tile_y0 = jnp.repeat(ty0, tiles_x)[:, None]
    over1 = (cnt1 > cap1)[s_of_tile]

    def fine(n_cand: int) -> Bins:
        aabb_t = aabb_c[:, :n_cand][s_of_tile]          # (tiles, n_cand, 4)
        valid_t = cand_valid[:, :n_cand][s_of_tile]
        ov2 = (
            (aabb_t[..., 0] < tile_x0 + tile_w)
            & (aabb_t[..., 2] > tile_x0)
            & (aabb_t[..., 1] < tile_y0 + tile_h)
            & (aabb_t[..., 3] > tile_y0)
            & valid_t
        )                                               # (tiles, n_cand)
        counts = ov2.sum(axis=1).astype(jnp.int32)
        # supertile overflow: candidates were truncated, so a tile under
        # this supertile may be missing triangles — surface as overflow
        # (count > cap)
        counts = jnp.where(over1, jnp.maximum(counts, cap + 1), counts)

        # score by candidate id directly (the flat path's trick): descending
        # score = ascending triangle id = submission order, and the ids fall
        # straight out of top_k — no per-element gather afterwards
        cand_t = cand[:, :n_cand][s_of_tile]            # (tiles, n_cand)
        id_score = jnp.where(ov2, t - cand_t, 0)
        if n_cand < cap:
            id_score = jnp.pad(id_score, ((0, 0), (0, cap - n_cand)))
        top2, _ = jax.lax.top_k(id_score, cap)
        ids = jnp.where(top2 > 0, t - top2, -1).astype(jnp.int32)
        return Bins(ids, counts)

    cap_small = max(cap, cap1 // 4)
    if cap_small >= cap1:
        return fine(cap1)
    # coarse candidates are ascending-id with the invalid tail last, so when
    # every supertile's count fits cap_small the first cap_small columns
    # hold the complete set — branch per frame on the realized density
    return jax.lax.cond(
        jnp.max(cnt1) <= cap_small,
        lambda: fine(cap_small),
        lambda: fine(cap1),
    )


def pack_raster_rows(setup: TriangleSetup) -> jnp.ndarray:
    """(T, 16) per-triangle raster rows, the one layout both rasterizers read:
    [ea0,eb0,ec0, ea1,eb1,ec1, ea2,eb2,ec2, z0,z1,z2, w0,w1,w2, id] with the
    homogeneous edge rows of `setup_triangles`, CLIP-space vertex z and w,
    and the triangle id as f32 (exact below 2^24). Invalid triangles get
    ec0 = -3e38, so no pixel is ever inside them."""
    t = setup.edges.shape[0]
    e = setup.edges.reshape(t, 9)
    ec0 = jnp.where(setup.valid, e[:, 2], -3e38)
    tri_id = jnp.arange(t, dtype=jnp.float32)[:, None]
    return jnp.concatenate(
        [e[:, 0:2], ec0[:, None], e[:, 3:9], setup.z, setup.w_clip, tri_id],
        axis=1,
    )


def candidate_depth(px, py, col):
    """Depth of candidate triangles at pixel centres, inf where not covered.

    `col(j)` returns column j of the raster rows (pack_raster_rows), shaped
    to broadcast against px/py. The edge scores are s_i = px*a + py*b + c in
    fp32 (bf16 would misplace edges by pixels at 1080p magnitudes); depth is
    z_ndc = sum(s z_clip) / sum(s w_clip). The sum(s w) > 0 test rejects the
    anti-wedge of near-plane-crossing triangles and 0 <= z <= 1 are the D3D
    near/far clip planes, applied per pixel. Shared verbatim by the XLA
    raster and the tile kernel so both evaluate the same arithmetic."""
    s0 = px * col(0) + py * col(1) + col(2)
    s1 = px * col(3) + py * col(4) + col(5)
    s2 = px * col(6) + py * col(7) + col(8)
    inside = jnp.minimum(jnp.minimum(s0, s1), s2) >= 0.0
    den = s0 * col(12) + s1 * col(13) + s2 * col(14)
    zc = (s0 * col(9) + s1 * col(10) + s2 * col(11)) / jnp.where(
        den == 0.0, 1.0, den
    )
    ok = inside & (den > 0.0) & (zc >= 0.0) & (zc <= 1.0)
    return jnp.where(ok, zc, jnp.inf)


_NO_ID = 2**31 - 1


def depth_fold(zbuf, idbuf, zc, ids):
    """Fold one chunk of candidates (.., C) into the (..) depth/id buffers.

    Depth func LESS; equal depths resolve to the LOWEST triangle id, whatever
    order the candidates arrive in (the reference's command order, since ids
    follow submission order). Both rasterizers use this rule."""
    best_z = jnp.min(zc, axis=-1)
    best_id = jnp.min(
        jnp.where(zc == best_z[..., None], ids, _NO_ID), axis=-1
    )
    upd = (best_z < zbuf) | ((best_z == zbuf) & (best_id < idbuf))
    return jnp.where(upd, best_z, zbuf), jnp.where(upd, best_id, idbuf)


def untile(tiles, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int):
    """(tiles, tile_h * tile_w) row-major tile blocks -> (H, W) image."""
    return (
        tiles.reshape(tiles_y, tiles_x, tile_h, tile_w)
        .transpose(0, 2, 1, 3)
        .reshape(tiles_y * tile_h, tiles_x * tile_w)
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w", "chunk"),
)
def rasterize(
    setup: TriangleSetup,
    bins: Bins,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    chunk: int = 64,
    y_offset=0,
):
    """-> (tri_id (H, W) int32 [-1 = background], z (H, W) f32 [1.0 bg]).

    The plain reference raster: scans over bin-list chunks with ALL tiles
    batched per step, evaluating `candidate_depth` on (tiles, pixels, chunk)
    grids and folding with `depth_fold`. It pays the full bin capacity for
    every tile; `raster_pallas` is the tile kernel that walks only each
    tile's own list.
    """
    tiles_y = height // tile_h
    tiles_x = width // tile_w
    num_tiles = tiles_y * tiles_x
    p = tile_h * tile_w
    cap = bins.ids.shape[1]
    n_chunks = max(1, -(-cap // chunk))
    ids_all = bins.ids
    if n_chunks * chunk != cap:
        ids_all = jnp.pad(ids_all, ((0, 0), (0, n_chunks * chunk - cap)),
                          constant_values=-1)

    # per-tile pixel centers in global coordinates: (tiles, p, 1)
    lin = jnp.arange(p, dtype=jnp.int32)
    tile = jnp.arange(num_tiles, dtype=jnp.int32)
    px = ((tile[:, None] % tiles_x) * tile_w + lin[None, :] % tile_w
          ).astype(jnp.float32) + 0.5
    py = ((tile[:, None] // tiles_x) * tile_h + lin[None, :] // tile_w
          ).astype(jnp.float32) + 0.5 + y_offset
    px, py = px[..., None], py[..., None]
    rows = pack_raster_rows(setup)

    def chunk_step(carry, c_idx):
        zbuf, idbuf = carry  # (tiles, p)
        ids = jax.lax.dynamic_slice(
            ids_all, (0, c_idx * chunk), (num_tiles, chunk)
        )  # (tiles, chunk)
        r = rows[jnp.maximum(ids, 0)]  # (tiles, chunk, 16)
        zc = candidate_depth(px, py, lambda j: r[:, None, :, j])
        zc = jnp.where((ids >= 0)[:, None, :], zc, jnp.inf)
        return depth_fold(zbuf, idbuf, zc, ids[:, None, :]), None

    init = (
        jnp.full((num_tiles, p), jnp.inf, jnp.float32),
        jnp.full((num_tiles, p), -1, jnp.int32),
    )
    (z_tiles, id_tiles), _ = jax.lax.scan(
        chunk_step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    z_img = untile(z_tiles, tiles_y, tiles_x, tile_h, tile_w)
    id_img = untile(id_tiles, tiles_y, tiles_x, tile_h, tile_w)
    return id_img, jnp.where(jnp.isinf(z_img), 1.0, z_img)


def _bary_from_scores(scores, wv):
    """Homogeneous barycentrics from edge scores B_i and vertex clip w.

    Returns (lam_affine, lam_persp, one_over_w): perspective barycentrics are
    B / sum(B); screen-affine ones are (B*w) / sum(B*w)."""
    sum_b = scores.sum(-1)
    lam_persp = scores / jnp.where(sum_b == 0, 1.0, sum_b)[..., None]
    bw = scores * wv
    sum_bw = bw.sum(-1)
    lam = bw / jnp.where(sum_bw == 0, 1.0, sum_bw)[..., None]
    one_over_w = sum_b / jnp.where(sum_bw == 0, 1.0, sum_bw)
    return lam, lam_persp, one_over_w


def barycentrics_at(setup: TriangleSetup, tri_id, px, py):
    """Perspective-correct barycentrics for given pixels.

    tri_id (...,) int32 (>= 0), px/py (...,) pixel centers ->
    (lam_affine (..., 3), lam_persp (..., 3), one_over_w (...,)).
    lam_affine interpolates screen-affine quantities; lam_persp interpolates
    vertex attributes (uv, normals) perspective-correctly.
    """
    e = setup.edges[tri_id]  # (..., 3, 3)
    ph = jnp.stack([px, py, jnp.ones_like(px)], -1)  # (..., 3)
    scores = (e * ph[..., None, :]).sum(-1)  # (..., 3)
    return _bary_from_scores(scores, setup.w_clip[tri_id])
