"""Clustered light culling.

Re-expresses `clustered_compute.hlsl` + `clustered_culling.hlsl` as dense
vectorized ops: view-space cluster AABBs in closed form (exponential z
slicing), then a sphere-vs-AABB test over the full (clusters, lights) grid
(`cluster_light_hits`). Shading walks the active lights in index order with
a per-pixel counter capped at 32, which is the reference's per-cluster list
(InterlockedAdd compaction in light order). `tile_light_lists` narrows that
walk to the lights that can touch a screen tile.

Cluster grid: 24 x 16 x 8, z-major-contiguous index (clustered.hlsli:39-43),
<= 32 lights per cluster, <= 1024 scene lights.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    CULLING_RADIUS_COEFFICIENT,
)

NUM_CLUSTERS = CLUSTER_X * CLUSTER_Y * CLUSTER_Z


def cluster_bounds(fov: float, ratio: float, near: float, far: float) -> np.ndarray:
    """(NUM_CLUSTERS, 2, 3) view-space AABBs (clustered_compute.hlsl:21-42).

    Static per camera config — computed host-side once (the reference
    re-dispatches the same computation every frame).
    """
    xs = np.arange(CLUSTER_X)
    ys = np.arange(CLUSTER_Y)
    zs = np.arange(CLUSTER_Z)
    tan_half = np.tan(fov / 2)

    def zplane_intersection(ndc_x, ndc_y, view_z):
        ray = np.stack(
            [
                ndc_x * ratio * tan_half * near,
                ndc_y * tan_half * near,
                np.broadcast_to(near, ndc_x.shape),
            ],
            -1,
        )
        t = view_z / ray[..., 2]
        return ray * t[..., None]

    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")  # (X, Y, Z)
    znear = near * (far / near) ** (gz / CLUSTER_Z)
    zfar = near * (far / near) ** ((gz + 1) / CLUSTER_Z)
    min_ndc_x = 2 * gx / CLUSTER_X - 1
    min_ndc_y = 2 * gy / CLUSTER_Y - 1
    max_ndc_x = 2 * (gx + 1) / CLUSTER_X - 1
    max_ndc_y = 2 * (gy + 1) / CLUSTER_Y - 1

    p = [
        zplane_intersection(min_ndc_x, min_ndc_y, znear),
        zplane_intersection(min_ndc_x, min_ndc_y, zfar),
        zplane_intersection(max_ndc_x, max_ndc_y, znear),
        zplane_intersection(max_ndc_x, max_ndc_y, zfar),
    ]
    mn = np.minimum(np.minimum(p[0], p[1]), np.minimum(p[2], p[3]))
    mx = np.maximum(np.maximum(p[0], p[1]), np.maximum(p[2], p[3]))
    # cluster index = z + x*Z + y*X*Z (clustered.hlsli:39-43)
    bounds = np.zeros((NUM_CLUSTERS, 2, 3), np.float32)
    idx = gz + gx * CLUSTER_Z + gy * CLUSTER_X * CLUSTER_Z
    bounds[idx.ravel(), 0] = mn.reshape(-1, 3)
    bounds[idx.ravel(), 1] = mx.reshape(-1, 3)
    return bounds


def build_active_lights(
    light_pos, light_color, light_intensity, light_attenuation, light_valid,
    view, max_active: int,
):
    """Compact the visible lights into (max_active, 14) rows for the shading
    loop: [pos_w(3), color(3), intensity, kc, kl, kq, pos_view(3), cull_r].
    Index order preserved (cap-truncation semantics follow light order, like
    the reference's sequential culling loop). Padding rows have cull_r = 0.
    """
    l = light_pos.shape[0]
    ph = jnp.concatenate([light_pos, jnp.ones_like(light_pos[:, :1])], -1)
    pos_view = jnp.dot(ph, view.T, precision=jax.lax.Precision.HIGHEST)[:, :3]
    cull_r = (
        light_attenuation[:, 0] * CULLING_RADIUS_COEFFICIENT
        * jnp.sqrt(jnp.maximum(light_intensity, 0.0))
    )
    rows = jnp.concatenate(
        [
            light_pos, light_color, light_intensity[:, None],
            light_attenuation[:, 1:4], pos_view,
            jnp.where(light_valid, cull_r, 0.0)[:, None],
        ],
        axis=1,
    )  # (L, 14)
    score = jnp.where(light_valid, l - jnp.arange(l, dtype=jnp.int32), 0)
    if l < max_active:
        score = jnp.pad(score, (0, max_active - l))
    top, _ = jax.lax.top_k(score, max_active)
    ids = jnp.where(top > 0, l - top, 0)
    out = rows[jnp.minimum(ids, l - 1)]
    return jnp.where((top > 0)[:, None], out, 0.0)


def pixel_cluster_index(z_view, width: int, height: int, full_width: int,
                        full_height: int, near: float, far: float,
                        y_offset=0):
    """(H, W) int32 cluster index of every pixel (clustered.hlsli:45-59):
    x/y slices from the pixel centre's uv over the logical viewport, z slice
    exponential in view depth. Index = z + x*Z + y*X*Z."""
    u = (jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5) / full_width
    v = (jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5 + y_offset
         ) / full_height
    sx = jnp.clip(jnp.floor(u * CLUSTER_X), 0, CLUSTER_X - 1)
    sy = jnp.clip(jnp.floor((1.0 - v) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    zc = jnp.clip(z_view, near, far)
    sz = jnp.clip(
        jnp.floor(CLUSTER_Z * jnp.log(zc / near) / math.log(far / near)),
        0, CLUSTER_Z - 1,
    )
    idx = sz + sx * CLUSTER_Z + sy * (CLUSTER_X * CLUSTER_Z)
    return idx.astype(jnp.int32)


def cluster_light_hits(rows, fov: float, ratio: float, near: float,
                       far: float):
    """(NUM_CLUSTERS, N) bool: does active light n's culling sphere touch
    cluster c's view-space AABB (clustered_culling.hlsl:19-39)?

    The AABBs are the closed form of clustered_compute.hlsl:21-42 in fp32 on
    device. Both point-light paths read this one table, so they agree on
    cluster membership bit for bit. Padding rows (cull_r = 0) hit nothing."""
    gy, gx, gz = jnp.meshgrid(
        jnp.arange(CLUSTER_Y, dtype=jnp.float32),
        jnp.arange(CLUSTER_X, dtype=jnp.float32),
        jnp.arange(CLUSTER_Z, dtype=jnp.float32), indexing="ij",
    )  # (Y, X, Z): ravel order == cluster index z + x*Z + y*X*Z
    tan_half = math.tan(fov / 2.0)
    znear_c = near * (far / near) ** (gz / CLUSTER_Z)
    zfar_c = near * (far / near) ** ((gz + 1) / CLUSTER_Z)

    def corner(ndc_x, ndc_y, vz):
        # zplane_intersection: ray to near-plane ndc point, scaled to z = vz
        return ndc_x * ratio * tan_half * vz, ndc_y * tan_half * vz

    min_x, min_y = 2.0 * gx / CLUSTER_X - 1.0, 2.0 * gy / CLUSTER_Y - 1.0
    max_x, max_y = 2.0 * (gx + 1) / CLUSTER_X - 1.0, 2.0 * (gy + 1) / CLUSTER_Y - 1.0
    xa, ya = corner(min_x, min_y, znear_c)
    xb, yb = corner(min_x, min_y, zfar_c)
    xc, yc = corner(max_x, max_y, znear_c)
    xd, yd = corner(max_x, max_y, zfar_c)
    cmin = jnp.stack([jnp.minimum(jnp.minimum(xa, xb), jnp.minimum(xc, xd)),
                      jnp.minimum(jnp.minimum(ya, yb), jnp.minimum(yc, yd)),
                      znear_c], -1).reshape(-1, 1, 3)
    cmax = jnp.stack([jnp.maximum(jnp.maximum(xa, xb), jnp.maximum(xc, xd)),
                      jnp.maximum(jnp.maximum(ya, yb), jnp.maximum(yc, yd)),
                      zfar_c], -1).reshape(-1, 1, 3)
    pos_view = rows[None, :, 10:13]
    d = pos_view - jnp.clip(pos_view, cmin, cmax)
    cull_r = rows[None, :, 13]
    return (d * d).sum(-1) < cull_r * cull_r


def tile_light_lists(
    rows,            # (N, 14) active-light rows (build_active_lights)
    tiles_y: int,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    full_width: int,
    full_height: int,
    fov: float,
    ratio: float,
    near: float,
    far: float,
    cap: int,
    y_offset=0,
):
    """-> (ids (tiles, cap) int32 [-1 pad, ascending], counts (tiles,)).

    Culls each light's culling sphere (view space, radius rows[:, 13])
    against the tile's cluster-column union AABB: ndc bounds from the tile's
    cluster (x, y) index range, z spanning [near, far] (all slabs). A light
    outside that AABB can hit no cluster of the tile, so walking only the
    listed lights leaves every pixel's per-cluster counter unchanged. Index
    order is preserved by an id-score top_k, so the 32-per-cluster cap keeps
    the reference's light order. counts > cap = overflow (surfaced in
    FrameStats.light_tile_overflow)."""
    n = rows.shape[0]
    pos_view = rows[:, 10:13]
    cull_r = rows[:, 13]

    # tile -> cluster index ranges (pixel centers)
    tx0 = (jnp.arange(tiles_x) * tile_w).astype(jnp.float32)
    ty0 = (jnp.arange(tiles_y) * tile_h).astype(jnp.float32) + y_offset
    u_lo = (tx0 + 0.5) / full_width
    u_hi = (tx0 + tile_w - 0.5) / full_width
    v_lo = (ty0 + 0.5) / full_height
    v_hi = (ty0 + tile_h - 0.5) / full_height
    sx_lo = jnp.clip(jnp.floor(u_lo * CLUSTER_X), 0, CLUSTER_X - 1)
    sx_hi = jnp.clip(jnp.floor(u_hi * CLUSTER_X), 0, CLUSTER_X - 1)
    # sy = floor((1 - v) * Y): v_hi gives the LOW cluster row
    sy_lo = jnp.clip(jnp.floor((1.0 - v_hi) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    sy_hi = jnp.clip(jnp.floor((1.0 - v_lo) * CLUSTER_Y), 0, CLUSTER_Y - 1)

    tan_half = math.tan(fov / 2.0)
    kx, ky = ratio * tan_half, tan_half
    nx_lo = 2.0 * sx_lo / CLUSTER_X - 1.0            # (tiles_x,)
    nx_hi = 2.0 * (sx_hi + 1) / CLUSTER_X - 1.0
    ny_lo = 2.0 * sy_lo / CLUSTER_Y - 1.0            # (tiles_y,)
    ny_hi = 2.0 * (sy_hi + 1) / CLUSTER_Y - 1.0

    def span(lo, hi, k):
        a = jnp.minimum(lo * k * near, lo * k * far)
        b = jnp.maximum(hi * k * near, hi * k * far)
        return a, b

    xmin, xmax = span(nx_lo, nx_hi, kx)              # (tiles_x,)
    ymin, ymax = span(ny_lo, ny_hi, ky)              # (tiles_y,)

    xmin_t = jnp.tile(xmin, tiles_y)[:, None]        # (tiles, 1)
    xmax_t = jnp.tile(xmax, tiles_y)[:, None]
    ymin_t = jnp.repeat(ymin, tiles_x)[:, None]
    ymax_t = jnp.repeat(ymax, tiles_x)[:, None]

    cx = jnp.clip(pos_view[None, :, 0], xmin_t, xmax_t)
    cy = jnp.clip(pos_view[None, :, 1], ymin_t, ymax_t)
    cz = jnp.clip(pos_view[None, :, 2], near, far)
    d2 = (
        (pos_view[None, :, 0] - cx) ** 2
        + (pos_view[None, :, 1] - cy) ** 2
        + (pos_view[None, :, 2] - cz) ** 2
    )
    # conservative: the union AABB is evaluated with slightly different fp
    # association than the per-cluster AABBs, so inflate the test — listing
    # an extra light is harmless (the kernel re-tests it), missing one is
    # not. r=0 pads still miss.
    hit = d2 < (cull_r * cull_r)[None, :] * 1.0002 + 1e-5

    counts = hit.sum(axis=1).astype(jnp.int32)
    score = jnp.where(hit, n - jnp.arange(n, dtype=jnp.int32)[None, :], 0)
    if n < cap:
        score = jnp.pad(score, ((0, 0), (0, cap - n)))
    top, _ = jax.lax.top_k(score, cap)
    ids = jnp.where(top > 0, n - top, -1).astype(jnp.int32)
    return ids, counts
