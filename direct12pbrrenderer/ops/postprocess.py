"""HDR post: luminance histogram, temporally-smoothed auto-exposure, ACES.

Mirrors the three HDR shaders:
* `hdr_luminance_histogram.hlsl`: 256-bin log2-luminance histogram over
  [-10, 2]; bin 0 collects near-black pixels. The groupshared+InterlockedAdd
  pattern becomes a single scatter-add.
* `hdr_average_histogram.hlsl`: average *bin index* excluding bin 0, mapped
  back to luminance, then EMA-smoothed: lerp(prev, cur, 1 - exp(-dt * 1.6)).
  The EMA state is threaded through the frame function as an explicit carry.
* `hdr_tone_mapping.hlsl`: exposure Lmax = 9.6 * Lavg, ACES fit, gamma 1/2.2,
  quantized to the RGBA8 target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import (
    EXPOSURE_SMOOTH_TIME,
    INV_LOG_LUMINANCE_RANGE,
    LOG_LUMINANCE_RANGE,
    MIN_LOG_LUMINANCE,
    NUM_HISTOGRAM_BINS,
)
from . import common


def luminance_histogram(hdr_rgb) -> jnp.ndarray:
    """(H, W, 3) -> (256,) uint32 counts."""
    bins = luminance_bins(hdr_rgb)
    return (
        jnp.zeros(NUM_HISTOGRAM_BINS, jnp.int32).at[bins.ravel()].add(1)
    )


def luminance_bins(hdr_rgb) -> jnp.ndarray:
    """(H, W, 3) -> (H, W) int32 histogram bin indices (the per-pixel part
    of hdr_luminance_histogram.hlsl, before the InterlockedAdd)."""
    lum = common.luminance(hdr_rgb)
    log_l = jnp.clip(
        (jnp.log2(jnp.maximum(lum, 1e-30)) - MIN_LOG_LUMINANCE) * INV_LOG_LUMINANCE_RANGE,
        0.0,
        1.0,
    )
    bins = jnp.floor(log_l * (NUM_HISTOGRAM_BINS - 2) + 1.0).astype(jnp.int32)
    return jnp.where(lum < common.EPSILON, 0, bins)


def average_luminance_direct(hdr_rgb, pixel_count, prev_luminance, delta_time):
    """average_luminance without materializing the histogram: the average
    only needs sum(bin indices) and the black-pixel count, both plain
    reductions — the 256-bin scatter-add stays out of the frame program. Same value as average_luminance(luminance_histogram(x))
    up to f32 summation order."""
    bins = luminance_bins(hdr_rgb)
    weighted = bins.astype(jnp.float32).sum()
    black = (bins == 0).sum().astype(jnp.float32)
    avg_bin = weighted / jnp.maximum(pixel_count - black, 1.0)
    log_l = (avg_bin - 1.0) / (NUM_HISTOGRAM_BINS - 2)
    lum = jnp.exp2(log_l * LOG_LUMINANCE_RANGE + MIN_LOG_LUMINANCE)
    t = jnp.clip(1.0 - jnp.exp(-delta_time * EXPOSURE_SMOOTH_TIME), 0.0, 1.0)
    return prev_luminance + (lum - prev_luminance) * t


def average_luminance(histogram, pixel_count, prev_luminance, delta_time):
    """EMA-smoothed average luminance (hdr_average_histogram.hlsl:36-71)."""
    idx = jnp.arange(NUM_HISTOGRAM_BINS, dtype=jnp.float32)
    weighted = (histogram.astype(jnp.float32) * idx).sum()
    black = histogram[0].astype(jnp.float32)
    avg_bin = weighted / jnp.maximum(pixel_count - black, 1.0)
    log_l = (avg_bin - 1.0) / (NUM_HISTOGRAM_BINS - 2)
    lum = jnp.exp2(log_l * LOG_LUMINANCE_RANGE + MIN_LOG_LUMINANCE)
    t = jnp.clip(1.0 - jnp.exp(-delta_time * EXPOSURE_SMOOTH_TIME), 0.0, 1.0)
    return prev_luminance + (lum - prev_luminance) * t


def aces_tone_map(x):
    """ACES fit (hdr_tone_mapping.hlsl:29-39)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tone_map(hdr_rgb, avg_luminance):
    """-> (H, W, 3) display-ready, RGBA8-quantized (hdr_tone_mapping.hlsl:41-52)."""
    l_max = 9.6 * avg_luminance
    exposed = hdr_rgb / (l_max + 0.001)
    mapped = aces_tone_map(exposed)
    out = common.encode_gamma(mapped)
    return jnp.round(jnp.clip(out, 0.0, 1.0) * 255.0) * (1.0 / 255.0)
