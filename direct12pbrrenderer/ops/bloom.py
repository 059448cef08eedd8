"""Bloom: threshold prefilter + separable-Gaussian mip pyramid + merge.

Reproduces the reference's exact pass sequence (BloomPass::Execute,
DeferredPipeline.cpp:400-570, shaders bloom_prefilter / blur_horizontal /
blur_vertical / bloom_upsample_add / bloom_merge):

  A[1] = Prefilter(S)                       (half res, threshold+knee+firefly)
  for i in 0..2: B[i+2] = DownH(A[i+1]); A[i+2] = DownV(B[i+2])
  for i in 2..0: B[i+1] = UpH(A[i+1]) + UpH(A[i+2]^); A[i+1] = UpV(B[i+1])
  B[0] = UpH(A[1]^); A[0] = UpV(B[0]); out = S + A[0]

Formulation: every tap in the reference shaders is a LinearClamp bilinear
fetch at a whole *output-texel* offset (blur.hlsli: offsets are i*TexelSize of
the output grid). Bilinear interpolation is linear, so sampling at
`uv + i*texel` equals element `[x+i]` of the bilinear-resized image — any
cross-resolution blur therefore factors into (a) one bilinear resize,
expressed as a small dense interpolation-matrix matmul (handles the odd mip
sizes of e.g. 1080 -> 135 -> 67 exactly), and (b) a same-res 9-tap
separable blur expressed as clamped shifted adds. Zero gathers anywhere;
XLA fuses the shifted adds. Weights: blur.hlsli:17.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BLOOM_KNEE, BLOOM_STEPS, BLOOM_THRESHOLD, GAUSS_WEIGHTS
from . import common

_W = jnp.asarray(GAUSS_WEIGHTS, jnp.float32)
_R = 4
_HP = jax.lax.Precision.HIGHEST


def _shift(img, dy, dx):
    """Clamp-to-edge shifted view (the LinearClamp sampling analog)."""
    h, w = img.shape[0], img.shape[1]
    pad = max(abs(dy), abs(dx))
    p = jnp.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    return p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]


def blur_h(img):
    """9-tap horizontal Gaussian, same resolution, clamp addressing."""
    return sum(_W[i + _R] * _shift(img, 0, i) for i in range(-_R, _R + 1))


def blur_v(img):
    return sum(_W[i + _R] * _shift(img, i, 0) for i in range(-_R, _R + 1))


@functools.lru_cache(maxsize=None)
def _resize_matrix(out_n: int, in_n: int, half_phase: bool) -> np.ndarray:
    """(out_n, in_n) bilinear interpolation matrix with clamp addressing.

    half_phase=True: positions (o + 0.5) * in/out - 0.5  (texel centers,
        the blur/upsample uv convention: uv = (x+0.5)*texel).
    half_phase=False: positions o * in/out - 0.5  (the prefilter convention:
        uv = xy * texel, bloom_prefilter.hlsl:56)."""
    o = np.arange(out_n, dtype=np.float64)
    pos = ((o + 0.5) if half_phase else o) * (in_n / out_n) - 0.5
    i0 = np.floor(pos)
    frac = pos - i0
    m = np.zeros((out_n, in_n), np.float32)
    lo = np.clip(i0.astype(np.int64), 0, in_n - 1)
    hi = np.clip(i0.astype(np.int64) + 1, 0, in_n - 1)
    m[o.astype(np.int64), lo] += (1.0 - frac).astype(np.float32)
    m[o.astype(np.int64), hi] += frac.astype(np.float32)
    return m


def resize_bilinear(img, out_h: int, out_w: int, half_phase: bool = True):
    """LinearClamp bilinear resize via interpolation-matrix matmuls."""
    in_h, in_w = img.shape[0], img.shape[1]
    out = img
    if out_h != in_h:
        mh = jnp.asarray(_resize_matrix(out_h, in_h, half_phase))
        out = jnp.einsum("oi,iwc->owc", mh, out, precision=_HP)
    if out_w != in_w:
        mw = jnp.asarray(_resize_matrix(out_w, in_w, half_phase))
        out = jnp.einsum("oi,hic->hoc", mw, out, precision=_HP)
    return out


def bloom_threshold(color, threshold=BLOOM_THRESHOLD, knee=BLOOM_KNEE):
    """Soft-knee bright-pass (bloom_prefilter.hlsl:16-26)."""
    brightness = color.max(axis=-1, keepdims=True)
    soft = jnp.clip(brightness - threshold + threshold * knee, 0.0, 2 * threshold * knee)
    soft = soft * soft / (4 * threshold * knee + 1e-5)
    contribution = jnp.maximum(soft, brightness - threshold) / jnp.maximum(
        brightness, 1e-5
    )
    return color * contribution


def prefilter(img, out_h: int, out_w: int):
    """bloom_prefilter at half resolution: 5-tap cross, luma-weighted to
    suppress fireflies (bloom_prefilter.hlsl:30-53). Taps sit at +-1 output
    texel diagonals around uv = xy * texel (note: no half-texel offset)."""
    base = resize_bilinear(img, out_h, out_w, half_phase=False)
    offsets = [(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]
    total = jnp.zeros_like(base)
    weight = jnp.zeros(base.shape[:2] + (1,), base.dtype)
    for dy, dx in offsets:
        c = bloom_threshold(_shift(base, dy, dx))
        wgt = 1.0 / (common.luminance(c)[..., None] + 1.0)
        total = total + c * wgt
        weight = weight + wgt
    return total / jnp.maximum(weight, 1e-20)


@functools.lru_cache(maxsize=None)
def _blur_mat(n: int) -> np.ndarray:
    """(n, n) float64 matrix of the 9-tap clamp-addressed Gaussian: row o
    sums w[t+4] into column clip(o+t) — exactly blur_h/blur_v's _shift
    semantics as a linear operator."""
    m = np.zeros((n, n), np.float64)
    w = np.asarray(GAUSS_WEIGHTS, np.float64)
    rows = np.arange(n)
    for t in range(-_R, _R + 1):
        np.add.at(m, (rows, np.clip(rows + t, 0, n - 1)), w[t + _R])
    return m


@functools.lru_cache(maxsize=None)
def _blur_resize_mat(out_n: int, in_n: int) -> np.ndarray:
    """(out_n, in_n) f32: blur ∘ bilinear-resize folded into ONE matrix
    (both are linear operators along the axis)."""
    return (
        _blur_mat(out_n) @ _resize_matrix(out_n, in_n, True).astype(np.float64)
    ).astype(np.float32)


def _mm_rows(m, img):
    return jnp.einsum("oi,iwc->owc", m, img, precision=_HP)


def _mm_cols(m, img):
    return jnp.einsum("oi,hic->hoc", m, img, precision=_HP)


def bloom(hdr, row_sharding=None):
    """Full bloom chain; hdr (H, W, 3) -> (H, W, 3) with bloom added.

    Matrix formulation: every down/up/merge step is `blur_v ∘ blur_h ∘ resize`
    — all linear along each axis — so each step folds into ONE precomputed
    (rows) matrix and ONE (cols) matrix: the whole pyramid after the
    nonlinear prefilter is ~2 matmuls per level and zero pad/slice chains.
    Same operator as the reference pass sequence (see bloom_reference, which
    keeps the literal per-pass formulation; tests pin fused == literal).

    row_sharding: optional `jax.sharding.NamedSharding` over the row axis
    (PartitionSpec("sp",)). When given, pyramid levels big enough to split
    are annotated with it so GSPMD keeps the heavy full-/half-res matmuls
    row-parallel across the mesh; small deep mips are annotated replicated —
    they are <1% of the pixel work. The math is identical either way."""
    h, w = hdr.shape[0], hdr.shape[1]

    if row_sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_dev = row_sharding.mesh.shape[row_sharding.spec[0]]
        rep = NamedSharding(row_sharding.mesh, PartitionSpec())

        def cst(x):
            # shard only when every shard keeps >= 16 rows
            if x.shape[0] // n_dev >= 16:
                return jax.lax.with_sharding_constraint(x, row_sharding)
            return jax.lax.with_sharding_constraint(x, rep)
    else:
        def cst(x):
            return x

    def mip_size(m):
        return max(1, h >> m), max(1, w >> m)

    # downsample: a[m] is the blurred pyramid level at mip m;
    # down = blur_v(blur_h(resize(a))) = (Bv Mv) a (Bh Mh)^T
    a = {1: cst(prefilter(hdr, *mip_size(1)))}
    for i in range(BLOOM_STEPS):
        m = i + 1
        hh, ww = mip_size(m)
        lo_h, lo_w = mip_size(m + 1)
        pv = jnp.asarray(_blur_resize_mat(lo_h, hh))
        ph = jnp.asarray(_blur_resize_mat(lo_w, ww))
        a[m + 1] = cst(_mm_cols(ph, _mm_rows(pv, a[m])))
    # upsample-add: blur_v(blur_h(a) + blur_h(resize(a_lo)))
    #             = Bv a Bh^T + (Bv Mv) a_lo (Bh Mh)^T
    for i in range(BLOOM_STEPS - 1, -1, -1):
        m = i + 1
        hh, ww = mip_size(m)
        lh, lw = mip_size(m + 1)
        bv = jnp.asarray(_blur_mat(hh).astype(np.float32))
        bh = jnp.asarray(_blur_mat(ww).astype(np.float32))
        uv = jnp.asarray(_blur_resize_mat(hh, lh))
        uh = jnp.asarray(_blur_resize_mat(ww, lw))
        a[m] = cst(
            _mm_cols(bh, _mm_rows(bv, a[m]))
            + _mm_cols(uh, _mm_rows(uv, a[m + 1]))
        )
    # merge at full res
    fv = jnp.asarray(_blur_resize_mat(h, mip_size(1)[0]))
    fh = jnp.asarray(_blur_resize_mat(w, mip_size(1)[1]))
    full = cst(_mm_cols(fh, _mm_rows(fv, a[1])))
    return hdr + full


def bloom_reference(hdr):
    """The literal per-pass formulation (BloomPass::Execute order, shifted
    adds + separate resizes) — the semantic spec `bloom` must match; kept
    for tests/test_postprocess.py's fused-vs-literal equivalence check."""
    h, w = hdr.shape[0], hdr.shape[1]

    def mip_size(m):
        return max(1, h >> m), max(1, w >> m)

    a = {1: prefilter(hdr, *mip_size(1))}
    for i in range(BLOOM_STEPS):
        m = i + 1
        lo_h, lo_w = mip_size(m + 1)
        down = blur_h(resize_bilinear(a[m], lo_h, lo_w))
        a[m + 1] = blur_v(down)
    for i in range(BLOOM_STEPS - 1, -1, -1):
        m = i + 1
        hh, ww = mip_size(m)
        up = blur_h(a[m]) + blur_h(resize_bilinear(a[m + 1], hh, ww))
        a[m] = blur_v(up)
    full = blur_v(blur_h(resize_bilinear(a[1], h, w)))
    return hdr + full
