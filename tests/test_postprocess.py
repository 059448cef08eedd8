"""HDR post-chain numerics: histogram, exposure EMA, ACES, bloom."""

import numpy as np
import jax.numpy as jnp
import pytest

from direct12pbrrenderer.config import NUM_HISTOGRAM_BINS
from direct12pbrrenderer.ops import bloom, postprocess


def test_histogram_binning_matches_shader_rule():
    # luminance exactly 1.0 -> log2=0 -> (0-(-10))/12 = 0.8333 -> bin 212.666->212+1?
    img = np.ones((4, 4, 3), np.float32)
    h = np.asarray(postprocess.luminance_histogram(jnp.asarray(img)))
    expected_bin = int(np.floor((0 + 10) / 12 * 254 + 1))
    assert h[expected_bin] == 16
    assert h.sum() == 16
    # near-black pixels land in bin 0
    h0 = np.asarray(postprocess.luminance_histogram(jnp.zeros((4, 4, 3))))
    assert h0[0] == 16


def test_average_luminance_excludes_black_and_smooths():
    img = np.zeros((16, 16, 3), np.float32)
    img[:8] = 1.0  # half the pixels at luminance 1, half black
    hist = postprocess.luminance_histogram(jnp.asarray(img))
    # from zero state with huge dt -> jumps to current average
    avg = float(postprocess.average_luminance(hist, 256.0, jnp.asarray(0.0), 100.0))
    # average bin excludes the 128 black pixels entirely
    expected_bin = np.floor((0 + 10) / 12 * 254 + 1)
    lum = 2 ** ((expected_bin - 1) / 254 * 12 - 10)
    assert avg == pytest.approx(lum, rel=1e-3)
    # small dt -> EMA crawls: lerp factor 1-exp(-dt*1.6)
    avg2 = float(postprocess.average_luminance(hist, 256.0, jnp.asarray(0.0), 1 / 60))
    assert 0 < avg2 < avg
    assert avg2 / lum == pytest.approx(1 - np.exp(-1.6 / 60), rel=1e-3)


def test_aces_curve_properties():
    x = jnp.asarray([0.0, 0.18, 1.0, 10.0])
    y = np.asarray(postprocess.aces_tone_map(x))
    assert y[0] == 0
    assert 0.0 < y[1] < 0.3
    assert 0.7 < y[2] <= 1.0
    assert y[3] == 1.0  # saturates


def test_tone_map_exposure_rule():
    # uniform image at the average luminance -> exposed = 1/9.6 pre-ACES
    img = jnp.full((8, 8, 3), 0.5)
    out = np.asarray(postprocess.tone_map(img, jnp.asarray(0.5)))
    exposed = 0.5 / (9.6 * 0.5 + 0.001)
    expect = np.clip((exposed * (2.51 * exposed + 0.03))
                     / (exposed * (2.43 * exposed + 0.59) + 0.14), 0, 1) ** (1 / 2.2)
    expect_q = np.round(expect * 255) / 255
    np.testing.assert_allclose(out, expect_q, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (135, 240), (96, 128)])
def test_bloom_shapes_and_sanity(hw):
    h, w = hw
    img = np.zeros((h, w, 3), np.float32)
    # 2x2 patch: a single texel can legitimately fall between prefilter
    # sample positions at odd mip ratios (the reference grid does the same)
    img[h // 2 : h // 2 + 2, w // 2 : w // 2 + 2] = 50.0
    out = np.asarray(bloom.bloom(jnp.asarray(img)))
    assert out.shape == (h, w, 3)
    assert np.isfinite(out).all()
    # energy added near the spike, negligible far away
    assert out[h // 2, w // 2 - 3].sum() > img[h // 2, w // 2 - 3].sum()
    assert out[2, 2].sum() < 0.05  # tiny wide-pyramid spill at small sizes


def test_bloom_threshold_knee():
    # below threshold-knee: fully suppressed
    lo = np.asarray(bloom.bloom_threshold(jnp.asarray([[0.2, 0.2, 0.2]])))
    assert np.allclose(lo, 0, atol=1e-3)
    # far above threshold: passes nearly unchanged
    hi = np.asarray(bloom.bloom_threshold(jnp.asarray([[8.0, 8.0, 8.0]])))
    np.testing.assert_allclose(hi, [[7.0, 7.0, 7.0]], rtol=0.01)  # b - threshold


def test_resize_matrix_phases():
    # 2x upsample, half phase: out[2k] = 0.25 in[k-1] + 0.75 in[k]
    m = bloom._resize_matrix(8, 4, half_phase=True)
    np.testing.assert_allclose(m[0], [1, 0, 0, 0])  # clamped at edge
    np.testing.assert_allclose(m[1], [0.75, 0.25, 0, 0])
    np.testing.assert_allclose(m[2], [0.25, 0.75, 0, 0])
    # downsample 2x half phase: out[k] = 0.5 in[2k+...]
    d = bloom._resize_matrix(4, 8, half_phase=True)
    np.testing.assert_allclose(d[1], [0, 0, 0.5, 0.5, 0, 0, 0, 0])


def test_average_luminance_direct_matches_histogram_path():
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.random((32, 48, 3), np.float32) * 5.0)
    hist = postprocess.luminance_histogram(img)
    a = float(postprocess.average_luminance(hist, 32.0 * 48, jnp.asarray(0.2), 0.5))
    b = float(postprocess.average_luminance_direct(img, 32.0 * 48, jnp.asarray(0.2), 0.5))
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_bloom_fused_matches_literal():
    """The matmul formulation (blur∘resize folded into per-level
    matrices) must equal the literal per-pass chain it re-associates."""
    rng = np.random.default_rng(11)
    img = (rng.random((96, 128, 3)) * 12.0).astype(np.float32)
    fused = np.asarray(bloom.bloom(jnp.asarray(img)))
    literal = np.asarray(bloom.bloom_reference(jnp.asarray(img)))
    np.testing.assert_allclose(fused, literal, rtol=2e-5, atol=2e-5)
