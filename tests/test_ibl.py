"""IBL precompute numerics: BRDF LUT and prefiltered env map."""

import numpy as np
import pytest

import jax.numpy as jnp

from direct12pbrrenderer.ops import common, ibl


def test_brdf_lut_known_properties():
    lut = np.asarray(ibl.brdf_lut(size=64, samples=256))
    a, b = lut[..., 0], lut[..., 1]
    # energy: scale+bias with F0=1 is bounded by 1
    assert (a + b).max() <= 1.0 + 1e-3
    assert a.min() >= 0 and b.min() >= 0
    # smooth surface head-on (r=0, NdotV=1): full specular scale, no bias
    assert a[-1, 0] == pytest.approx(1.0, abs=2e-2)
    assert b[-1, 0] == pytest.approx(0.0, abs=2e-2)
    # the Fresnel bias term is significant somewhere (peaks at low roughness,
    # grazing view); at rough+grazing the IBL G-term shadows it to ~0.02
    assert b.max() > 0.1


def test_brdf_lut_matches_scalar_reference():
    """Cross-check a handful of texels against a direct scalar transcription
    of precompute_brdf.hlsl (independent numpy implementation)."""
    size, samples = 16, 256
    lut = np.asarray(ibl.brdf_lut(size=size, samples=samples))
    xi = common.hammersley(samples)
    for yi, xi_idx in [(3, 4), (8, 12), (15, 1), (0, 0)]:
        roughness = xi_idx / (size - 1)
        n_dot_v = (yi + 1) / size
        v = np.array([np.sqrt(1 - n_dot_v**2), 0.0, n_dot_v])
        a = b = 0.0
        for s in range(samples):
            # scalar GGX importance sample around N=(0,0,1)
            al = roughness * roughness
            phi = 2 * np.pi * xi[s, 0]
            ct = np.sqrt((1 - xi[s, 1]) / (1 + (al * al - 1) * xi[s, 1]))
            st = np.sqrt(max(1 - ct * ct, 0))
            h = np.array([st * np.cos(phi), st * np.sin(phi), ct])
            # tangent frame of N=(0,0,1) per brdf.hlsli: up=(1,0,0) when N~z
            up = np.array([1.0, 0.0, 0.0])
            t = np.cross(np.array([0, 0, 1.0]), up)
            t /= np.linalg.norm(t)
            bt = np.cross(np.array([0, 0, 1.0]), t)
            h = t * h[0] + bt * h[1] + np.array([0, 0, 1.0]) * h[2]
            h /= np.linalg.norm(h)
            l = 2 * v.dot(h) * h - v
            l /= np.linalg.norm(l)
            if l[2] > 0:
                vdh = max(v.dot(h), 0)
                fc = (1 - vdh) ** 5
                k = roughness * roughness / 2
                g1 = l[2] / (l[2] * (1 - k) + k) if l[2] > 0 else 0
                g2 = n_dot_v / (n_dot_v * (1 - k) + k)
                gv = g1 * g2 * vdh / max(h[2] * n_dot_v, 1e-4)
                a += (1 - fc) * gv
                b += fc * gv
        np.testing.assert_allclose(
            lut[yi, xi_idx], [a / samples, b / samples], atol=2e-3
        )


def test_prefilter_mip0_is_identity():
    rng = np.random.default_rng(0)
    sky = rng.uniform(0, 4, (6, 32, 32, 3)).astype(np.float32)
    src = ibl.build_cubemap_mips(jnp.asarray(sky), 6)
    mips = ibl.prefilter_env_map(tuple(src), out_size=32, out_mips=3, samples=32,
                                 sample_chunk=8)
    np.testing.assert_allclose(np.asarray(mips[0]), sky, atol=1e-5)
    assert mips[1].shape == (6, 16, 16, 3)
    assert mips[2].shape == (6, 8, 8, 3)


def test_prefilter_preserves_constant_env():
    """A constant environment must prefilter to the same constant at every
    roughness (NdotL-weighted average of a constant)."""
    sky = np.full((6, 32, 32, 3), 2.5, np.float32)
    src = ibl.build_cubemap_mips(jnp.asarray(sky), 6)
    mips = ibl.prefilter_env_map(tuple(src), out_size=32, out_mips=4, samples=64,
                                 sample_chunk=16)
    for m in mips:
        np.testing.assert_allclose(np.asarray(m), 2.5, rtol=2e-3)


def test_prefilter_blurs_with_roughness():
    """Higher mips (rougher) must have lower per-face variance."""
    rng = np.random.default_rng(1)
    sky = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    src = ibl.build_cubemap_mips(jnp.asarray(sky), 6)
    mips = ibl.prefilter_env_map(tuple(src), out_size=32, out_mips=4, samples=128,
                                 sample_chunk=16)
    variances = [float(np.asarray(m).var()) for m in mips]
    assert variances[1] > variances[2] > variances[3]


def test_cubemap_sampling_roundtrip():
    """Sampling at exact texel-center directions returns the texel."""
    rng = np.random.default_rng(2)
    faces = rng.uniform(0, 1, (6, 16, 16, 3)).astype(np.float32)
    dirs = common.cubemap_face_dirs(16)
    out = np.asarray(common.sample_cubemap_bilinear(jnp.asarray(faces), jnp.asarray(dirs)))
    np.testing.assert_allclose(out, faces, atol=1e-5)


def test_octahedron_jax_matches_numpy():
    from direct12pbrrenderer.utils import mathlib as ml

    rng = np.random.default_rng(3)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(common.encode_octahedron(jnp.asarray(d))),
        ml.encode_octahedron(d),
        atol=1e-6,
    )
    uv = rng.uniform(0, 1, (256, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(common.decode_octahedron(jnp.asarray(uv))),
        ml.decode_octahedron(uv),
        atol=1e-6,
    )
