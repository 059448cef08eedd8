"""Full-texel scalar transcription of env_map_gen.hlsl's prefilter kernel.

A literal numpy transcription of `DeferredRendering/Shader/env_map_gen.hlsl:50-104`
cs_main (with brdf.hlsli's ggx_important_sample / distribution_ggx and the
hammersley sequence), evaluated at single output texels and compared against
ops/ibl.prefilter_env_map for the same source cubemap — the companion to
tests/test_shading_transcription.py and tests/test_gbuffer_transcription.py.

Every shader-side term is transcribed independently: the GGX CDF inversion and
tangent-frame construction (brdf.hlsli:71-97), L = reflect(V, H), the PDF
`D*NdotH/(4*HdotV+1e-4)` and per-texel/sample solid angles with their exact
epsilons, the PDF-driven source mip selection `0.5*log2(sa_s/sa_t)`
(env_map_gen.hlsl:82-92), and the UE-style NdotL-weighted average
(env_map_gen.hlsl:96-101).

Conscious deviations, treated as the rebuild's separately-pinned units:
* source fetches go through `common.sample_cubemap_trilinear` (per-face
  clamped bilinear; the reference GPU sampler is seamless across edges);
* output directions use texel CENTERS ((x+0.5)/size; cubemap_face_dirs),
  where the compute shader's `dispatch_thread_id.xy / texture_size` hits
  texel corners — a half-texel grid shift the rebuild fixes deliberately.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from direct12pbrrenderer.ops import common, ibl

PI = np.pi


# ------------------------------------------------------- HLSL transcription
def ggx_important_sample(roughness, normal, xi):
    """brdf.hlsli:71-97, scalar."""
    a = roughness * roughness
    phi = 2.0 * PI * xi[0]
    cos_theta = np.sqrt((1.0 - xi[1]) / (1.0 + (a * a - 1.0) * xi[1]))
    sin_theta = np.sqrt(1.0 - cos_theta * cos_theta)
    h = np.array([sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta])

    up = np.array([0.0, 0.0, 1.0]) if abs(normal[2]) < 0.999 else np.array([1.0, 0.0, 0.0])
    tangent = np.cross(normal, up)
    tangent = tangent / np.linalg.norm(tangent)
    bitangent = np.cross(normal, tangent)
    world = tangent * h[0] + bitangent * h[1] + normal * h[2]
    return world / np.linalg.norm(world)


def distribution_ggx(n_dot_h, roughness):
    """brdf.hlsli distribution_ggx."""
    a = roughness * roughness
    t = n_dot_h * n_dot_h * (a * a - 1.0) + 1.0
    return a * a / max(PI * t * t, 1e-20)


def calc_cubemap_dir(slice_index, u, v):
    """env_map_gen.hlsl:21-44 (with the texel-center u,v noted above)."""
    u = 2 * u - 1
    v = 2 * v - 1
    d = [
        np.array([1.0, -v, -u]),
        np.array([-1.0, -v, u]),
        np.array([u, 1.0, v]),
        np.array([u, -1.0, -v]),
        np.array([u, -v, 1.0]),
        np.array([-u, -v, -1.0]),
    ][slice_index]
    return d / np.linalg.norm(d)


def cs_main_texel(src_mips, slice_index, x, y, mip, out_size, out_mips, samples):
    """env_map_gen.hlsl:51-104 for ONE output texel, scalar."""
    texture_size = out_size >> mip
    roughness = mip / (out_mips - 1)
    u = (x + 0.5) / texture_size
    v = (y + 0.5) / texture_size
    r = calc_cubemap_dir(slice_index, u, v)
    n = r
    vv = r

    xi_all = common.hammersley(samples)  # the shader's bit-reversal sequence,
    # itself pinned against brdf.hlsli:103-118 in test_ibl.py

    total_color = np.zeros(3)
    total_weight = 0.0
    for i in range(samples):
        xi = np.asarray(xi_all[i], np.float64)
        h = ggx_important_sample(roughness, n, xi)
        l = 2.0 * np.dot(vv, h) * h - vv
        l = l / np.linalg.norm(l)
        n_dot_l = max(np.dot(n, l), 0.0)
        if n_dot_l > 0:
            n_dot_h = max(np.dot(n, h), 0.0)
            h_dot_v = max(np.dot(h, vv), 0.0)
            d = distribution_ggx(n_dot_h, roughness)
            pdf = d * n_dot_h / (4.0 * h_dot_v + 0.0001)
            texel_sa = 4.0 * PI / (6 * out_size * out_size)
            sample_sa = 1.0 / (samples * pdf + 0.0001)
            mip_level = 0.0 if roughness == 0.0 else 0.5 * np.log2(sample_sa / texel_sa)
            color = np.asarray(
                common.sample_cubemap_trilinear(
                    [jnp.asarray(m) for m in src_mips],
                    jnp.asarray(l, jnp.float32),
                    jnp.asarray(mip_level, jnp.float32),
                ),
                np.float64,
            )
            total_color += color * n_dot_l
            total_weight += n_dot_l
    return total_color / total_weight


# ------------------------------------------------------------------- test
def _source_cubemap(size=16):
    """Smooth per-face-distinguishable HDR content."""
    rng = np.random.default_rng(3)
    dirs = common.cubemap_face_dirs(size).astype(np.float64)  # (6,s,s,3)
    base = np.stack(
        [
            2.0 + 1.5 * dirs[..., 0],
            1.0 + 0.8 * dirs[..., 1],
            0.5 + 0.4 * dirs[..., 2],
        ],
        axis=-1,
    )
    lobes = rng.normal(size=(4, 3))
    lobes /= np.linalg.norm(lobes, axis=-1, keepdims=True)
    for lb in lobes:
        base += 6.0 * np.maximum((dirs * lb).sum(-1)[..., None], 0.0) ** 4
    return base.astype(np.float32)


@pytest.mark.parametrize(
    "mip,slice_index,x,y",
    [(1, 0, 1, 2), (2, 3, 0, 1), (3, 5, 0, 0), (1, 2, 3, 3)],
)
def test_prefilter_matches_hlsl_transcription(mip, slice_index, x, y):
    out_size, out_mips, samples = 8, 4, 64
    src0 = _source_cubemap(16)
    src_mips = ibl.build_cubemap_mips(jnp.asarray(src0), 5)
    src_mips = [np.asarray(m) for m in src_mips]

    got_mips = ibl.prefilter_env_map(
        tuple(jnp.asarray(m) for m in src_mips),
        out_size=out_size, out_mips=out_mips, samples=samples, sample_chunk=16,
    )
    got = np.asarray(got_mips[mip])[slice_index, y, x]

    want = cs_main_texel(
        src_mips, slice_index, x, y, mip, out_size, out_mips, samples
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_prefilter_mip0_is_identity():
    """roughness 0: the GGX CDF collapses to H=N=L and source mip 0 — the
    shader's 1024 identical samples equal one fetch of the texel itself
    (env_map_gen.hlsl:92 Roughness==0 branch)."""
    src0 = _source_cubemap(8)
    src_mips = [jnp.asarray(m) for m in ibl.build_cubemap_mips(jnp.asarray(src0), 4)]
    got = np.asarray(
        ibl.prefilter_env_map(tuple(src_mips), out_size=8, out_mips=3,
                              samples=16, sample_chunk=16)[0]
    )
    np.testing.assert_allclose(got, src0, rtol=1e-5, atol=1e-6)
