"""Full-pixel scalar transcription of gbuffer.hlsl's pixel shader.

A literal numpy transcription of `DeferredRendering/Shader/gbuffer.hlsl:88-148`
ps_main (with global.hlsli's pack_normal/encode_octahedron and decode_gamma),
evaluated at ONE pixel and compared against ops/gbuffer._shade_from_interp for
the same interpolants — the companion to tests/test_shading_transcription.py.

Quirks intentionally covered:
* albedo is DOUBLE-decoded: the AlbedoMap SRV is sRGB (hardware linearizes)
  and the shader then applies decode_gamma again (gbuffer.hlsl:110);
* ambient occlusion defaults to 0.0 (not 1.0) when unmapped
  (gbuffer.hlsl:135-142);
* TBN rows are (tangent, bitangent=cross(normal, tangent), normal) and the
  tangent-space normal is row-vector multiplied: mul(n_ts, TBN)
  (gbuffer.hlsl:62-69);
* `Sample()` maps to the rebuild's LinearWrap trilinear unit with the LOD
  from hardware-style 2x2-quad derivatives of uv (same definition as ddx/ddy
  coarse); the sampler unit itself is pinned separately
  (tests/test_sampler.py) — this test pins every shader-side term.
"""

import numpy as np
import jax.numpy as jnp

from direct12pbrrenderer.ops import common, gbuffer

from test_sampler import _build_atlas, _StubTexture  # noqa: F401


# ------------------------------------------------------- HLSL transcription
def srgb_eotf(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def decode_gamma(c):
    return np.maximum(c, 0.0) ** 2.2  # global.hlsli:75-78


def encode_octahedron(d):
    # global.hlsli:117-128 (sign(0)=0 never triggers for these inputs)
    d = d / (abs(d[0]) + abs(d[1]) + abs(d[2]))
    if d[2] < 0:
        sx = 1.0 if d[0] >= 0 else -1.0
        sy = 1.0 if d[1] >= 0 else -1.0
        d = np.array([sx * (1 - abs(d[1])), sy * (1 - abs(d[0])), d[2]])
    return np.array([d[0], d[1]]) * 0.5 + 0.5


def sample_linear_wrap(mips, srgb, u, v, lod):
    """Scalar LinearWrap trilinear: the rebuild's texture unit
    (gbuffer.sample_atlas_trilinear — storage-space filter, then sRGB EOTF)."""
    def bilinear(mip, u, v):
        img = mips[min(mip, len(mips) - 1)].astype(np.float64) / 255.0
        h, w = img.shape[0], img.shape[1]
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        xs = [(x0 % w), ((x0 + 1) % w)]
        ys = [(y0 % h), ((y0 + 1) % h)]
        return (
            img[ys[0], xs[0]] * (1 - fx) * (1 - fy)
            + img[ys[0], xs[1]] * fx * (1 - fy)
            + img[ys[1], xs[0]] * (1 - fx) * fy
            + img[ys[1], xs[1]] * fx * fy
        )

    lod = float(np.clip(lod, 0.0, len(mips) - 1))
    m0 = int(np.floor(lod))
    frac = lod - m0
    c = bilinear(m0, u, v) * (1 - frac) + bilinear(m0 + 1, u, v) * frac
    if srgb:
        c = np.concatenate([srgb_eotf(c[:3]), c[3:]])
    return c


def ps_main(uv, normal_ws_in, tangent_ws_in, mat, textures, lods, use):
    """Literal gbuffer.hlsl:88-148. textures[i] = (mips, srgb)."""
    def sample(slot):
        return sample_linear_wrap(*textures[slot], uv[0], uv[1], lods[slot])

    def normalize(x):
        return x / np.linalg.norm(x)

    # sample_normal_texture (gbuffer.hlsl:62-69)
    if use["normal"]:
        normal = normalize(normal_ws_in)
        tangent = normalize(tangent_ws_in)
        bitangent = np.cross(normal, tangent)
        tbn = np.stack([tangent, bitangent, normal])  # rows
        n_ts = sample(1)[:3] * 2 - 1
        normal_ws = normalize(n_ts @ tbn)             # mul(v, M): row vector
    else:
        normal_ws = normalize(normal_ws_in)

    if use["albedo"]:
        albedo = decode_gamma(sample(0)[:3])          # double decode quirk
    else:
        albedo = decode_gamma(mat["albedo"])

    roughness = sample(3)[0] if use["roughness"] else mat["roughness"]
    metallic = sample(2)[0] if use["metallic"] else mat["metallic"]
    ambient_occlusion = sample(4)[0] if use["ao"] else 0.0  # 0, not 1: quirk

    gbuffer_a = np.concatenate([albedo, [mat["emission"]]])
    gbuffer_b = encode_octahedron(normal_ws)
    gbuffer_c = np.array([roughness, metallic, ambient_occlusion])
    return gbuffer_a, gbuffer_b, gbuffer_c


# ----------------------------------------------------------------- driver
def _run_case(use_maps: bool):
    rng = np.random.default_rng(42)
    specs = [(8, 8, True), (8, 8, False), (8, 8, False), (8, 8, False),
             (8, 8, False)]
    stubs = [_StubTexture(rng, w, h, srgb) for (w, h, srgb) in specs]
    from direct12pbrrenderer.pipeline import scene_pack

    builder = scene_pack._AtlasBuilder()
    for s in stubs:
        builder.add(s)
    a = builder.build()
    atlas = gbuffer.AtlasDevice(
        jnp.asarray(a.data), jnp.asarray(a.page_base),
        jnp.asarray(a.base_size), jnp.asarray(a.n_mips), jnp.asarray(a.srgb),
    )

    H, W = 8, 8
    # interp planes: uv linear across the frame; normal/tangent vary smoothly
    px = np.arange(W, dtype=np.float32)[None, :] + 0.5
    py = np.arange(H, dtype=np.float32)[:, None] + 0.5
    uv = np.stack([px / W * 1.7 + 0.1 * py / H,
                   py / H * 1.3 + 0.05 * px / W], -1).astype(np.float32)
    nrm = np.stack([np.broadcast_to(0.2 + 0.02 * px / W, (H, W)),
                    np.broadcast_to(0.9 - 0.01 * py / H, (H, W)),
                    np.full((H, W), 0.3, np.float32)], -1).astype(np.float32)
    tan = np.stack([np.full((H, W), 0.95, np.float32),
                    np.broadcast_to(-0.2 + 0.02 * py / H, (H, W)),
                    np.full((H, W), 0.1, np.float32)], -1).astype(np.float32)
    interp = jnp.asarray(np.concatenate([uv, nrm, tan], -1))

    mat = {"albedo": np.array([0.7, 0.35, 0.2]), "emission": 0.6,
           "roughness": 0.45, "metallic": 0.15}
    use_flags = np.full(5, 1.0 if use_maps else 0.0, np.float32)
    matrow = np.zeros((H, W, 16), np.float32)
    matrow[..., 0:3] = mat["albedo"]
    matrow[..., 3] = mat["emission"]
    matrow[..., 4] = mat["roughness"]
    matrow[..., 5] = mat["metallic"]
    matrow[..., 6:11] = use_flags
    matrow[..., 11:16] = np.arange(5)

    mask = jnp.ones((H, W), bool)
    depth = jnp.full((H, W), 0.5, jnp.float32)
    gb = gbuffer._shade_from_interp(
        jnp.asarray(interp), jnp.asarray(matrow), mask, depth, atlas,
        texture_filter="trilinear",
    )

    # --------------- transcription at one pixel (3, 5) --------------------
    y, x = 3, 5
    # hardware quad derivatives: both pixels of a 2x2 quad share the diff
    qx, qy = (x // 2) * 2, (y // 2) * 2
    ddx = uv[y, qx + 1] - uv[y, qx]
    ddy = uv[qy + 1, x] - uv[qy, x]
    lods = []
    for slot in range(5):
        size = np.array([8.0, 8.0])
        gx = ddx * size
        gy = ddy * size
        rho2 = max(float(gx @ gx), float(gy @ gy))
        lods.append(0.5 * np.log2(max(rho2, 1e-12)))

    textures = [(s.mips, bool(srgb)) for s, (_, _, srgb) in zip(stubs, specs)]
    use = {k: use_maps for k in ("albedo", "normal", "metallic",
                                 "roughness", "ao")}
    ga, gbn, gc = ps_main(uv[y, x], nrm[y, x], tan[y, x], mat,
                          textures, lods, use)

    def q8(v):  # _quantize8: RGBA8 render-target quantization
        return np.round(np.clip(v, 0.0, 1.0) * 255.0) / 255.0

    np.testing.assert_allclose(
        np.asarray(gb.albedo_emission)[y, x], q8(ga), atol=1 / 255.0 + 1e-6)
    np.testing.assert_allclose(
        np.asarray(gb.normal_oct)[y, x], q8(gbn), atol=1 / 255.0 + 1e-6)
    np.testing.assert_allclose(
        np.asarray(gb.rough_metal_ao)[y, x], q8(gc), atol=1 / 255.0 + 1e-6)
    # pre-quantization check on the analytically-exact channels
    if not use_maps:
        np.testing.assert_allclose(
            np.asarray(gb.rough_metal_ao)[y, x],
            q8([mat["roughness"], mat["metallic"], 0.0]), atol=1e-6)


def test_gbuffer_ps_transcription_mapped():
    _run_case(use_maps=True)


def test_gbuffer_ps_transcription_constants():
    _run_case(use_maps=False)
