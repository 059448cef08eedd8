"""The XLA texture sampler (ops/gbuffer: page-major quad-record atlas,
LinearWrap trilinear/bilinear, software anisotropic) — the only sampler the
renderer has. Pinned against a scalar numpy reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from direct12pbrrenderer.ops import gbuffer
from direct12pbrrenderer.pipeline import scene_pack
from direct12pbrrenderer.resource.formats import ETextureFormat


class _StubTexture:
    """Minimal TextureData stand-in for the atlas builder."""

    def __init__(self, rng, w, h, srgb=False):
        self.format = (
            ETextureFormat.R8G8B8A8_UNORM_SRGB
            if srgb
            else ETextureFormat.R8G8B8A8_UNORM
        )
        self.mips = []
        while True:
            self.mips.append(
                rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            )
            if w == 1 and h == 1:
                break
            w, h = max(w >> 1, 1), max(h >> 1, 1)
        self.mip_levels = len(self.mips)

    def mip_array_rgba(self, mip):
        return self.mips[mip]


def _build_atlas(rng, specs):
    builder = scene_pack._AtlasBuilder()
    for w, h, srgb in specs:
        builder.add(_StubTexture(rng, w, h, srgb))
    a = builder.build()
    return gbuffer.AtlasDevice(
        jnp.asarray(a.data),
        jnp.asarray(a.page_base),
        jnp.asarray(a.base_size),
        jnp.asarray(a.n_mips),
        jnp.asarray(a.srgb),
    )


def _np_bilinear_wrap(img, u, v):
    """Scalar LinearWrap bilinear of one mip (uint8 RGBA -> [0, 1])."""
    img = img.astype(np.float64) / 255.0
    h, w = img.shape[:2]
    x, y = u * w - 0.5, v * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0
    xs, ys = (x0 % w, (x0 + 1) % w), (y0 % h, (y0 + 1) % h)
    return (img[ys[0], xs[0]] * (1 - fx) * (1 - fy)
            + img[ys[0], xs[1]] * fx * (1 - fy)
            + img[ys[1], xs[0]] * (1 - fx) * fy
            + img[ys[1], xs[1]] * fx * fy)


@pytest.mark.parametrize("filter", ["trilinear", "bilinear"])
def test_wrap_seam_and_mip_clamp(filter):
    """uv far outside [0,1] (wrap) and lod beyond the chain (clamp) match
    the scalar reference, in storage space."""
    rng = np.random.default_rng(11)
    tex = _StubTexture(rng, 32, 16)
    builder = scene_pack._AtlasBuilder()
    builder.add(tex)
    a = builder.build()
    atlas = gbuffer.AtlasDevice(
        jnp.asarray(a.data), jnp.asarray(a.page_base),
        jnp.asarray(a.base_size), jnp.asarray(a.n_mips), jnp.asarray(a.srgb))
    n = 64
    u = rng.random(n).astype(np.float32) * 20.0 - 10.0
    v = rng.random(n).astype(np.float32) * 20.0 - 10.0
    lod = rng.random(n).astype(np.float32) * 12.0 - 2.0
    got = np.asarray(gbuffer.sample_atlas_raw(
        atlas, jnp.zeros(n, jnp.int32), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(lod), filter=filter))
    top = tex.mip_levels - 1
    for i in range(n):
        l = min(max(float(lod[i]), 0.0), float(top))
        if filter == "bilinear":
            ref = _np_bilinear_wrap(tex.mips[int(np.round(l))], u[i], v[i])
        else:
            m0 = int(np.floor(l))
            f = l - m0
            ref = (_np_bilinear_wrap(tex.mips[m0], u[i], v[i]) * (1 - f)
                   + _np_bilinear_wrap(tex.mips[min(m0 + 1, top)], u[i],
                                       v[i]) * f)
        np.testing.assert_allclose(got[i], ref, atol=2e-4)


def test_page_major_layout_addressing():
    """page_record_index must address exactly the texel _page_major placed."""
    rng = np.random.default_rng(5)
    h, w = 24, 40  # non-multiple of page dims -> padded
    quads = rng.integers(0, 2**32, (h, w, 4), dtype=np.uint32)
    paged = scene_pack._page_major(quads)
    for x0, y0 in [(0, 0), (39, 23), (17, 9), (15, 7), (16, 8)]:
        idx = int(
            gbuffer.page_record_index(jnp.int32(0), jnp.int32(w),
                                      jnp.int32(x0), jnp.int32(y0))
        )
        np.testing.assert_array_equal(paged[idx], quads[y0, x0])


def test_anisotropic_beats_trilinear_at_grazing():
    """Software aniso (4 taps along the major axis, sharpened mip) must track
    a supersampled ground truth more closely than trilinear on a strongly
    anisotropic footprint (the floor-at-grazing-angle case)."""

    class _Checker:
        format = ETextureFormat.R8G8B8A8_UNORM

        def __init__(self, size=64):
            yy, xx = np.mgrid[0:size, 0:size]
            img = ((xx // 8 ^ yy // 8) & 1) * 255
            m = np.stack([img] * 3 + [np.full_like(img, 255)], -1).astype(np.uint8)
            self.mips = [m]
            while m.shape[0] > 1:
                m = m.reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2, 4).mean(
                    (1, 3)).astype(np.uint8)
                self.mips.append(m)
            self.mip_levels = len(self.mips)

        def mip_array_rgba(self, mip):
            return self.mips[mip]

    builder = scene_pack._AtlasBuilder()
    builder.add(_Checker())
    a = builder.build()
    atlas = gbuffer.AtlasDevice(
        jnp.asarray(a.data), jnp.asarray(a.page_base),
        jnp.asarray(a.base_size), jnp.asarray(a.n_mips), jnp.asarray(a.srgb))

    h, w = 8, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # 1 texel/px along u, 16 texels/px along v: ratio 16 (grazing floor)
    uv = np.stack([(xx + 0.5) / 64.0, (yy + 0.5) * 16.0 / 64.0], -1)
    ddx = np.broadcast_to(np.array([1 / 64.0, 0.0], np.float32), (h, w, 2))
    ddy = np.broadcast_to(np.array([0.0, 16 / 64.0], np.float32), (h, w, 2))
    tex = jnp.zeros((h, w, 5), jnp.int32)
    size5 = jnp.broadcast_to(
        atlas.base_size[0].astype(jnp.float32), (h, w, 5, 2))
    mask = jnp.ones((h, w), bool)
    uvj = jnp.asarray(uv)

    aniso = np.asarray(gbuffer.sample_atlas_anisotropic(
        atlas, tex, uvj, jnp.asarray(ddx), jnp.asarray(ddy), size5, mask
    ))[..., 0, :3]

    lod_tri = jnp.full((h, w, 5), np.log2(16.0), jnp.float32)
    tri = np.asarray(gbuffer.sample_atlas_raw(
        atlas, tex, uvj[..., 0:1], uvj[..., 1:2], lod_tri))[..., 0, :3]

    # ground truth: 33-point supersample of the mip-0 bilinear along the
    # footprint's long axis
    acc = 0.0
    for i in range(33):
        t = i / 32.0 - 0.5
        acc += np.asarray(gbuffer.sample_atlas_raw(
            atlas, tex,
            jnp.asarray(uv[..., 0:1]),
            jnp.asarray(uv[..., 1:2] + t * 16.0 / 64.0),
            jnp.zeros((h, w, 5), jnp.float32)))
    truth = (acc / 33.0)[..., 0, :3]

    err_aniso = float(np.sqrt(np.mean((aniso - truth) ** 2)))
    err_tri = float(np.sqrt(np.mean((tri - truth) ** 2)))
    assert err_aniso < err_tri * 0.6, (err_aniso, err_tri)
