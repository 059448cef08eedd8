"""Deferred G-buffer pass: attribute interpolation + material sampling.

The pixel-shader half of `gbuffer.hlsl` (ps_main, :89-148), evaluated over
the whole frame after visibility is resolved by `ops.raster` — i.e. shading
happens exactly once per pixel (what the reference needs stencil masking for,
we get from the tri-id image).

G-buffer layout (gbuffer.hlsl:10-26, all RGBA8 per DeferredPipeline.h:107-109):
  A: albedo.rgb (gamma-decoded!), emission
  B: octahedral-packed world normal (8 bits/channel — the stale "R16G16"
     comment in the shader notwithstanding), 1, 0
  C: roughness, metallic, ambient occlusion, 0
plus the ndc depth image and the coverage mask (stencil analog).

Gather discipline: per-pixel state is packed into one contiguous (T, 64)
per-triangle row (edge equations, the whole ConstantBufferInstance material
block and the three vertex attribute rows), so the interpolation stage
fetches the winning triangle's row by index once per pixel instead of ~10
scattered loads. Texture sampling
reproduces the D3D sampler stack: LinearWrap trilinear with quad-difference
LOD and sRGB-EOTF linearization for *_SRGB SRVs (the shipped albedo maps are
sRGB SRVs AND the shader gamma-decodes again — we reproduce the double
decode, gbuffer.hlsl:110-114).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import common


class AtlasDevice(NamedTuple):
    data: jnp.ndarray         # (N, 4) uint32 quad records, page-major (scene_pack)
    page_base: jnp.ndarray    # (T, MAX_MIPS) int32 page offsets
    base_size: jnp.ndarray    # (T, 2) int32
    n_mips: jnp.ndarray       # (T,) int32
    srgb: jnp.ndarray         # (T,) bool


def pack_material_rows(albedo, emission, roughness, metallic, use_map, tex_ids):
    """(M, 16) material rows: [albedo(3), emission, roughness, metallic,
    use(5), tex(5)] — the ConstantBufferInstance block in SoA->AoS form.
    Host-side, once per scene."""
    m = len(emission)
    rows = np.zeros((m, 16), np.float32)
    rows[:, 0:3] = albedo
    rows[:, 3] = emission
    rows[:, 4] = roughness
    rows[:, 5] = metallic
    rows[:, 6:11] = use_map.astype(np.float32)
    rows[:, 11:16] = tex_ids.astype(np.float32)  # exact for ids < 2^24
    return rows


def pack_vertex_attrs(uvs, normals_ws, tangents_ws):
    """(V, 8): [uv(2), normal(3), tangent(3)] — one contiguous row per vertex."""
    return jnp.concatenate([uvs, normals_ws, tangents_ws], axis=1)


def _unpack_rgba(u32):
    r = (u32 & 0xFF).astype(jnp.float32)
    g = ((u32 >> 8) & 0xFF).astype(jnp.float32)
    b = ((u32 >> 16) & 0xFF).astype(jnp.float32)
    a = ((u32 >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b, a], -1) * (1.0 / 255.0)


def page_record_index(page_base, w, x0, y0):
    """Flat record index of wrapped texel (x0, y0) in the page-major layout
    (16x8-texel pages, 128 records each; see scene_pack.TextureAtlas)."""
    pages_x = (w + 15) >> 4
    page = page_base + (y0 >> 3) * pages_x + (x0 >> 4)
    return page * 128 + (y0 & 7) * 16 + (x0 & 15)


def _sample_mip_bilinear(atlas: AtlasDevice, tex_id, mip, u, v):
    """Bilinear wrap sample of one mip: ONE 16-byte quad-record gather per tap
    (the record holds the full 2x2 neighborhood). Broadcastable args."""
    mip = jnp.minimum(mip, atlas.n_mips[tex_id] - 1)
    w = jnp.maximum(atlas.base_size[tex_id, 0] >> mip, 1)
    h = jnp.maximum(atlas.base_size[tex_id, 1] >> mip, 1)
    off = atlas.page_base[tex_id, mip]

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = jnp.mod(x0.astype(jnp.int32), w)
    y0 = jnp.mod(y0.astype(jnp.int32), h)

    quad = atlas.data[page_record_index(off, w, x0, y0)]  # (..., 4) u32
    c00 = _unpack_rgba(quad[..., 0])
    c01 = _unpack_rgba(quad[..., 1])
    c10 = _unpack_rgba(quad[..., 2])
    c11 = _unpack_rgba(quad[..., 3])
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_atlas_raw(atlas: AtlasDevice, tex_id, u, v, lod,
                     filter: str = "trilinear"):
    """LinearWrap mip filtering in storage space (no sRGB linearization)."""
    lod = jnp.clip(lod, 0.0, (atlas.n_mips[tex_id] - 1).astype(jnp.float32))
    if filter == "bilinear":
        m0 = jnp.round(lod).astype(jnp.int32)
        return _sample_mip_bilinear(atlas, tex_id, m0, u, v)
    m0 = jnp.floor(lod).astype(jnp.int32)
    frac = (lod - m0)[..., None]
    c0 = _sample_mip_bilinear(atlas, tex_id, m0, u, v)
    c1 = _sample_mip_bilinear(atlas, tex_id, m0 + 1, u, v)
    return c0 * (1 - frac) + c1 * frac


def apply_srgb(atlas: AtlasDevice, tex_id, c):
    """sRGB-EOTF linearization of the rgb channels where the SRV is *_SRGB."""
    lin = common.srgb_eotf(c[..., :3])
    rgb = jnp.where(atlas.srgb[tex_id][..., None], lin, c[..., :3])
    return jnp.concatenate([rgb, c[..., 3:]], -1)


def sample_atlas_anisotropic(atlas: AtlasDevice, tex, uv, ddx, ddy, size5,
                             mask, n_taps: int = 4):
    """Software anisotropic filtering (sRGB-linearized where flagged).

    The reference binds an anisotropic static sampler
    (D3D12CommandList.cpp:295-302); this is the EWA-style software
    approximation: `n_taps` trilinear taps spread along the major-gradient
    axis, mip chosen from the footprint's MINOR axis sharpened by the aniso
    ratio — sharp along the stretched direction, antialiased across it.
    Quality knob on the XLA sampler path (cost is linear in n_taps).

    tex (H, W, 5); uv (H, W, 2); ddx/ddy (H, W, 2) screen-space uv
    derivatives; size5 (H, W, 5, 2) texture dims; mask (H, W) coverage.
    """
    gx = ddx[..., None, :] * size5
    gy = ddy[..., None, :] * size5
    rx2 = (gx * gx).sum(-1)
    ry2 = (gy * gy).sum(-1)
    rho2 = jnp.maximum(rx2, ry2)
    rho_min2 = jnp.maximum(jnp.minimum(rx2, ry2), 1e-12)
    ratio = jnp.clip(jnp.sqrt(rho2 / rho_min2), 1.0, float(n_taps))
    lod_a = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-12)) - jnp.log2(ratio)
    lod_a = jnp.where(mask[..., None], lod_a, 99.0)
    major = jnp.where((rx2 >= ry2)[..., None],
                      ddx[..., None, :], ddy[..., None, :])   # (H, W, 5, 2)
    acc = 0.0
    for i in range(n_taps):
        t = (i + 0.5) / n_taps - 0.5
        uv_i = uv[..., None, :] + major * t
        acc = acc + sample_atlas_trilinear(
            atlas, tex, uv_i[..., 0], uv_i[..., 1], lod_a,
            filter="trilinear",
        )
    return acc * (1.0 / n_taps)


def sample_atlas_trilinear(atlas: AtlasDevice, tex_id, u, v, lod,
                           filter: str = "trilinear"):
    """LinearWrap mip filtering, sRGB-linearized when flagged.

    filter="trilinear" is the reference parity path (two mip taps);
    "bilinear" snaps to the nearest mip (one tap, a speed knob)."""
    return apply_srgb(
        atlas, tex_id, sample_atlas_raw(atlas, tex_id, u, v, lod, filter)
    )


def _quad_derivatives(img):
    """2x2-quad screen derivatives like hardware ddx/ddy. img: (H, W, C) ->
    (ddx, ddy) with both pixels of a quad pair sharing the difference."""
    h, w = img.shape[0], img.shape[1]
    pairs_x = img.reshape(h, w // 2, 2, -1)
    dx = (pairs_x[:, :, 1] - pairs_x[:, :, 0])[:, :, None, :]
    ddx = jnp.broadcast_to(dx, pairs_x.shape).reshape(img.shape)
    pairs_y = img.reshape(h // 2, 2, w, -1)
    dy = (pairs_y[:, 1] - pairs_y[:, 0])[:, None, :, :]
    ddy = jnp.broadcast_to(dy, pairs_y.shape).reshape(img.shape)
    return ddx, ddy


class GBuffer(NamedTuple):
    albedo_emission: jnp.ndarray  # (H, W, 4) "GBufferA"
    normal_oct: jnp.ndarray       # (H, W, 2) "GBufferB".rg
    rough_metal_ao: jnp.ndarray   # (H, W, 3) "GBufferC".rgb
    depth: jnp.ndarray            # (H, W) ndc z
    mask: jnp.ndarray             # (H, W) bool coverage (stencil != 0 analog)


def _quantize8(x):
    """RGBA8 render-target quantization (round to nearest 1/255)."""
    return jnp.round(jnp.clip(x, 0.0, 1.0) * 255.0) * (1.0 / 255.0)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "texture_filter"),
)
def gbuffer_shade(
    tri_id,       # (H, W) int32 from rasterize
    depth,        # (H, W) f32
    tri_rows,     # (T, 64): raster row ++ material ++ 3 vertex rows
    atlas: AtlasDevice,
    width: int,
    height: int,
    y_offset=0,
    texture_filter: str = "trilinear",
) -> GBuffer:
    interp, matrow, mask = interp_from_rows(tri_id, tri_rows, width, height,
                                            y_offset)
    return _shade_from_interp(interp, matrow, mask, depth, atlas,
                              texture_filter)


def interp_from_rows(tri_id, tri_rows, width, height, y_offset=0):
    """Per-pixel (interpolants (H, W, 8), material row (H, W, 16), mask) from
    the rasterized id map + packed 64-f32 triangle rows: the winning
    triangle's row is fetched by index, once per pixel."""
    mask = tri_id >= 0
    tid = jnp.maximum(tri_id, 0)

    py, px = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32) + 0.5,
        jnp.arange(width, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    py = py + y_offset

    row = tri_rows[tid]  # (H, W, 64) — ONE gather for ALL per-pixel data
    _, lam_p, _ = _bary(row, px, py)

    attrs = row[..., 32:56].reshape(*row.shape[:-1], 3, 8)
    interp = (attrs * lam_p[..., None]).sum(-2)  # (H, W, 8)
    return interp, row[..., 16:32], mask


def tap_lod(uv, tex, mask, atlas: AtlasDevice):
    """Per-slot mip LOD from the pixel-quad uv derivatives (gbuffer.hlsl's
    implicit Sample LOD): (ddx, ddy, size5, lod5)."""
    ddx, ddy = _quad_derivatives(uv)
    size5 = atlas.base_size[tex].astype(jnp.float32)     # (H, W, 5, 2)
    gx = ddx[..., None, :] * size5
    gy = ddy[..., None, :] * size5
    rx2 = (gx * gx).sum(-1)
    ry2 = (gy * gy).sum(-1)
    rho2 = jnp.maximum(rx2, ry2)                              # (H, W, 5)
    lod5 = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-12))
    lod5 = jnp.where(mask[..., None], lod5, 99.0)  # background -> last mip
    return ddx, ddy, size5, lod5


def _shade_from_interp(interp, matrow, mask, depth, atlas: AtlasDevice,
                       texture_filter: str = "trilinear") -> GBuffer:
    # background pixels otherwise carry garbage interpolants -> random fetch
    # addresses; pinning them to one coarse texel keeps those fetches (up to
    # half the frame is sky) on a single hot line
    interp = jnp.where(mask[..., None], interp, 0.0)
    uv = interp[..., 0:2]
    nrm = interp[..., 2:5]
    tan = interp[..., 5:8]
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    tan = tan / jnp.maximum(jnp.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)

    mat_albedo = matrow[..., 0:3]
    mat_emission = matrow[..., 3]
    mat_roughness = matrow[..., 4]
    mat_metallic = matrow[..., 5]
    use = matrow[..., 6:11] > 0.5
    tex = jnp.maximum(matrow[..., 11:16].astype(jnp.int32), 0)

    # uv derivatives -> per-texture LOD (texel-space gradient length, log2).
    # All five material slots sample through ONE vectorized trilinear call
    # (slot axis batched) — 5x less emitted gather code, bigger fused fetches.
    ddx, ddy, size5, lod5 = tap_lod(uv, tex, mask, atlas)

    if texture_filter == "anisotropic":
        samples = sample_atlas_anisotropic(
            atlas, tex, uv, ddx, ddy, size5, mask
        )                                                     # (H, W, 5, 4)
    else:
        samples = sample_atlas_trilinear(
            atlas, tex, uv[..., 0:1], uv[..., 1:2], lod5,
            filter=texture_filter,
        )  # (H, W, 5, 4)
    albedo_tex = samples[..., 0, :3]
    normal_tex = samples[..., 1, :3]
    metallic_tex = samples[..., 2, 0]
    roughness_tex = samples[..., 3, 0]
    ao_tex = samples[..., 4, 0]

    # normal mapping: TBN with bitangent = cross(N, T) (gbuffer.hlsl:63-69)
    bit = jnp.cross(nrm, tan)
    n_ts = normal_tex * 2.0 - 1.0
    n_mapped = tan * n_ts[..., 0:1] + bit * n_ts[..., 1:2] + nrm * n_ts[..., 2:3]
    n_mapped = n_mapped / jnp.maximum(
        jnp.linalg.norm(n_mapped, axis=-1, keepdims=True), 1e-20
    )
    normal_ws = jnp.where(use[..., 1:2], n_mapped, nrm)

    albedo = jnp.where(
        use[..., 0:1],
        common.decode_gamma(albedo_tex),
        common.decode_gamma(mat_albedo),
    )
    roughness = jnp.where(use[..., 3], roughness_tex, mat_roughness)
    metallic = jnp.where(use[..., 2], metallic_tex, mat_metallic)
    # AO defaults to 0 when unmapped (gbuffer.hlsl:135-138) — reference quirk
    ao = jnp.where(use[..., 4], ao_tex, 0.0)
    emission = mat_emission

    oct = common.encode_octahedron(normal_ws)

    gb_a = _quantize8(jnp.concatenate([albedo, emission[..., None]], -1))
    gb_b = _quantize8(oct)
    gb_c = _quantize8(jnp.stack([roughness, metallic, ao], -1))

    zero = jnp.zeros(())
    gb_a = jnp.where(mask[..., None], gb_a, zero)
    gb_b = jnp.where(mask[..., None], gb_b, zero)
    gb_c = jnp.where(mask[..., None], gb_c, zero)
    return GBuffer(gb_a, gb_b, gb_c, depth, mask)


def _bary(row, px, py):
    """Perspective-correct barycentrics from the pre-gathered (.., 32) row.

    With homogeneous edge rows (raster.setup_triangles) the edge scores B_i
    ARE the unnormalized perspective weights: lam = B / sum(B)."""
    e = row[..., :9].reshape(row.shape[:-1] + (3, 3))
    ph = jnp.stack([px, py, jnp.ones_like(px)], -1)
    scores = (e * ph[..., None, :]).sum(-1)
    sum_b = scores.sum(-1)
    lam_persp = scores / jnp.where(sum_b == 0, 1.0, sum_b)[..., None]
    return None, lam_persp, sum_b
