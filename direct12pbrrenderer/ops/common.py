"""Shared device-side (jax.numpy) shading helpers.

The jnp mirror of `Shader/global.hlsli` + `Shader/brdf.hlsli`: gamma/sRGB
transfer functions, octahedral normal packing, luminance, Cook-Torrance GGX
terms, Hammersley sequence and GGX importance sampling, and cubemap
addressing/sampling. Everything is shape-polymorphic over leading dims and
jit-friendly (branchless `where` instead of control flow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PI = 3.14159265359
INV_PI = 0.31830988618
EPSILON = 1e-6


# ---------------------------------------------------------------------------
# Transfer functions
# ---------------------------------------------------------------------------

def decode_gamma(c):
    """pow 2.2 decode (global.hlsli:75-78)."""
    return jnp.power(jnp.maximum(c, 0.0), 2.2)


def encode_gamma(c):
    return jnp.power(jnp.maximum(c, 0.0), 1.0 / 2.2)


def srgb_eotf(c):
    """Exact piecewise sRGB->linear, as D3D samplers apply to *_SRGB SRVs."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


def luminance(rgb):
    """Rec.709 luma (global.hlsli:140-143)."""
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


# ---------------------------------------------------------------------------
# Octahedral normals (global.hlsli:100-138)
# ---------------------------------------------------------------------------

def _nz_sign(x):
    return jnp.where(x < 0, -1.0, 1.0)


def encode_octahedron(d):
    s = jnp.abs(d).sum(-1, keepdims=True)
    d = d / s
    xy = d[..., :2]
    folded = _nz_sign(xy) * jnp.stack(
        [1.0 - jnp.abs(d[..., 1]), 1.0 - jnp.abs(d[..., 0])], axis=-1
    )
    xy = jnp.where(d[..., 2:3] < 0, folded, xy)
    return xy * 0.5 + 0.5


def decode_octahedron(uv):
    xy = uv * 2.0 - 1.0
    z = 1.0 - jnp.abs(xy[..., 0]) - jnp.abs(xy[..., 1])
    folded = _nz_sign(xy) * jnp.stack(
        [1.0 - jnp.abs(xy[..., 1]), 1.0 - jnp.abs(xy[..., 0])], axis=-1
    )
    xy = jnp.where((z < 0)[..., None], folded, xy)
    d = jnp.concatenate([xy, z[..., None]], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# BRDF terms (brdf.hlsli)
# ---------------------------------------------------------------------------

def distribution_ggx(n_dot_h, roughness):
    a = roughness * roughness
    t = (n_dot_h * n_dot_h) * (a * a - 1.0) + 1.0
    return a * a / jnp.maximum(PI * t * t, EPSILON)


def fresnel_schlick(n_dot_l, f0):
    return f0 + (1.0 - f0) * jnp.power(jnp.maximum(1.0 - n_dot_l, EPSILON), 5.0)


def geometry_schlick_ggx(n_dot_v, k):
    return n_dot_v / jnp.maximum(n_dot_v * (1.0 - k) + k, EPSILON)


def geometry_smith(n_dot_l, n_dot_v, k):
    return geometry_schlick_ggx(n_dot_v, k) * geometry_schlick_ggx(n_dot_l, k)


def compute_f0(albedo, metallic):
    return 0.04 * (1.0 - metallic) + albedo * metallic


def brdf(albedo, metallic, roughness, normal, view_dir, light_dir):
    """Cook-Torrance GGX (brdf.hlsli:47-67). All inputs broadcastable, unit
    vectors in the last axis; returns (..., 3)."""
    half = light_dir + view_dir
    half = half / jnp.maximum(jnp.linalg.norm(half, axis=-1, keepdims=True), EPSILON)
    n_dot_l = jnp.maximum((normal * light_dir).sum(-1), 0.0)
    n_dot_v = jnp.maximum((normal * view_dir).sum(-1), 0.0)
    n_dot_h = jnp.maximum((normal * half).sum(-1), 0.0)

    metallic = jnp.asarray(metallic)
    f0 = compute_f0(albedo, metallic[..., None])
    f = fresnel_schlick(n_dot_l[..., None], f0)
    d = distribution_ggx(n_dot_h, roughness)
    k = (roughness + 1.0) ** 2 / 8.0
    g = geometry_smith(n_dot_l, n_dot_v, k)
    ks = f
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    spec = ks * (d * g / jnp.maximum(4.0 * n_dot_l * n_dot_v, 1e-4))[..., None]
    return kd * albedo * INV_PI + spec


# ---------------------------------------------------------------------------
# Sampling sequences (brdf.hlsli:70-113)
# ---------------------------------------------------------------------------

def frustum_cull_aabbs(planes, mins, maxs):
    """Device twin of utils.mathlib.frustum_cull_aabbs (Scene::CullModel /
    LooseOctree traversal analog, vectorized): (N,) bool mask from (6, 4)
    inward-facing planes and (N, 3) world AABB corners. Same p-vertex
    selection and op order as the host version so masks agree bit-for-bit
    in fp32 — per-frame culling runs ON DEVICE (the host stays out of the
    frame loop; only the camera pack is uploaded per frame)."""
    n = planes[:, :3]                                     # (6, 3)
    d = planes[:, 3]
    p = jnp.where(n[None, :, :] > 0, maxs[:, None, :], mins[:, None, :])
    dist = (p * n[None, :, :]).sum(-1) + d[None, :]       # (N, 6)
    return jnp.all(dist >= 0, axis=1)


def hammersley(n: int) -> np.ndarray:
    """(n, 2) Hammersley points — computed host-side (static), fed as consts."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)) & 0xFFFFFFFF
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)) & 0xFFFFFFFF
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)) & 0xFFFFFFFF
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)) & 0xFFFFFFFF
    return np.stack([i / n, bits * 2.3283064365386963e-10], axis=-1).astype(np.float32)


def ggx_importance_sample(roughness, normal, xi):
    """Microfacet half-vector for uniform xi (brdf.hlsli:70-97).

    normal: (..., 3); xi: broadcastable (..., 2); roughness scalar/broadcast.
    """
    a = roughness * roughness
    phi = 2.0 * PI * xi[..., 0]
    cos_theta = jnp.sqrt((1.0 - xi[..., 1]) / (1.0 + (a * a - 1.0) * xi[..., 1]))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    h = jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], -1)

    up = jnp.where(
        (jnp.abs(normal[..., 2:3]) < 0.999),
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), normal.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), normal.shape),
    )
    tangent = jnp.cross(normal, up)
    tangent = tangent / jnp.maximum(jnp.linalg.norm(tangent, axis=-1, keepdims=True), EPSILON)
    bitangent = jnp.cross(normal, tangent)
    world = (
        tangent * h[..., 0:1] + bitangent * h[..., 1:2] + normal * h[..., 2:3]
    )
    return world / jnp.maximum(jnp.linalg.norm(world, axis=-1, keepdims=True), EPSILON)


# ---------------------------------------------------------------------------
# Cubemap addressing (env_map_gen.hlsl:18-44 / MathLib.cpp:73-136)
# ---------------------------------------------------------------------------

def cubemap_face_dirs(size: int) -> np.ndarray:
    """(6, size, size, 3) unit directions of texel centers (numpy, host)."""
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    one = np.ones_like(u)
    faces = np.stack(
        [
            np.stack([one, -v, -u], -1),
            np.stack([-one, -v, u], -1),
            np.stack([u, one, v], -1),
            np.stack([u, -one, -v], -1),
            np.stack([u, -v, one], -1),
            np.stack([-u, -v, -one], -1),
        ]
    )
    return (faces / np.linalg.norm(faces, axis=-1, keepdims=True)).astype(np.float32)


def cubemap_coords(dirs):
    """(..., 3) directions -> (face_idx int32, u, v in [0,1]) — branchless
    vectorized CalcCubeMapCoordinate."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    # D3D tie-break: x wins strict, then y strict, else z.
    is_x = (ax > ay) & (ax > az)
    is_y = (~is_x) & (ay > ax) & (ay > az)
    is_z = ~(is_x | is_y)

    inv = 1.0 / jnp.maximum(jnp.where(is_x, ax, jnp.where(is_y, ay, az)), EPSILON)
    face = jnp.where(
        is_x,
        jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    ).astype(jnp.int32)

    u = jnp.where(
        is_x,
        jnp.where(x > 0, -z, z) * inv,
        jnp.where(is_y, x * inv, jnp.where(z > 0, x, -x) * inv),
    )
    v = jnp.where(
        is_x,
        -y * inv,
        jnp.where(is_y, jnp.where(y > 0, z, -z) * inv, -y * inv),
    )
    return face, (u + 1.0) * 0.5, (v + 1.0) * 0.5


def sample_cubemap_bilinear(faces, dirs):
    """Bilinear cubemap fetch. faces: (6, s, s, c); dirs: (..., 3) -> (..., c).

    Per-face clamped filtering (no cross-face seam blending); the reference
    GPU path is seamless, the difference is sub-LSB except on exact edges.
    """
    size = faces.shape[1]
    face, u, v = cubemap_coords(dirs)
    x = u * size - 0.5
    y = v * size - 0.5
    x0 = jnp.clip(jnp.floor(x), 0, size - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, size - 1).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, size - 1)
    y1 = jnp.minimum(y0 + 1, size - 1)
    fx = jnp.clip(x - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(y - y0, 0.0, 1.0)[..., None]

    flat = faces.reshape(6 * size * size, faces.shape[-1])
    base = face * (size * size)

    def fetch(yy, xx):
        return flat[base + yy * size + xx]

    c00 = fetch(y0, x0)
    c01 = fetch(y0, x1)
    c10 = fetch(y1, x0)
    c11 = fetch(y1, x1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


class CubeMipAtlas:
    """Cubemap mip chain flattened into one (N, 4, C) quad-record array +
    static offsets: each record holds a texel's clamp-addressed 2x2 bilinear
    neighborhood, so a trilinear sample costs TWO computed-index gathers
    (one per mip) instead of 8, and a bilinear sample costs one."""

    def __init__(self, mip_faces):
        import numpy as _np

        self.sizes = tuple(int(m.shape[1]) for m in mip_faces)
        offs = []
        cur = 0
        quads = []
        for m in mip_faces:
            offs.append(cur)
            cur += 6 * m.shape[1] * m.shape[2]
            a = _np.asarray(m)
            right = a[:, :, _np.minimum(_np.arange(a.shape[2]) + 1, a.shape[2] - 1)]
            down = a[:, _np.minimum(_np.arange(a.shape[1]) + 1, a.shape[1] - 1)]
            diag = right[:, _np.minimum(_np.arange(a.shape[1]) + 1, a.shape[1] - 1)]
            quads.append(
                _np.stack([a, right, down, diag], axis=3).reshape(-1, 4, a.shape[-1])
            )
        self.offsets = jnp.asarray(_np.asarray(offs, _np.int32))
        self.sizes_arr = jnp.asarray(_np.asarray(self.sizes, _np.int32))
        self.flat = jnp.asarray(_np.concatenate(quads, axis=0))
        self.n_mips = len(mip_faces)

    def tree_flatten(self):
        return (self.offsets, self.sizes_arr, self.flat), (self.sizes, self.n_mips)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.offsets, obj.sizes_arr, obj.flat = children
        obj.sizes, obj.n_mips = aux
        return obj


jax.tree_util.register_pytree_node(
    CubeMipAtlas,
    lambda a: a.tree_flatten(),
    CubeMipAtlas.tree_unflatten,
)


def _cube_atlas_bilinear(atlas: CubeMipAtlas, dirs, mip):
    """Bilinear fetch at integer mip (traced): ONE quad-record gather."""
    face, u, v = cubemap_coords(dirs)
    size = atlas.sizes_arr[mip]
    off = atlas.offsets[mip]
    x = u * size - 0.5
    y = v * size - 0.5
    x0 = jnp.clip(jnp.floor(x), 0, size - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, size - 1).astype(jnp.int32)
    fx = jnp.clip(x - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(y - y0, 0.0, 1.0)[..., None]

    quad = atlas.flat[off + face * size * size + y0 * size + x0]  # (..., 4, C)
    c00, c01, c10, c11 = quad[..., 0, :], quad[..., 1, :], quad[..., 2, :], quad[..., 3, :]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_cube_atlas_trilinear(atlas: CubeMipAtlas, dirs, mip_level):
    lvl = jnp.clip(mip_level, 0.0, atlas.n_mips - 1.0)
    lo = jnp.floor(lvl).astype(jnp.int32)
    frac = (lvl - lo)[..., None]
    c0 = _cube_atlas_bilinear(atlas, dirs, lo)
    c1 = _cube_atlas_bilinear(atlas, dirs, jnp.minimum(lo + 1, atlas.n_mips - 1))
    return c0 * (1 - frac) + c1 * frac


def sample_cubemap_trilinear(mip_faces: list, dirs, mip_level):
    """Trilinear: bilinear on floor/ceil mips, lerped. `mip_faces` is a list
    of (6, s_m, s_m, c) arrays; mip_level broadcastable over dirs[:-1]."""
    n_mips = len(mip_faces)
    lvl = jnp.clip(mip_level, 0.0, n_mips - 1.0)
    lo = jnp.floor(lvl).astype(jnp.int32)
    frac = (lvl - lo)[..., None]

    # static unroll over mips, select per-sample (mip count is tiny)
    out_lo = jnp.zeros(dirs.shape[:-1] + (mip_faces[0].shape[-1],), mip_faces[0].dtype)
    out_hi = out_lo
    for m in range(n_mips):
        s = sample_cubemap_bilinear(mip_faces[m], dirs)
        out_lo = jnp.where((lo == m)[..., None], s, out_lo)
        out_hi = jnp.where((jnp.minimum(lo + 1, n_mips - 1) == m)[..., None], s, out_hi)
    return out_lo * (1 - frac) + out_hi * frac


def make_quad_tex2d(tex):
    """(h, w, c) -> (h*w, 4, c) clamp-addressed quad records (one gather per
    bilinear tap; see CubeMipAtlas)."""
    a = jnp.asarray(tex)
    h, w = a.shape[0], a.shape[1]
    right = a[:, jnp.minimum(jnp.arange(w) + 1, w - 1)]
    down = a[jnp.minimum(jnp.arange(h) + 1, h - 1)]
    diag = right[jnp.minimum(jnp.arange(h) + 1, h - 1)]
    return jnp.stack([a, right, down, diag], axis=2).reshape(h * w, 4, a.shape[-1])


def sample_quad_tex2d(quad, h: int, w: int, u, v):
    """Bilinear clamp sample from make_quad_tex2d records."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.clip(jnp.floor(x), 0, w - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, h - 1).astype(jnp.int32)
    fx = jnp.clip(x - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(y - y0, 0.0, 1.0)[..., None]
    q = quad[y0 * w + x0]  # (..., 4, c)
    return (
        q[..., 0, :] * (1 - fx) * (1 - fy)
        + q[..., 1, :] * fx * (1 - fy)
        + q[..., 2, :] * (1 - fx) * fy
        + q[..., 3, :] * fx * fy
    )


def sample_texture2d_bilinear(tex, u, v, wrap: bool = True):
    """(h, w, c) bilinear sample at uv; wrap or clamp addressing."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    if wrap:
        x0 = jnp.mod(x0, w)
        y0 = jnp.mod(y0, h)
        x1 = jnp.mod(x0 + 1, w)
        y1 = jnp.mod(y0 + 1, h)
    else:
        x0 = jnp.clip(x0, 0, w - 1)
        y0 = jnp.clip(y0, 0, h - 1)
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
    flat = tex.reshape(h * w, tex.shape[-1])
    c00 = flat[y0 * w + x0]
    c01 = flat[y0 * w + x1]
    c10 = flat[y1 * w + x0]
    c11 = flat[y1 * w + x1]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )
