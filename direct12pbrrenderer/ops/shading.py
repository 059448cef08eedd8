"""Deferred shading pass: SH ambient diffuse + split-sum specular + clustered
point lights + emission, plus the deferred skybox.

Mirrors `deferred_shading.hlsl` exactly, including its quirks:
* the hardcoded directional light is *computed but never added* to the final
  sum (deferred_shading.hlsl:144-156 vs :191) — we skip computing it;
* ambient occlusion is read from GBufferC but never applied;
* final = env_diffuse + env_specular + point_lights + emission.

World position is reconstructed from ndc depth + the camera ray through the
pixel (deferred_shading.hlsl:72-121); the stencil sky mask becomes the
coverage mask from the rasterizer, and the skybox pass (skybox.hlsl) reduces
to sampling the cubemap along the view ray wherever no geometry covered the
pixel (the far-plane-scaled sphere passes the depth test exactly there).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import MAX_LIGHTS_PER_CLUSTER, PREFILTER_ENVMAP_MIP_LEVELS
from . import clustered, common


def view_space_depth(ndc_depth, near, far):
    """ndc z [0,1] -> view z [near, far] (deferred_shading.hlsl:76-79)."""
    return near * far / (far - ndc_depth * (far - near))


def camera_rays(width, height, inv_view, fov, ratio, near, y_offset=0,
                full_height=None, full_width=None):
    """Per-pixel world-space camera->near-plane vectors.

    Generalizes the reference's triangle-corner interpolation trick
    (deferred_shading.hlsl:95-121): camera_vec is linear in uv, so evaluate
    it directly per pixel: ((u-0.5)*w, (0.5-v)*h, near) rotated to world.
    (width, height) is the raster canvas; (full_width, full_height) the
    logical viewport the projection maps to — they differ for row-band
    sharding (y_offset/full_height) and for pad-to-tile rendering at
    arbitrary resolutions (padded pixels get u,v beyond [0,1], i.e. rays
    continuing past the frustum edge, and are cropped before present).
    """
    near_h = 2.0 * near * jnp.tan(fov / 2.0)
    near_w = near_h * ratio
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    v, u = jnp.meshgrid(
        (jnp.arange(height, dtype=jnp.float32) + 0.5 + y_offset) / fh,
        (jnp.arange(width, dtype=jnp.float32) + 0.5) / fw,
        indexing="ij",
    )
    cam = jnp.stack(
        [
            (u - 0.5) * near_w,
            (0.5 - v) * near_h,
            jnp.full_like(u, near),
        ],
        -1,
    )
    rot = inv_view[:3, :3]
    return jnp.einsum("ij,hwj->hwi", rot, cam, precision=jax.lax.Precision.HIGHEST)


def pixel_view_geometry(depth, normal, inv_view, camera_pos, width, height,
                        fov, ratio, near, far, y_offset=0, full_height=None,
                        full_width=None):
    """Per-pixel view-space geometry for deferred_shade:
    (position, view_dir, z_view, n_dot_v, refl, ray) from the
    depth buffer + decoded normals (deferred_shading.hlsl:96-110 world-pos
    reconstruction + the split-sum reflection setup)."""
    cam_vec = camera_rays(width, height, inv_view, fov, ratio, near, y_offset,
                          full_height, full_width)
    z_view = view_space_depth(depth, near, far)
    position = camera_pos[None, None, :] + cam_vec * (z_view / near)[..., None]
    view_dir = camera_pos[None, None, :] - position
    view_dir = view_dir / jnp.maximum(
        jnp.linalg.norm(view_dir, axis=-1, keepdims=True), 1e-20
    )
    n_dot_v = jnp.maximum((normal * view_dir).sum(-1), 0.0)
    refl = 2.0 * (normal * view_dir).sum(-1, keepdims=True) * normal - view_dir
    refl = refl / jnp.maximum(
        jnp.linalg.norm(refl, axis=-1, keepdims=True), 1e-20
    )
    ray = cam_vec / jnp.maximum(
        jnp.linalg.norm(cam_vec, axis=-1, keepdims=True), 1e-20
    )
    return position, view_dir, z_view, n_dot_v, refl, ray


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "fov", "ratio", "near", "far",
                     "full_height", "full_width", "light_tile", "light_cap",
                     "interpret"),
)
def deferred_shade(
    gb_albedo_emission,   # (H, W, 4)
    gb_normal_oct,        # (H, W, 2)
    gb_rough_metal_ao,    # (H, W, 3)
    depth,                # (H, W) ndc z
    mask,                 # (H, W) bool coverage
    sh_pack,              # (7, 4) SkyBoxSH
    brdf_lut_quad,        # ((S*S, 4, 2) quad records, S) for the split-sum LUT
    prefiltered,          # common.CubeMipAtlas of the 5 prefiltered mips
    skybox,               # common.CubeMipAtlas (1 mip) for the background
    active_lights,        # (N_active, 14) from clustered.build_active_lights
    inv_view, camera_pos,
    fov, ratio, near, far,
    width: int,
    height: int,
    y_offset=0,
    full_height: int | None = None,
    full_width: int | None = None,
    light_tile: tuple | None = None,   # (tile_h, tile_w): walk per-tile
    # light lists in the tile kernel (ops/lights_pallas) — O(lights per
    # tile) instead of O(N_active) full-frame sweeps; the 1024-light path
    light_cap: int = 256,
    interpret: bool = False,           # light kernel in Pallas interpret mode
):
    albedo = gb_albedo_emission[..., :3]
    emission = gb_albedo_emission[..., 3]
    normal = common.decode_octahedron(gb_normal_oct)
    roughness = gb_rough_metal_ao[..., 0]
    metallic = gb_rough_metal_ao[..., 1]
    # ao = gb_rough_metal_ao[..., 2]  # sampled but unused — reference quirk

    position, view_dir, z_view, n_dot_v, refl, ray = pixel_view_geometry(
        depth, normal, inv_view, camera_pos, width, height, fov, ratio,
        near, far, y_offset, full_height, full_width,
    )

    # --- environment diffuse: SH polynomial (deferred_shading.hlsl:23-54) ---
    n = normal
    a4 = jnp.concatenate([n, jnp.ones_like(n[..., :1])], -1)
    b4 = jnp.stack(
        [n[..., 0] * n[..., 1], n[..., 1] * n[..., 2], n[..., 2] * n[..., 2],
         n[..., 2] * n[..., 0]], -1,
    )
    c1 = n[..., 0] * n[..., 0] - n[..., 1] * n[..., 1]
    hp = jax.lax.Precision.HIGHEST
    l0l1 = jnp.stack(
        [jnp.dot(a4, sh_pack[0], precision=hp), jnp.dot(a4, sh_pack[2], precision=hp),
         jnp.dot(a4, sh_pack[4], precision=hp)], -1)
    l2 = jnp.stack(
        [jnp.dot(b4, sh_pack[1], precision=hp), jnp.dot(b4, sh_pack[3], precision=hp),
         jnp.dot(b4, sh_pack[5], precision=hp)], -1)
    l2 = l2 + sh_pack[6, :3] * c1[..., None]
    irradiance = l0l1 + l2
    kd = albedo * (1.0 - metallic[..., None]) * common.INV_PI
    env_diffuse = kd * irradiance

    # --- environment specular: split-sum (deferred_shading.hlsl:56-70) -----
    env_irr = common.sample_cube_atlas_trilinear(
        prefiltered, refl, roughness * PREFILTER_ENVMAP_MIP_LEVELS
    )[..., :3]
    lut, lut_size = brdf_lut_quad
    env_brdf = common.sample_quad_tex2d(
        lut, lut_size, lut_size, roughness, n_dot_v
    )
    f0 = common.compute_f0(albedo, metallic[..., None])
    env_specular = env_irr * (f0 * env_brdf[..., 0:1] + env_brdf[..., 1:2])

    # --- clustered point lights (deferred_shading.hlsl:158-186) ------------
    # Cluster membership is one (clusters, lights) table; each pixel walks
    # the active lights in index order with a running <32 counter — the same
    # set, order and cap as the reference's per-cluster lists
    # (clustered_culling.hlsl).
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    cid = clustered.pixel_cluster_index(z_view, width, height, fw, fh,
                                        near, far, y_offset)
    hits = clustered.cluster_light_hits(active_lights, fov, ratio, near, far)

    if light_tile is not None:
        from . import lights_pallas

        point_light = lights_pallas.point_lights_tiled(
            active_lights, hits, cid, albedo, normal, roughness, metallic,
            position, view_dir, fov, ratio, near, far, fw, fh,
            tile_h=light_tile[0], tile_w=light_tile[1], y_offset=y_offset,
            cap=light_cap, interpret=interpret,
        )
    else:
        point_light = point_lights_fori(
            active_lights, hits, cid, albedo, normal, roughness, metallic,
            position, view_dir,
        )

    emission_lum = albedo * emission[..., None]
    lit = env_diffuse + env_specular + point_light + emission_lum

    # --- skybox (skybox.hlsl): background pixels sample the cubemap --------
    sky = common._cube_atlas_bilinear(skybox, ray, jnp.int32(0))[..., :3]
    return jnp.where(mask[..., None], lit, sky)


def point_light_contrib(light, albedo, normal, roughness, metallic,
                        position, view_dir):
    """One light's Cook-Torrance radiance at every pixel (before the cluster
    hit mask): deferred_shading.hlsl:168-183. `light` is an active-light row
    (clustered.build_active_lights)."""
    pos_w, color, intensity = light[0:3], light[3:6], light[6]
    kc, kl, kq = light[7], light[8], light[9]
    ldir = pos_w - position
    dist = jnp.linalg.norm(ldir, axis=-1)
    ldir = ldir / jnp.maximum(dist[..., None], 1e-20)
    n_dot_l = jnp.maximum((normal * ldir).sum(-1), 0.0)
    attenuation = 1.0 / jnp.maximum(
        kc + kl * dist + kq * dist * dist, common.EPSILON
    )
    f = common.brdf(albedo, metallic, roughness, normal, view_dir, ldir)
    return f * (color * (intensity * attenuation * n_dot_l)[..., None])


def point_lights_fori(active_lights, hits, cid, albedo, normal, roughness,
                      metallic, position, view_dir):
    """Plain reference for the point-light sum: a fori_loop over the active
    lights, each a full-frame elementwise step. Cost O(N_active) sweeps of
    the frame — fine at the reference scene's 8 lights."""
    # dynamic trip count: padded rows (cull_r = 0) contribute nothing, so we
    # only iterate over lights that are actually present this frame
    n_active = jnp.sum(active_lights[:, 13] > 0.0).astype(jnp.int32)

    def light_step(s, carry):
        acc, counter = carry
        hit = hits[cid, s] & (counter < MAX_LIGHTS_PER_CLUSTER)
        contrib = point_light_contrib(active_lights[s], albedo, normal,
                                      roughness, metallic, position, view_dir)
        acc = acc + jnp.where(hit[..., None], contrib, 0.0)
        return acc, counter + hit.astype(jnp.int32)

    acc, _ = jax.lax.fori_loop(
        0, n_active, light_step,
        (jnp.zeros(cid.shape + (3,), jnp.float32),
         jnp.zeros(cid.shape, jnp.int32)),
    )
    return acc
