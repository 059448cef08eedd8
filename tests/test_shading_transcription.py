"""Full-pixel scalar transcription of deferred_shading.hlsl.

A literal, line-by-line numpy transcription of the reference pixel shader
(`DeferredRendering/Shader/deferred_shading.hlsl:23-191` ps_main, with
brdf.hlsli, clustered.hlsli / clustered_compute.hlsl / clustered_culling.hlsl
and global.hlsli's unpack_normal), evaluated at ONE pixel and compared
against ops/shading.deferred_shade for the same inputs — the companion to
the existing scalar BRDF-LUT check (tests/test_ibl.py).

Quirks intentionally covered:
* the hardcoded directional light is computed but NEVER added to the output
  (deferred_shading.hlsl:144-156 vs :191) — the transcription computes it
  and excludes it, and would fail if the vectorized path ever added it;
* ambient occlusion is sampled but unused;
* final = env_diffuse + env_specular + point_lights + emission.
"""

import math

import numpy as np
import jax.numpy as jnp

from direct12pbrrenderer.config import (
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    MAX_LIGHTS_PER_CLUSTER,
    PREFILTER_ENVMAP_MIP_LEVELS,
)
from direct12pbrrenderer.ops import common, shading

EPSILON = 1e-6
PI = math.pi
INV_PI = 1.0 / math.pi


# ------------------------------------------------------- HLSL transcription
def decode_octahedron(uv):
    d = np.array([uv[0] * 2 - 1, uv[1] * 2 - 1, 0.0], np.float64)
    d[2] = 1 - abs(d[0]) - abs(d[1])
    if d[2] < 0:
        sx, sy = np.sign(d[0]), np.sign(d[1])
        d[0], d[1] = sx * (1.0 - abs(d[1])), sy * (1.0 - abs(d[0]))
    return d / np.linalg.norm(d)


def compute_f0(albedo, metallic):
    return 0.04 * (1 - metallic) + albedo * metallic  # lerp


def brdf(metallic, roughness, albedo, normal, view_dir, light_dir):
    half = light_dir + view_dir
    half = half / np.linalg.norm(half)
    n_dot_l = max(float(normal @ light_dir), 0.0)
    n_dot_v = max(float(normal @ view_dir), 0.0)
    n_dot_h = max(float(normal @ half), 0.0)
    f0 = compute_f0(albedo, metallic)
    fres = f0 + (1.0 - f0) * max(1 - n_dot_l, EPSILON) ** 5
    a = roughness * roughness
    t = (n_dot_h * n_dot_h) * (a * a - 1.0) + 1.0
    d = a * a / max(PI * t * t, EPSILON)
    k = (roughness + 1) ** 2 / 8
    g1 = n_dot_v / max(n_dot_v * (1.0 - k) + k, EPSILON)
    g2 = n_dot_l / max(n_dot_l * (1.0 - k) + k, EPSILON)
    g = g1 * g2
    ks = fres
    kd = (1 - fres) * (1 - metallic)
    return kd * albedo * INV_PI + ks * d * g / max(4 * n_dot_l * n_dot_v, 1e-4)


def ps_main_transcribed(
    uv, albedo, emission, normal_oct, roughness, metallic, ao, depth_ndc,
    sh_pack, env_mip_colors, lut, lights, view, inv_view, camera_pos,
    fov, ratio, near, far,
):
    """deferred_shading.hlsl ps_main for one pixel, scalar."""
    albedo = np.asarray(albedo, np.float64)
    normal_ws = decode_octahedron(normal_oct)

    # vs_main camera_vec: linear in uv over the fullscreen triangle
    near_h = 2 * near * math.tan(fov / 2)
    near_w = near_h * ratio
    cam = np.array([(uv[0] - 0.5) * near_w, (0.5 - uv[1]) * near_h, near])
    camera_vec = inv_view[:3, :3] @ cam

    # ReconstructWorldPosition
    z_view = near * far / (far - depth_ndc * (far - near))
    position_ws = camera_pos + camera_vec * z_view / near
    view_ws = camera_pos - position_ws
    view_ws = view_ws / np.linalg.norm(view_ws)

    # EnvironmentDiffuse (SH polynomial)
    n = normal_ws
    a4 = np.array([n[0], n[1], n[2], 1.0])
    b4 = np.array([n[0] * n[1], n[1] * n[2], n[2] * n[2], n[2] * n[0]])
    c = n[0] * n[0] - n[1] * n[1]
    l0l1 = np.array([sh_pack[0] @ a4, sh_pack[2] @ a4, sh_pack[4] @ a4])
    l2 = np.array([sh_pack[1] @ b4, sh_pack[3] @ b4, sh_pack[5] @ b4])
    l2 = l2 + sh_pack[6, :3] * c
    irradiance = l0l1 + l2
    kd = albedo * (1 - metallic) * INV_PI
    env_diffuse = kd * irradiance

    # EnvironmentSpecular (split-sum)
    n_dot_v = max(float(normal_ws @ view_ws), 0.0)
    refl = 2 * (normal_ws @ view_ws) * normal_ws - view_ws
    refl = refl / np.linalg.norm(refl)
    lvl = min(max(roughness * PREFILTER_ENVMAP_MIP_LEVELS, 0.0),
              len(env_mip_colors) - 1.0)
    lo = int(math.floor(lvl))
    hi = min(lo + 1, len(env_mip_colors) - 1)
    env_irradiance = (
        env_mip_colors[lo] * (1 - (lvl - lo)) + env_mip_colors[hi] * (lvl - lo)
    )
    # PrecomputeBRDF.Sample(SamplerLinearClamp, (roughness, NdotV)) bilinear
    s = lut.shape[0]
    x = roughness * s - 0.5
    y = n_dot_v * s - 0.5
    x0 = int(np.clip(math.floor(x), 0, s - 1))
    y0 = int(np.clip(math.floor(y), 0, s - 1))
    x1 = min(x0 + 1, s - 1)
    y1 = min(y0 + 1, s - 1)
    fx = np.clip(x - x0, 0, 1)
    fy = np.clip(y - y0, 0, 1)
    env_brdf = (
        lut[y0, x0] * (1 - fx) * (1 - fy) + lut[y0, x1] * fx * (1 - fy)
        + lut[y1, x0] * (1 - fx) * fy + lut[y1, x1] * fx * fy
    )
    f0 = compute_f0(albedo, metallic)
    env_specular = env_irradiance * (f0 * env_brdf[0] + env_brdf[1])

    # direct light: COMPUTED BUT NEVER ADDED (reference quirk)
    dl_dir = np.array([1.0, 1.0, 1.0]) / math.sqrt(3)
    direct_luminance = (
        brdf(metallic, roughness, albedo, normal_ws, view_ws, dl_dir)
        * 100.0 * max(float(normal_ws @ dl_dir), 0.0)
    )
    assert direct_luminance is not None  # transcribed, then dropped

    # point lights through the cluster list
    # (clustered_compute.hlsl cluster AABB + clustered_culling.hlsl list)
    sx = int(np.clip(math.floor(uv[0] * CLUSTER_X), 0, CLUSTER_X - 1))
    sy = int(np.clip(math.floor((1 - uv[1]) * CLUSTER_Y), 0, CLUSTER_Y - 1))
    zc = min(max(z_view, near), far)
    sz = int(np.clip(
        math.floor(CLUSTER_Z * math.log(zc / near) / math.log(far / near)),
        0, CLUSTER_Z - 1,
    ))

    tan_half = math.tan(fov / 2)

    def zplane(ndc, vz):
        ray = np.array([ndc[0] * ratio * tan_half, ndc[1] * tan_half, 1.0]) * near
        return ray * (vz / ray[2])

    znear_c = near * (far / near) ** (sz / CLUSTER_Z)
    zfar_c = near * (far / near) ** ((sz + 1) / CLUSTER_Z)
    tile_min = 2 * np.array([sx, sy]) / np.array([CLUSTER_X, CLUSTER_Y]) - 1
    tile_max = 2 * np.array([sx + 1, sy + 1]) / np.array([CLUSTER_X, CLUSTER_Y]) - 1
    corners = [zplane(tile_min, znear_c), zplane(tile_min, zfar_c),
               zplane(tile_max, znear_c), zplane(tile_max, zfar_c)]
    cmin = np.min(corners, axis=0)
    cmax = np.max(corners, axis=0)

    point_light = np.zeros(3)
    count = 0
    for lp in lights:
        pos_w, color, intensity = lp[0:3], lp[3:6], lp[6]
        kc, kl, kq = lp[7], lp[8], lp[9]
        pos_view = (view @ np.append(pos_w, 1.0))[:3]
        cull_r = lp[13]
        closest = np.clip(pos_view, cmin, cmax)
        d2 = float((pos_view - closest) @ (pos_view - closest))
        if d2 < cull_r * cull_r and count < MAX_LIGHTS_PER_CLUSTER:
            count += 1
            ldir = pos_w - position_ws
            dist = np.linalg.norm(ldir)
            ldir = ldir / dist
            n_dot_l = max(float(normal_ws @ ldir), 0.0)
            attenuation = 1.0 / max(kc + kl * dist + kq * dist * dist, EPSILON)
            f = brdf(metallic, roughness, albedo, normal_ws, view_ws, ldir)
            point_light = point_light + f * color * intensity * attenuation * n_dot_l

    emission_luminance = albedo * emission
    del ao  # sampled but unused — reference quirk
    return env_diffuse + env_specular + point_light + emission_luminance


# ------------------------------------------------------------------- test
def test_deferred_shading_full_pixel_transcription():
    rng = np.random.default_rng(17)
    h = w = 8
    px, py = 5, 3
    fov, ratio, near, far = 0.333 * math.pi, w / h, 0.1, 500.0

    # camera: plausible inv_view (yaw+pitch rotation, offset position)
    from direct12pbrrenderer.scene.camera import Camera

    cam = Camera(fov, w, h, near, far)
    cam.move([1.0, 3.0, 8.0])
    cam.rotate(0.0, math.pi * 0.9, 0.1)
    view = np.asarray(cam.view_matrix(), np.float64)
    inv_view = np.asarray(cam.world_matrix(), np.float64)
    camera_pos = np.asarray(cam.position, np.float64)

    albedo = np.array([0.6, 0.35, 0.2])
    emission = 0.25
    normal_oct = np.array([0.31, 0.68])
    roughness, metallic, ao = 0.37, 0.55, 0.8
    depth_ndc = 0.98  # view z ~= 5: a surface a few meters ahead
    sh_pack = rng.normal(size=(7, 4)) * 0.2
    env_mip_colors = [rng.random(3) for _ in range(PREFILTER_ENVMAP_MIP_LEVELS)]
    lut = rng.random((8, 8, 2))

    # two lights: one near the shaded surface point on its normal side,
    # one far outside every cluster
    near_h = 2 * near * math.tan(fov / 2)
    cam_vec = inv_view[:3, :3] @ np.array(
        [(((px + 0.5) / w) - 0.5) * near_h * ratio,
         (0.5 - (py + 0.5) / h) * near_h, near])
    z_view0 = near * far / (far - depth_ndc * (far - near))
    surface_ws = camera_pos + cam_vec * z_view0 / near
    n_ws = decode_octahedron(normal_oct)
    lights = np.zeros((2, 14))
    lights[0] = [*(surface_ws + n_ws * 1.5),
                 1.0, 0.8, 0.6, 30.0, 1.0, 0.09, 0.032, 0, 0, 0, 0]
    lights[1] = [500.0, 500.0, 500.0, 1, 1, 1, 10.0, 1.0, 0.1, 0.01, 0, 0, 0, 0]
    for lp in lights:
        lp[10:13] = (view @ np.append(lp[0:3], 1.0))[:3]
        lp[13] = 1.814 * 2.0 * math.sqrt(lp[6])  # radius 2.0 culling bound

    uv = ((px + 0.5) / w, (py + 0.5) / h)
    want = ps_main_transcribed(
        uv, albedo, emission, normal_oct, roughness, metallic, ao, depth_ndc,
        sh_pack, env_mip_colors, lut, lights, view, inv_view, camera_pos,
        fov, ratio, near, far,
    )

    # vectorized path on a frame filled with this pixel's G-buffer values
    gb_a = jnp.broadcast_to(jnp.asarray([*albedo, emission], jnp.float32), (h, w, 4))
    gb_b = jnp.broadcast_to(jnp.asarray(normal_oct, jnp.float32), (h, w, 2))
    gb_c = jnp.broadcast_to(
        jnp.asarray([roughness, metallic, ao], jnp.float32), (h, w, 3))
    depth = jnp.full((h, w), depth_ndc, jnp.float32)
    mask = jnp.ones((h, w), bool)
    prefiltered = common.CubeMipAtlas([
        jnp.broadcast_to(
            jnp.asarray(c, jnp.float32),
            (6, max(16 >> m, 1), max(16 >> m, 1), 3),
        )
        for m, c in enumerate(env_mip_colors)
    ])
    skybox = common.CubeMipAtlas([jnp.zeros((6, 4, 4, 3), jnp.float32)])
    lut_quad = (common.make_quad_tex2d(jnp.asarray(lut, jnp.float32)), 8)

    out = shading.deferred_shade(
        gb_a, gb_b, gb_c, depth, mask,
        jnp.asarray(sh_pack, jnp.float32), lut_quad, prefiltered, skybox,
        jnp.asarray(lights, jnp.float32),
        jnp.asarray(inv_view, jnp.float32), jnp.asarray(camera_pos, jnp.float32),
        fov, ratio, near, far, w, h,
    )
    got = np.asarray(out)[py, px]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    # sanity: the in-range light actually contributed (the test would pass
    # trivially if both lights were culled)
    out_nolight = shading.deferred_shade(
        gb_a, gb_b, gb_c, depth, mask,
        jnp.asarray(sh_pack, jnp.float32), lut_quad, prefiltered, skybox,
        jnp.zeros((2, 14), jnp.float32),
        jnp.asarray(inv_view, jnp.float32), jnp.asarray(camera_pos, jnp.float32),
        fov, ratio, near, far, w, h,
    )
    assert abs(float(np.asarray(out_nolight)[py, px].sum()) - want.sum()) > 1e-4
