"""FULL-FRAME scalar ground truth (VERDICT r4 #5).

One tiny frame — 64x48, three spheres, two point lights, an HDR sky —
computed twice:

* by the pipeline (`DeferredRenderPipeline.render`), and
* by a float64 numpy transcription in literal HLSL order:
  gbuffer.hlsl ps_main (+ RT quantization) -> clustered.hlsli /
  clustered_culling.hlsl -> deferred_shading.hlsl ps_main ->
  skybox.hlsl -> bloom_prefilter/blur/upsample (BloomPass::Execute order)
  -> hdr_luminance_histogram / hdr_average_histogram (the literal 256-bin
  histogram, not the pipeline's algebraic short-cut) -> hdr_tone_mapping.

The two share exactly ONE device artifact: the rasterizer's pixel->triangle
decision (tri_id), which stands in for D3D12's fixed-function rasterizer —
everything downstream of the vertex data is recomputed scalar from the raw
scene. This closes the self-golden circularity: a systematic error shared by
the pipeline's XLA and Pallas paths would still diverge from this
transcription. Per-pixel/per-pass transcriptions live in
tests/test_*_transcription.py; this pins their COMPOSITION.

Known deviations carried over from the rebuild (documented in README):
per-face-clamp cube filtering (no seamless edges) and fp32 edge-function
rasterization; the transcription mirrors the cube-face convention so the
comparison isolates everything else.
"""

import math

import numpy as np
import jax.numpy as jnp

from direct12pbrrenderer.config import (
    BLOOM_KNEE,
    BLOOM_STEPS,
    BLOOM_THRESHOLD,
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    CULLING_RADIUS_COEFFICIENT,
    EXPOSURE_SMOOTH_TIME,
    GAUSS_WEIGHTS,
    INV_LOG_LUMINANCE_RANGE,
    LOG_LUMINANCE_RANGE,
    MAX_LIGHTS_PER_CLUSTER,
    MIN_LOG_LUMINANCE,
    NUM_HISTOGRAM_BINS,
    PREFILTER_ENVMAP_MIP_LEVELS,
    RenderConfig,
)
from direct12pbrrenderer.resource import reflection_def  # noqa: F401
from direct12pbrrenderer.resource.default_meshes import sphere_mesh
from direct12pbrrenderer.resource.resources import (
    CubeMapResource,
    MaterialResource,
    MeshResource,
    ModelResource,
)
from direct12pbrrenderer.scene.camera import Camera
from direct12pbrrenderer.scene.scene import Scene, SceneLight, SceneModel

from test_env_isolation import _sky_cube
from test_shading_transcription import (  # scalar HLSL pieces (pinned there)
    brdf,
    compute_f0,
    decode_octahedron,
)

EPSILON = 1e-6
W, H = 64, 48
FRAME_DT = 0.25


# ----------------------------------------------------- scene (raw, untextured)
def _scene():
    scene = Scene("mem/frame_tx")
    mats = [
        ((0.8, 0.3, 0.2), 0.2, 1.0, 0.0),
        ((0.2, 0.7, 0.3), 0.5, 0.0, 0.0),
        ((0.6, 0.6, 0.9), 0.85, 0.4, 0.3),  # also emissive
    ]
    for i, (alb, rough, metal, emis) in enumerate(mats):
        mesh_res = MeshResource(f"mem/s{i}", f"mem/s{i}_data")
        mesh_res.mesh = sphere_mesh(0.8, 14, 10)
        mat = MaterialResource(f"mem/m{i}")
        mat.set_shader("gbuffer.hlsl")
        mat.set_parameter("Albedo", np.array(alb, np.float32))
        mat.set_parameter("Roughness", rough)
        mat.set_parameter("Metallic", metal)
        if emis:
            mat.set_parameter("Emission", emis)
        model = ModelResource(f"mem/model{i}", mesh_res, [mat])
        sm = SceneModel(f"ball{i}")
        sm.set_model(model)
        sm.translation = np.array([(i - 1) * 1.7, 0.0, (i - 1) * 0.6],
                                  np.float32)
        sm.update_transform()
        sm.local_bound_min, sm.local_bound_max = model.bound
        scene.add_model(sm)
    for j, (pos, col, inten) in enumerate([
        ((2.5, 2.0, -2.5), (1.0, 0.9, 0.8), 14.0),
        ((-2.5, 1.0, -1.5), (0.4, 0.5, 1.0), 9.0),
    ]):
        light = SceneLight(f"l{j}")
        light.translation = np.array(pos, np.float32)
        light.update_transform()
        light.color = np.array(col, np.float32)
        light.set_intensity(inten)
        light.set_radius(1.5)
        scene.add_light(light)
    sky_res = CubeMapResource("mem/sky")
    sky_res.cubemap = _sky_cube(16)
    scene.set_skybox(sky_res)
    return scene


# --------------------------------------------- scalar texture units (float64)
def cube_face_uv(d):
    """D3D cubemap face selection + face uv (the convention the asset
    pipeline stores faces in: +X,-X,+Y,-Y,+Z,-Z)."""
    ax, ay, az = abs(d[0]), abs(d[1]), abs(d[2])
    if ax >= ay and ax >= az:
        if d[0] > 0:
            f, u, v = 0, -d[2] / ax, -d[1] / ax
        else:
            f, u, v = 1, d[2] / ax, -d[1] / ax
    elif ay >= az:
        if d[1] > 0:
            f, u, v = 2, d[0] / ay, d[2] / ay
        else:
            f, u, v = 3, d[0] / ay, -d[2] / ay
    else:
        if d[2] > 0:
            f, u, v = 4, d[0] / az, -d[1] / az
        else:
            f, u, v = 5, -d[0] / az, -d[1] / az
    return f, (u + 1.0) * 0.5, (v + 1.0) * 0.5


def bilinear_clamp(img, u, v):
    """LinearClamp bilinear fetch on one face/2D texture (f64)."""
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = int(np.clip(math.floor(x), 0, w - 1))
    y0 = int(np.clip(math.floor(y), 0, h - 1))
    x1 = min(x0 + 1, w - 1)
    y1 = min(y0 + 1, h - 1)
    fx = np.clip(x - x0, 0.0, 1.0)
    fy = np.clip(y - y0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def cube_sample(faces, d):
    """Per-face-clamp bilinear cube sample (documented rebuild deviation
    from seamless hardware filtering)."""
    f, u, v = cube_face_uv(d)
    return bilinear_clamp(faces[f], u, v)


def cube_sample_trilinear(mip_faces, d, lvl):
    lo = int(np.clip(math.floor(lvl), 0, len(mip_faces) - 1))
    hi = min(lo + 1, len(mip_faces) - 1)
    f = lvl - lo
    return cube_sample(mip_faces[lo], d) * (1 - f) + cube_sample(
        mip_faces[hi], d) * f


# ------------------------------------------------ scalar per-pixel shaders
def quantize8(x):
    return np.round(np.clip(np.asarray(x, np.float64), 0.0, 1.0) * 255.0) / 255.0


def gbuffer_ps(albedo_c, emission_c, rough_c, metal_c, normal_ws):
    """gbuffer.hlsl:88-148 for an unmapped material + RT quantization."""
    albedo = np.maximum(np.asarray(albedo_c, np.float64), 0.0) ** 2.2
    n = normal_ws / np.linalg.norm(normal_ws)
    # pack_normal = encode_octahedron (global.hlsli:117-128)
    d = n / (abs(n[0]) + abs(n[1]) + abs(n[2]))
    if d[2] < 0:
        sx = 1.0 if d[0] >= 0 else -1.0
        sy = 1.0 if d[1] >= 0 else -1.0
        d = np.array([sx * (1 - abs(d[1])), sy * (1 - abs(d[0])), d[2]])
    oct = np.array([d[0], d[1]]) * 0.5 + 0.5
    gba = quantize8(np.array([*albedo, emission_c]))
    gbb = quantize8(oct)
    gbc = quantize8(np.array([rough_c, metal_c, 0.0]))  # AO unmapped -> 0
    return gba, gbb, gbc


def deferred_ps(uv, gba, gbb, gbc, depth_ndc, sh_pack, prefiltered_mips,
                lut, lights, view, inv_view, camera_pos,
                fov, ratio, near, far):
    """deferred_shading.hlsl ps_main, scalar, with REAL cubemap/LUT taps."""
    albedo = gba[:3]
    emission = gba[3]
    normal_ws = decode_octahedron(gbb)
    roughness, metallic = gbc[0], gbc[1]

    near_h = 2 * near * math.tan(fov / 2)
    near_w = near_h * ratio
    cam = np.array([(uv[0] - 0.5) * near_w, (0.5 - uv[1]) * near_h, near])
    camera_vec = inv_view[:3, :3] @ cam
    z_view = near * far / (far - depth_ndc * (far - near))
    position_ws = camera_pos + camera_vec * z_view / near
    view_ws = camera_pos - position_ws
    view_ws = view_ws / np.linalg.norm(view_ws)

    # SH irradiance (deferred_shading.hlsl:23-54)
    n = normal_ws
    a4 = np.array([n[0], n[1], n[2], 1.0])
    b4 = np.array([n[0] * n[1], n[1] * n[2], n[2] * n[2], n[2] * n[0]])
    c = n[0] * n[0] - n[1] * n[1]
    l0l1 = np.array([sh_pack[0] @ a4, sh_pack[2] @ a4, sh_pack[4] @ a4])
    l2 = np.array([sh_pack[1] @ b4, sh_pack[3] @ b4, sh_pack[5] @ b4])
    l2 = l2 + sh_pack[6, :3] * c
    irradiance = l0l1 + l2
    env_diffuse = albedo * (1 - metallic) / math.pi * irradiance

    # split-sum specular (deferred_shading.hlsl:56-70)
    n_dot_v = max(float(normal_ws @ view_ws), 0.0)
    refl = 2 * (normal_ws @ view_ws) * normal_ws - view_ws
    refl = refl / np.linalg.norm(refl)
    lvl = min(max(roughness * PREFILTER_ENVMAP_MIP_LEVELS, 0.0),
              len(prefiltered_mips) - 1.0)
    env_irradiance = cube_sample_trilinear(prefiltered_mips, refl, lvl)
    env_brdf = bilinear_clamp(lut, roughness, n_dot_v)
    f0 = compute_f0(albedo, metallic)
    env_specular = env_irradiance * (f0 * env_brdf[0] + env_brdf[1])

    # clustered point lights (clustered.hlsli + clustered_culling.hlsl)
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
        cull_r = lp[13]
        pos_view = (view @ np.append(pos_w, 1.0))[:3]
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

    return env_diffuse + env_specular + point_light + albedo * emission


# ------------------------------------------------------- scalar post chain
def np_resize(img, oh, ow, half_phase=True):
    """Bilinear resize, clamp addressing; half_phase=texel-center mapping
    (blur.hlsli offsets), False = uv = xy*texel (bloom_prefilter quirk)."""
    ih, iw = img.shape[:2]
    if half_phase:
        ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
        xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    else:
        ys = np.arange(oh) * ih / oh
        xs = np.arange(ow) * iw / ow
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    r0 = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    r1 = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return r0 * (1 - fy) + r1 * fy


def np_shift(img, dy, dx):
    h, w = img.shape[:2]
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def np_blur_h(img):
    return sum(GAUSS_WEIGHTS[i + 4] * np_shift(img, 0, i) for i in range(-4, 5))


def np_blur_v(img):
    return sum(GAUSS_WEIGHTS[i + 4] * np_shift(img, i, 0) for i in range(-4, 5))


def np_threshold(c):
    brightness = c.max(axis=-1, keepdims=True)
    soft = np.clip(brightness - BLOOM_THRESHOLD + BLOOM_THRESHOLD * BLOOM_KNEE,
                   0.0, 2 * BLOOM_THRESHOLD * BLOOM_KNEE)
    soft = soft * soft / (4 * BLOOM_THRESHOLD * BLOOM_KNEE + 1e-5)
    contribution = np.maximum(soft, brightness - BLOOM_THRESHOLD) / np.maximum(
        brightness, 1e-5)
    return c * contribution


def np_luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def np_bloom(hdr):
    """BloomPass::Execute order (DeferredPipeline.cpp:400-570)."""
    h, w = hdr.shape[:2]

    def mip_size(m):
        return max(1, h >> m), max(1, w >> m)

    # prefilter: half res, 5-tap diagonal cross, luma-weighted
    base = np_resize(hdr, *mip_size(1), half_phase=False)
    total = np.zeros_like(base)
    weight = np.zeros(base.shape[:2] + (1,))
    for dy, dx in [(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]:
        c = np_threshold(np_shift(base, dy, dx))
        wgt = 1.0 / (np_luminance(c)[..., None] + 1.0)
        total = total + c * wgt
        weight = weight + wgt
    a = {1: total / np.maximum(weight, 1e-20)}
    for i in range(BLOOM_STEPS):
        m = i + 1
        a[m + 1] = np_blur_v(np_blur_h(np_resize(a[m], *mip_size(m + 1))))
    for i in range(BLOOM_STEPS - 1, -1, -1):
        m = i + 1
        up = np_blur_h(a[m]) + np_blur_h(np_resize(a[m + 1], *mip_size(m)))
        a[m] = np_blur_v(up)
    full = np_blur_v(np_blur_h(np_resize(a[1], h, w)))
    return hdr + full


def np_exposure(hdr, prev, dt):
    """The literal 256-bin histogram (hdr_luminance_histogram /
    hdr_average_histogram), NOT the pipeline's algebraic form."""
    lum = np_luminance(hdr)
    log_l = np.clip((np.log2(np.maximum(lum, 1e-30)) - MIN_LOG_LUMINANCE)
                    * INV_LOG_LUMINANCE_RANGE, 0.0, 1.0)
    bins = np.floor(log_l * (NUM_HISTOGRAM_BINS - 2) + 1.0).astype(int)
    bins = np.where(lum < EPSILON, 0, bins)
    hist = np.bincount(bins.ravel(), minlength=NUM_HISTOGRAM_BINS)
    weighted = float((hist * np.arange(NUM_HISTOGRAM_BINS)).sum())
    black = float(hist[0])
    avg_bin = weighted / max(lum.size - black, 1.0)
    l_avg = 2.0 ** (((avg_bin - 1.0) / (NUM_HISTOGRAM_BINS - 2))
                    * LOG_LUMINANCE_RANGE + MIN_LOG_LUMINANCE)
    t = min(max(1.0 - math.exp(-dt * EXPOSURE_SMOOTH_TIME), 0.0), 1.0)
    return prev + (l_avg - prev) * t


def np_tonemap(hdr, avg):
    l_max = 9.6 * avg
    x = hdr / (l_max + 0.001)
    aa, bb, cc, dd, ee = 2.51, 0.03, 2.43, 0.59, 0.14
    mapped = np.clip((x * (aa * x + bb)) / (x * (cc * x + dd) + ee), 0.0, 1.0)
    out = np.maximum(mapped, 0.0) ** (1.0 / 2.2)
    return np.round(np.clip(out, 0.0, 1.0) * 255.0)


# ------------------------------------------------------------------- test
def test_full_frame_matches_scalar_transcription():
    from direct12pbrrenderer.pipeline import stages
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline

    scene = _scene()
    cfg = RenderConfig(width=W, height=H, max_triangles=2048,
                       max_vertices=2048, max_instances=4, max_lights=4)
    pipe = DeferredRenderPipeline(
        scene, cfg, tile_h=12, tile_w=64, bin_cap=512,
        # 16px base -> five valid prefiltered mips (16..1); an 8px base
        # would produce an empty level-4 mip
        prefilter_size=16, brdf_lut_size=16,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0.3, 0.6, 4.0])
    cam.rotate(0.0, math.pi, 0.08)
    img_pipe = np.asarray(pipe.render(cam, delta_time=FRAME_DT)).astype(
        np.float64)

    # ---- the one shared artifact: the rasterizer's pixel->triangle pick
    p = pipe.packed
    planes = cam.frustum_planes()
    env = dict(pipe.buffers)
    setup, _ = stages.geometry(
        env, jnp.asarray(p.model_mats),
        jnp.asarray(np.ascontiguousarray(
            np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))),
        jnp.asarray(p.instance_visibility(planes)),
        jnp.asarray(cam.projection_matrix() @ cam.view_matrix()), W, H,
    )
    bins = stages.binning(setup, W, H, 12, 64, 512)
    tri_id, _ = stages.rasterize(setup, bins, W, H, 12, 64, False)
    tri_id = np.asarray(tri_id)[:H, :W]

    # ---- scalar frame ----------------------------------------------------
    fov, ratio, near, far = cfg.fov, cfg.ratio, cfg.near, cfg.far
    view = np.asarray(cam.view_matrix(), np.float64)
    inv_view = np.asarray(cam.world_matrix(), np.float64)
    view_proj = np.asarray(cam.projection_matrix(), np.float64) @ view
    camera_pos = np.asarray(cam.position, np.float64)

    sh_pack = np.asarray(pipe.sh_pack, np.float64)
    prefiltered = [np.asarray(m, np.float64)
                   for m in pipe.prefiltered_mip_faces]
    sky_faces = np.asarray(pipe.skybox_faces_mip0, np.float64)
    lut = np.asarray(pipe.brdf_lut, np.float64)

    light_rows = []
    for j in range(len(p.light_pos)):
        r, kc, kl, kq = p.light_attenuation[j]
        inten = p.light_intensity[j]
        light_rows.append(np.array([
            *p.light_pos[j], *p.light_color[j], inten, kc, kl, kq,
            0, 0, 0,  # pos_view (recomputed in the scalar cull)
            r * CULLING_RADIUS_COEFFICIENT * math.sqrt(max(inten, 0.0)),
        ], np.float64))

    mats = p.materials
    mm = np.asarray(p.model_mats, np.float64)
    imm = np.asarray(p.inv_model_mats, np.float64)
    positions = np.asarray(p.positions, np.float64)
    normals = np.asarray(p.normals, np.float64)
    tris = np.asarray(p.tris)
    tri_mat = np.asarray(p.tri_material)
    tri_inst = np.asarray(p.tri_instance)

    hdr = np.zeros((H, W, 3), np.float64)
    for py in range(H):
        for px in range(W):
            t = int(tri_id[py, px])
            uv = ((px + 0.5) / W, (py + 0.5) / H)
            if t < 0:
                # skybox.hlsl: background samples the cubemap along the ray
                near_h = 2 * near * math.tan(fov / 2)
                near_w = near_h * ratio
                camv = inv_view[:3, :3] @ np.array(
                    [(uv[0] - 0.5) * near_w, (0.5 - uv[1]) * near_h, near])
                ray = camv / np.linalg.norm(camv)
                hdr[py, px] = cube_sample(sky_faces, ray)
                continue
            inst = int(tri_inst[t])
            vid = tris[t]
            m = mm[inst]
            nmat = imm[inst][:3, :3].T  # inverse-transpose
            vw = [m @ np.append(positions[i], 1.0) for i in vid]
            nw = [nmat @ normals[i] for i in vid]
            clip = [view_proj @ v for v in vw]
            # viewport mapping + screen barycentrics at the pixel center
            sp = []
            for v in clip:
                iw_ = 1.0 / v[3]
                sp.append(((v[0] * iw_ * 0.5 + 0.5) * W,
                           (1.0 - (v[1] * iw_ * 0.5 + 0.5)) * H))
            (x0, y0), (x1, y1), (x2, y2) = sp
            qx, qy = px + 0.5, py + 0.5
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            l0 = ((x1 - qx) * (y2 - qy) - (x2 - qx) * (y1 - qy)) / area
            l1 = ((x2 - qx) * (y0 - qy) - (x0 - qx) * (y2 - qy)) / area
            l2 = 1.0 - l0 - l1
            ls = np.array([l0, l1, l2])
            # z_ndc interpolates screen-linearly; attributes w-correct
            zs = np.array([v[2] / v[3] for v in clip])
            depth_ndc = float(ls @ zs)
            pw = ls / np.array([v[3] for v in clip])
            pw = pw / pw.sum()
            normal_in = pw[0] * nw[0] + pw[1] * nw[1] + pw[2] * nw[2]

            mi = int(tri_mat[t])
            gba, gbb, gbc = gbuffer_ps(
                mats.albedo[mi], float(mats.emission[mi]),
                float(mats.roughness[mi]), float(mats.metallic[mi]),
                normal_in,
            )
            hdr[py, px] = deferred_ps(
                uv, gba, gbb, gbc, depth_ndc, sh_pack, prefiltered, lut,
                light_rows, view, inv_view, camera_pos, fov, ratio, near, far,
            )

    out = np_bloom(hdr)
    avg = np_exposure(out, 0.0, FRAME_DT)
    img_scalar = np_tonemap(out, avg)

    # EVERY pixel within 1 LSB of the scalar ground truth (stronger than an
    # rmse bound: a logic error anywhere in the chain moves whole pixels by
    # many LSB; f32-vs-f64 rounding can only flip quantization ties)
    diff_lsb = np.abs(img_scalar - img_pipe).max()
    assert diff_lsb <= 1.0, diff_lsb
    rmse = float(np.sqrt(np.mean((np.abs(img_scalar - img_pipe) / 255.0) ** 2)))
    assert rmse <= 1.5e-3, rmse  # ~9% of pixels sit on a rounding tie
    # exposure state carried identically
    assert abs(float(pipe.avg_luminance) - avg) / max(avg, 1e-9) < 1e-3
