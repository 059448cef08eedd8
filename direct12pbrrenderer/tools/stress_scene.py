"""Sponza-class synthetic scene: a displaced, textured terrain grid.

The reference's north-star scene class is ~260k triangles (BASELINE.json);
the shipped asset tree tops out at ~65k. This generator builds an in-memory
scene of that scale through the normal resource/scene layers — a (cells_x x
cells_y) height-displaced grid (2 triangles per cell) with a procedural
albedo texture and a ring of point lights — for the scale bench and tests.
"""

from __future__ import annotations

import numpy as np

from ..resource.formats import ETextureFormat
from ..resource.resources import (
    MaterialResource,
    MeshResource,
    ModelResource,
    TextureResource,
)
from ..resource.storage import (
    EVertexFormat,
    MeshData,
    STANDARD_VERTEX_DTYPE,
    TextureData,
)
from ..scene.scene import Scene, SceneLight, SceneModel


def terrain_mesh(cells_x: int = 512, cells_y: int = 256, size: float = 40.0,
                 height: float = 1.5, seed: int = 3) -> MeshData:
    """(cells_x * cells_y * 2) triangles of rolling, normal-mapped terrain."""
    rng = np.random.default_rng(seed)
    nx, ny = cells_x + 1, cells_y + 1
    xs = np.linspace(-size / 2, size / 2, nx, dtype=np.float32)
    zs = np.linspace(-size / 2, size / 2, ny, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="xy")
    # a few random sine octaves: smooth, deterministic displacement
    y = np.zeros_like(x)
    for _ in range(4):
        fx, fz = rng.uniform(0.2, 1.2, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        y += rng.uniform(0.2, 0.5) * np.sin(x * fx + ph[0]) * np.cos(z * fz + ph[1])
    y *= height / 2

    # analytic-ish normals from central differences
    dx = np.gradient(y, axis=1) / (xs[1] - xs[0])
    dz = np.gradient(y, axis=0) / (zs[1] - zs[0])
    n = np.stack([-dx, np.ones_like(y), -dz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    verts = np.zeros(nx * ny, dtype=STANDARD_VERTEX_DTYPE)
    verts["position"] = np.stack([x, y, z], -1).reshape(-1, 3)
    verts["normal"] = n.reshape(-1, 3)
    verts["tangent"] = np.broadcast_to(
        np.array([1, 0, 0], np.float32), (nx * ny, 3))
    verts["color"] = 1.0
    u, v = np.meshgrid(
        np.linspace(0, 8, nx, dtype=np.float32),
        np.linspace(0, 8, ny, dtype=np.float32), indexing="xy")
    verts["uv"] = np.stack([u, v], -1).reshape(-1, 2)

    c = np.arange(cells_x, dtype=np.uint32)
    r = np.arange(cells_y, dtype=np.uint32)[:, None]
    i00 = (r * nx + c).ravel()
    i01 = i00 + 1
    i10 = i00 + nx
    i11 = i10 + 1
    # CCW-in-D3D winding consistent with default_meshes (front = det > 0)
    tris = np.stack([i00, i10, i11, i00, i11, i01], -1).reshape(-1)
    return MeshData.from_arrays(
        EVertexFormat.P3F_N3F_T3F_C3F_T2F, verts, tris.astype(np.uint32),
        None,
        (float(xs[0]), float(y.min()), float(zs[0])),
        (float(xs[-1]), float(y.max()), float(zs[-1])),
    )


def _checker_texture(size: int = 256, seed: int = 5) -> TextureResource:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    checker = (((xx // 16) ^ (yy // 16)) & 1).astype(np.float32)
    base = np.stack([
        0.45 + 0.25 * checker,
        0.40 + 0.10 * checker,
        0.30 + 0.05 * checker,
    ], -1)
    noise = rng.random((size, size, 1), np.float32) * 0.1
    rgba = np.concatenate([np.clip(base + noise, 0, 1), np.ones_like(noise)], -1)
    tex = TextureResource("mem/terrain_albedo")
    tex.texture = TextureData.from_array(
        (rgba * 255).astype(np.uint8), ETextureFormat.R8G8B8A8_UNORM_SRGB
    )
    return tex


def build_stress_scene(cells_x: int = 512, cells_y: int = 256,
                       n_lights: int = 8) -> Scene:
    mesh_res = MeshResource("mem/terrain", "mem/terrain_data")
    mesh_res.mesh = terrain_mesh(cells_x, cells_y)

    mat = MaterialResource("mem/terrain_mat")
    mat.set_shader("gbuffer.hlsl")
    mat.set_parameter("Albedo", np.array([1.0, 1.0, 1.0], np.float32))
    mat.set_parameter("Roughness", 0.7)
    mat.set_parameter("Metallic", 0.05)
    mat.set_texture("AlbedoMap", _checker_texture())
    model = ModelResource("mem/terrain_model", mesh_res, [mat])

    scene = Scene("mem/stress_scene")
    sm = SceneModel("terrain")
    sm.set_model(model)
    sm.translation = np.array([0, 0, 0], np.float32)
    sm.update_transform()
    sm.local_bound_min, sm.local_bound_max = model.bound
    scene.add_model(sm)

    if n_lights > 64:
        # 1024-light operating point (DeferredPipeline.h:326-330): small
        # scattered lights on a jittered grid over the terrain, the workload
        # clustered shading is designed for (each cluster sees a handful,
        # <=32 cap rarely binds)
        rng = np.random.default_rng(11)
        side = int(np.ceil(np.sqrt(n_lights)))
        for i in range(n_lights):
            gx, gy = i % side, i // side
            px = (gx + rng.uniform(0.2, 0.8)) / side * 36.0 - 18.0
            pz = (gy + rng.uniform(0.2, 0.8)) / side * 36.0 - 18.0
            light = SceneLight(f"grid{i}")
            light.translation = np.array(
                [px, rng.uniform(0.5, 2.0), pz], np.float32)
            light.update_transform()
            light.color = rng.uniform(0.3, 1.0, 3).astype(np.float32)
            light.set_intensity(3.0)
            light.set_radius(0.6)
            scene.add_light(light)
        return scene
    for i in range(n_lights):
        a = 2 * np.pi * i / n_lights
        light = SceneLight(f"ring{i}")
        light.translation = np.array(
            [10 * np.cos(a), 2.5, 10 * np.sin(a)], np.float32)
        light.update_transform()
        light.color = np.array(
            [0.5 + 0.5 * np.cos(a), 0.6, 0.5 + 0.5 * np.sin(a)], np.float32)
        light.set_intensity(25.0)
        light.set_radius(3.0)
        scene.add_light(light)
    return scene


# The bench pose of both stress scenes: above the terrain's near edge,
# turned to face it and pitched down.
BENCH_POSITION = (0.0, 6.0, 18.0)
BENCH_ROTATION = (0.0, np.pi, 0.35)


def bench_pipeline(name: str, width: int = 1920, height: int = 1080, *,
                   cells: tuple | None = None, sky_size: int = 512,
                   **pipeline_kw):
    """(pipeline, camera) for one of the two repository-built bench scenes,
    each lit by the in-memory procedural sky (full IBL precompute):

    * "sponza_class": the 262,144-triangle terrain (cells 512 x 256) with
      the 8-light ring, bin_cap 8192;
    * "lights1k": the 128 x 64-cell terrain with 1024 scattered point
      lights, max_active_lights 1024.

    `cells` shrinks the terrain and `sky_size` the sky for small runs;
    `pipeline_kw` goes to DeferredRenderPipeline (route, tiles, ...)."""
    from ..app.console import procedural_sky
    from ..config import RenderConfig
    from ..pipeline.deferred import DeferredRenderPipeline
    from ..scene.camera import Camera

    if name == "sponza_class":
        cx, cy = cells or (512, 256)
        scene = build_stress_scene(cx, cy)
        cfg = RenderConfig(width=width, height=height, max_instances=2)
        kw = {"bin_cap": 8192}
    elif name == "lights1k":
        cx, cy = cells or (128, 64)
        scene = build_stress_scene(cx, cy, n_lights=1024)
        cfg = RenderConfig(width=width, height=height, max_instances=2,
                           max_lights=1024)
        kw = {"bin_cap": 2048, "max_active_lights": 1024}
    else:
        raise ValueError(f"unknown bench scene {name!r}")
    scene.skybox = procedural_sky(sky_size)
    kw.update(atlas_max_dim=256)
    kw.update(pipeline_kw)
    pipe = DeferredRenderPipeline(scene, cfg, **kw)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move(list(BENCH_POSITION))
    cam.rotate(*BENCH_ROTATION)
    return pipe, cam


def yaw_path(cam, n: int, step: float = 0.002):
    """n poses stepping `step` rad of yaw from `cam` (a real animation:
    every frame re-culls and re-bins)."""
    import copy

    cams, c = [], copy.deepcopy(cam)
    for _ in range(n):
        c = copy.deepcopy(c)
        c.rotate(0.0, step, 0.0)
        cams.append(c)
    return cams
