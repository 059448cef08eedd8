"""DeferredRenderPipeline: the full frame as one jit-compiled function.

The JAX analog of `DeferredPipeline.{h,cpp}` + `RenderScheduler.cpp`: ten
passes (PreFilterEnvMap, PrecomputeBRDF, Clustered, GBuffer, DeferredShading,
Skybox, Bloom, AutoExposure, ToneMapping, Present) declared against the
render graph, which orders them exactly like FGExecutionParser does from
their read/write sets — including the subtle consequence that AutoExposure
measures the post-bloom image (Bloom re-writes DeferredShadingRT, so every
reader of that RT sorts after it).

The two precompute passes run once and latch (the mReady flag,
DeferredPipeline.cpp:77-136) as cached device arrays. Everything per-frame —
vertex transform, binning, raster, G-buffer shade, clustered light culling,
deferred shading, sky, bloom, exposure, tonemap — traces into a single XLA
program; the average-luminance EMA is threaded as an explicit carry.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    BRDF_LUT_SIZE,
    PREFILTER_ENVMAP_MIP_LEVELS,
    PREFILTER_ENVMAP_SIZE,
    RenderConfig,
)
from ..graph import frame_graph as fg
from ..ops import bloom as bloom_ops
from ..ops import clustered, common, gbuffer, ibl, postprocess
from ..scene.camera import Camera
from ..scene.scene import Scene
from . import stages
from .scene_pack import PackedScene, pack_scene


@dataclass
class FrameStats:
    visible_instances: int
    total_instances: int
    visible_lights: int
    bin_overflow: int = 0
    lights_truncated: int = 0  # visible lights beyond max_active_lights
    light_tile_overflow: int = 0  # per-tile culled lights beyond light_cap


# platform -> kernel route. One explicit choice, no fallback: "gpu" runs the
# Pallas kernels through Triton (ops/raster_pallas, ops/lights_pallas),
# "cpu" the plain XLA path; any other platform is refused.
KERNEL_ROUTES = {"gpu": "triton", "cpu": "xla"}


def default_platform() -> str:
    """Platform of the device new arrays and jits land on (honours a
    `jax.default_device` context)."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def kernel_route(platform: str | None = None) -> str:
    platform = platform or default_platform()
    if platform not in KERNEL_ROUTES:
        raise RuntimeError(
            f"no render path for platform {platform!r}: this renderer runs "
            f"on {sorted(KERNEL_ROUTES)}"
        )
    return KERNEL_ROUTES[platform]


class DeferredRenderPipeline:
    def __init__(
        self,
        scene: Scene,
        config: RenderConfig | None = None,
        tile_h: int = 32,
        tile_w: int = 32,
        bin_cap: int = 2048,
        atlas_max_dim: int | None = 1024,
        prefilter_size: int | None = None,
        brdf_lut_size: int = BRDF_LUT_SIZE,
        texture_filter: str = "trilinear",
        max_active_lights: int = 64,
        light_tile: tuple | None = None,
        light_cap: int | None = None,
        route: str | None = None,
        pallas_interpret: bool = False,
    ):
        self.config = config or RenderConfig()
        cfg = self.config
        # arbitrary resolutions (the reference renders at any window size,
        # App.h:77-78): the raster canvas pads up to the tile grid; padded
        # pixels are off-viewport (u,v beyond [0,1] -> rays past the frustum
        # edge) and the RT is cropped back before the post chain, so bloom /
        # exposure / tonemap see exactly the logical frame
        self.render_w = -(-cfg.width // tile_w) * tile_w
        self.render_h = -(-cfg.height // tile_h) * tile_h
        self.tile_h, self.tile_w, self.bin_cap = tile_h, tile_w, bin_cap
        self.max_active_lights = max_active_lights
        # kernel route: None takes the platform's (KERNEL_ROUTES); "xla"
        # forces the plain path anywhere (the A/B reference on a card).
        # pallas_interpret is a test hook only: it runs the Triton kernels
        # through the Pallas interpreter on the CPU, never on a card.
        platform = default_platform()
        if pallas_interpret:
            if platform == "gpu":
                raise ValueError("pallas_interpret is a CPU test hook; on "
                                 "the GPU the kernels are compiled")
            route = route or "triton"
        self.route = route or kernel_route(platform)
        if self.route not in ("triton", "xla"):
            raise ValueError(f"unknown kernel route {self.route!r}")
        if self.route == "triton" and platform != "gpu" and not pallas_interpret:
            raise RuntimeError(f"the triton route needs a GPU, not {platform!r}")
        self.pallas_interpret = pallas_interpret
        self.use_pallas = self.route == "triton"
        # 1024-light operating point: with many active lights the O(N_active)
        # full-frame fori sweep is the cost; walk per-tile light lists in
        # the tile kernel (ops/lights_pallas) instead, O(lights per tile).
        if light_tile is None and max_active_lights > 64 and self.use_pallas:
            light_tile = (tile_h, tile_w)
        self.light_tile = light_tile
        if light_cap is None:
            light_cap = max(128, -(-min(max_active_lights, 1024) // 128) * 128)
        self.light_cap = light_cap
        self.texture_filter = texture_filter
        self.scene = scene
        self.atlas_max_dim = atlas_max_dim
        self.packed: PackedScene = pack_scene(scene, cfg, atlas_max_dim)
        if self.packed.config is not None:
            # adopt the EFFECTIVE config (pools may have auto-grown, with a
            # warning from pack_scene) so self.config always matches the
            # actual device pool sizes
            self.config = cfg = self.packed.config

        # ---- precompute passes (once, latched) ----------------------------
        self.brdf_lut = ibl.brdf_lut(size=brdf_lut_size)
        from ..ops.common import CubeMipAtlas

        if scene.skybox is not None and scene.skybox.cubemap is not None:
            cube = scene.skybox.cubemap
            base = jnp.asarray(
                np.stack([f.mip_array_rgba(0)[..., :3] for f in cube.faces]).astype(
                    np.float32
                )
            )
            n_src = int(np.log2(base.shape[1])) + 1
            src = ibl.build_cubemap_mips(base, n_src)
            size = prefilter_size or min(PREFILTER_ENVMAP_SIZE, base.shape[1])
            pf = ibl.prefilter_env_map(tuple(src), out_size=size)
            self.prefiltered = CubeMipAtlas(pf)
            self.prefiltered_mip_faces = pf
            self.skybox_mip0 = CubeMipAtlas([base])
            self.skybox_faces_mip0 = base
            self.sh_pack = jnp.asarray(cube.sh.as_array())
        else:
            size = prefilter_size or 64
            zeros = [
                jnp.zeros((6, size >> m, size >> m, 3), jnp.float32)
                for m in range(PREFILTER_ENVMAP_MIP_LEVELS)
            ]
            self.prefiltered = CubeMipAtlas(zeros)
            self.prefiltered_mip_faces = zeros
            self.skybox_mip0 = CubeMipAtlas([jnp.zeros((6, 8, 8, 3), jnp.float32)])
            self.skybox_faces_mip0 = jnp.zeros((6, 8, 8, 3), jnp.float32)
            self.sh_pack = jnp.zeros((7, 4), jnp.float32)

        self.cluster_bounds = jnp.asarray(
            clustered.cluster_bounds(cfg.fov, cfg.ratio, cfg.near, cfg.far)
        )

        # static device buffers
        p = self.packed
        self.buffers = {
            "positions": jnp.asarray(p.positions),
            "normals": jnp.asarray(p.normals),
            "tangents": jnp.asarray(p.tangents),
            "uvs": jnp.asarray(p.uvs),
            "vtx_instance": jnp.asarray(p.vtx_instance),
            "tris": jnp.asarray(p.tris),
            "tri_material": jnp.asarray(p.tri_material),
            "tri_instance": jnp.asarray(p.tri_instance),
            "tri_valid_pool": jnp.asarray(p.tri_valid),
            "mat_rows": jnp.asarray(
                gbuffer.pack_material_rows(
                    p.materials.albedo, p.materials.emission, p.materials.roughness,
                    p.materials.metallic, p.materials.use_map, p.materials.tex_ids,
                )
            ),
            "atlas": gbuffer.AtlasDevice(
                jnp.asarray(p.atlas.data),
                jnp.asarray(p.atlas.page_base),
                jnp.asarray(p.atlas.base_size),
                jnp.asarray(p.atlas.n_mips),
                jnp.asarray(p.atlas.srgb),
            ),
            "light_pos": jnp.asarray(p.light_pos),
            "light_color": jnp.asarray(p.light_color),
            "light_intensity": jnp.asarray(p.light_intensity),
            "light_attenuation": jnp.asarray(p.light_attenuation),
            # precompute products passed as arguments (not jit constants) so
            # they live once in HBM instead of being baked into the executable
            "ClusterBounds": self.cluster_bounds,
            "SkyBoxSH": self.sh_pack,
            "PrecomputeBRDF": (
                common.make_quad_tex2d(self.brdf_lut), self.brdf_lut.shape[0]
            ),
            "PrefilterEnvMap": self.prefiltered,
            "SkyBoxTexture": self.skybox_mip0,
        }

        self.graph = self._build_graph()
        self.avg_luminance = jnp.asarray(0.0, jnp.float32)
        # Donation policy at the jit boundary: the per-call frame's big
        # inputs are all PERSISTENT state reused next call (scene pools in
        # self.buffers, change-tracked scene/camera packs), so only the
        # sequence path — whose camera-pack stack and EMA carry are fresh
        # per dispatch — has donatable arguments. In-frame transient
        # aliasing is the graph's lifetime-driven drops (frame_graph.py),
        # which XLA turns into buffer reuse inside the single jit.
        self._frame_jit = jax.jit(self._frame)
        # donate only the EMA carry: it aliases the returned avg (same
        # shape/dtype); the camera-pack stack has no matching output, so
        # donating it would just emit XLA's unused-donation warning
        self._frame_seq_jit = jax.jit(self._frame_seq, donate_argnums=(3,))
        self.last_stats: FrameStats | None = None
        # upload caches: scene/camera packs are only re-uploaded on change
        self._scene_np = self._scene_dev = None
        self._cam_np = self._cam_dev = None

    # ------------------------------------------------------------------
    def _build_graph(self) -> fg.CompiledGraph:
        cfg = self.config
        w, h = cfg.width, cfg.height          # logical viewport
        rw, rh = self.render_w, self.render_h  # padded raster canvas

        def cull_pass(env):
            # Scene::CullModel / light cull on DEVICE (vectorized AABB vs
            # Gribb-Hartmann planes — the LooseOctree traversal's device-side
            # analog, SURVEY §7): keeps the host out of the frame loop
            p = self.packed
            n_inst, n_lgt = p.instance_count, p.light_count
            i_pool = p.model_mats.shape[0]
            l_pool = p.light_pos.shape[0]
            vis = jnp.zeros((i_pool,), bool)
            if n_inst:
                m = common.frustum_cull_aabbs(
                    env["FrustumPlanes"],
                    env["InstanceBounds"][:n_inst, 0],
                    env["InstanceBounds"][:n_inst, 1],
                )
                vis = vis.at[:n_inst].set(m)
            lv = jnp.zeros((l_pool,), bool)
            if n_lgt:
                m = common.frustum_cull_aabbs(
                    env["FrustumPlanes"],
                    env["LightBounds"][:n_lgt, 0],
                    env["LightBounds"][:n_lgt, 1],
                )
                lv = lv.at[:n_lgt].set(m)
            counts = jnp.stack([vis.sum(dtype=jnp.int32),
                                lv.sum(dtype=jnp.int32)])
            return {"InstanceVisible": vis, "LightValid": lv,
                    "VisibleCounts": counts}

        def clustered_pass(env):
            active = stages.active_lights(
                env, env["LightValid"], env["View"], self.max_active_lights
            )
            return {"FrustumCluster": (env["ClusterBounds"], active),
                    "PointLights": active[:, 13] > 0}

        def gbuffer_pass(env):
            setup, vattrs = stages.geometry(
                env, env["ModelMats"], env["NormalMats"],
                env["InstanceVisible"], env["ViewProj"], w, h,
            )
            bins = stages.binning(
                setup, rw, rh, self.tile_h, self.tile_w, self.bin_cap
            )
            tri_id, depth = stages.rasterize(
                setup, bins, rw, rh, self.tile_h, self.tile_w, self.use_pallas,
                pallas_interpret=self.pallas_interpret,
            )
            gb = stages.gbuffer_shade(
                tri_id, depth, setup, env, vattrs, rw, rh,
                texture_filter=self.texture_filter,
            )
            return {
                "GBufferA": gb.albedo_emission,
                "GBufferB": gb.normal_oct,
                "GBufferC": gb.rough_metal_ao,
                "GBufferDepthStencil": (gb.depth, gb.mask),
                "BinCounts": bins.counts,
            }

        def deferred_pass(env):
            depth, mask = env["GBufferDepthStencil"]
            _bounds_t, active = env["FrustumCluster"]
            gb = gbuffer.GBuffer(
                env["GBufferA"], env["GBufferB"], env["GBufferC"], depth, mask
            )
            rt = stages.deferred_shade(
                gb, env, active, env["InvView"], env["CameraPos"], cfg,
                rw, rh, full_height=h, full_width=w,
                light_tile=self.light_tile, light_cap=self.light_cap,
                pallas_interpret=self.pallas_interpret,
            )
            if (rw, rh) != (w, h):
                rt = rt[:h, :w]  # crop the pad-to-tile canvas
            trunc = stages.light_tile_overflow(
                active, cfg, rw, rh, self.light_tile, self.light_cap, w, h,
            )
            return {"DeferredShadingRT": rt, "LightTruncCount": trunc}

        def skybox_pass(env):
            # composited inside deferred_shade (sky where stencil==0); the
            # pass exists for graph parity and re-publishes the RT
            return {"DeferredShadingRT": env["DeferredShadingRT"]}

        def bloom_pass(env):
            if not cfg.enable_bloom:
                return {"DeferredShadingRT": env["DeferredShadingRT"]}
            return {"DeferredShadingRT": bloom_ops.bloom(env["DeferredShadingRT"])}

        def auto_exposure_pass(env):
            # the histogram resource is produced for parity/debug consumers,
            # but the average is computed by direct reductions so the 256-bin
            # scatter-add is dead code in the fused frame
            # whenever nothing reads LuminanceHistogram
            hist = postprocess.luminance_histogram(env["DeferredShadingRT"])
            if cfg.enable_auto_exposure:
                avg = postprocess.average_luminance_direct(
                    env["DeferredShadingRT"], float(w * h),
                    env["PrevAverageLuminance"], env["DeltaTime"]
                )
            else:
                avg = jnp.asarray(0.18, jnp.float32)
            return {"LuminanceHistogram": hist, "AverageLuminance": avg}

        def tone_mapping_pass(env):
            out = postprocess.tone_map(env["DeferredShadingRT"], env["AverageLuminance"])
            return {"ToneMappedTexture": out}

        def present_pass(env):
            rgb8 = (env["ToneMappedTexture"] * 255.0 + 0.5).astype(jnp.uint8)
            return {"BackBuffer": (rgb8, env["AverageLuminance"],
                                   env["BinCounts"], env["LightTruncCount"],
                                   env["VisibleCounts"])}

        static_reads = tuple(self.buffers.keys())
        passes = [
            fg.RenderPass(
                "Cull",
                ("FrustumPlanes", "InstanceBounds", "LightBounds"),
                ("InstanceVisible", "LightValid", "VisibleCounts"),
                cull_pass,
            ),
            fg.RenderPass(
                "Clustered",
                ("ClusterBounds", "View", "light_pos", "light_attenuation",
                 "light_intensity", "LightValid"),
                ("FrustumCluster", "PointLights"),
                clustered_pass,
            ),
            fg.RenderPass(
                "GBuffer",
                ("positions", "normals", "tangents", "uvs", "vtx_instance",
                 "tris", "tri_material", "tri_instance", "tri_valid_pool",
                 "mat_rows", "atlas", "ModelMats", "NormalMats",
                 "ViewProj", "InstanceVisible"),
                ("GBufferA", "GBufferB", "GBufferC", "GBufferDepthStencil",
                 "BinCounts"),
                gbuffer_pass,
                declares={
                    "GBufferA": fg.ResourceDesc((rh, rw, 4), "float32"),
                    "GBufferB": fg.ResourceDesc((rh, rw, 2), "float32"),
                    "GBufferC": fg.ResourceDesc((rh, rw, 3), "float32"),
                },
            ),
            fg.RenderPass(
                "DeferredShading",
                ("GBufferA", "GBufferB", "GBufferC", "GBufferDepthStencil",
                 "SkyBoxSH", "PrecomputeBRDF", "PrefilterEnvMap", "SkyBoxTexture",
                 "FrustumCluster", "InvView", "CameraPos"),
                ("DeferredShadingRT", "LightTruncCount"),
                deferred_pass,
                declares={
                    "GBufferA": fg.ResourceDesc((rh, rw, 4), "float32"),
                    "GBufferB": fg.ResourceDesc((rh, rw, 2), "float32"),
                    "GBufferC": fg.ResourceDesc((rh, rw, 3), "float32"),
                    "DeferredShadingRT": fg.ResourceDesc((h, w, 3), "float32"),
                },
            ),
            fg.RenderPass("Skybox", (), ("DeferredShadingRT",), skybox_pass),
            fg.RenderPass(
                "Bloom", ("DeferredShadingRT",), ("DeferredShadingRT",), bloom_pass,
                declares={
                    "DeferredShadingRT": fg.ResourceDesc((h, w, 3), "float32"),
                },
            ),
            fg.RenderPass(
                "AutoExposure",
                ("DeferredShadingRT", "PrevAverageLuminance", "DeltaTime"),
                ("LuminanceHistogram", "AverageLuminance"),
                auto_exposure_pass,
            ),
            fg.RenderPass(
                "ToneMapping",
                ("DeferredShadingRT", "AverageLuminance"),
                ("ToneMappedTexture",),
                tone_mapping_pass,
                declares={
                    "ToneMappedTexture": fg.ResourceDesc((h, w, 3), "float32"),
                },
            ),
            fg.RenderPass(
                "Present",
                ("ToneMappedTexture", "AverageLuminance", "BinCounts",
                 "LightTruncCount", "VisibleCounts"),
                ("BackBuffer",),
                present_pass,
            ),
        ]
        return fg.compile_graph(passes, present="Present")

    # ------------------------------------------------------------------
    @property
    def kernels(self) -> str:
        """The kernel choice, one line: which implementation runs each
        stage that has a hand-written kernel."""
        impl = "pallas-triton" + ("-interpret" if self.pallas_interpret
                                  else "")
        return (f"route={self.route} "
                f"raster={impl if self.use_pallas else 'xla'} "
                f"lights={impl if self.light_tile else 'xla-fori'}")

    def _frame(self, buffers, scene_f32, cam_f32, prev_avg_lum):
        # two packed uploads feed the frame: the SCENE pack (matrices +
        # world AABBs — re-uploaded only when a transform actually changes,
        # see render()) and the tiny CAMERA pack (76 floats, per frame).
        # Frustum culling runs on device (the Cull graph pass), so a static
        # scene costs one small upload per frame, independent of instance
        # count.
        p = self.packed
        i = p.model_mats.shape[0]
        mm = scene_f32[: i * 16].reshape(i, 4, 4)
        off = i * 16
        nm = scene_f32[off : off + i * 9].reshape(i, 3, 3)
        off += i * 9
        nb = p.instance_bounds.shape[0]
        ib = scene_f32[off : off + nb * 6].reshape(nb, 2, 3)
        off += nb * 6
        lbn = p.light_bounds.shape[0]
        lb = scene_f32[off : off + lbn * 6].reshape(lbn, 2, 3)

        planes = cam_f32[:24].reshape(6, 4)
        view = cam_f32[24:40].reshape(4, 4)
        inv_view = cam_f32[40:56].reshape(4, 4)
        view_proj = cam_f32[56:72].reshape(4, 4)
        camera_pos = cam_f32[72:75]
        delta_time = cam_f32[75]
        env = dict(buffers)
        env.update(
            ModelMats=mm,
            NormalMats=nm,
            InstanceBounds=ib,
            LightBounds=lb,
            FrustumPlanes=planes,
            View=view,
            InvView=inv_view,
            ViewProj=view_proj,
            CameraPos=camera_pos,
            PrevAverageLuminance=prev_avg_lum,
            DeltaTime=delta_time,
        )
        out = fg.execute(self.graph, env)
        return out["BackBuffer"]

    def _frame_seq(self, buffers, scene_f32, cam_seq_f32, prev_avg_lum):
        """N frames in ONE dispatch: lax.scan over per-frame camera packs
        with the exposure EMA threaded as the scan carry.

        An animation loop that knows its camera path pays one dispatch per
        sequence instead of one per frame. Semantically identical to N
        render() calls (same per-frame camera packs, same EMA carry chain)
        minus the per-frame stats outputs."""
        def body(avg, cam_f32):
            out = self._frame(buffers, scene_f32, cam_f32, avg)
            return out[1], out[0]  # carry new avg, emit rgb8

        avg, frames = jax.lax.scan(body, prev_avg_lum, cam_seq_f32)
        return frames, avg

    # ------------------------------------------------------------------
    def _pack_camera(self, camera: Camera, delta_time: float) -> np.ndarray:
        view = camera.view_matrix()
        return np.concatenate([
            np.asarray(camera.frustum_planes(), np.float32).ravel(),
            np.asarray(view, np.float32).ravel(),
            np.asarray(camera.world_matrix(), np.float32).ravel(),
            np.asarray(camera.projection_matrix() @ view, np.float32).ravel(),
            np.asarray(camera.position, np.float32).ravel(),
            np.float32([delta_time]),
        ]).astype(np.float32)

    def _pack_scene(self) -> np.ndarray:
        p = self.packed
        normal_mats = np.ascontiguousarray(
            np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1))
        )
        return np.concatenate([
            p.model_mats.ravel(), normal_mats.ravel(),
            p.instance_bounds.ravel(), p.light_bounds.ravel(),
        ]).astype(np.float32)

    def _upload_scene(self):
        # SCENE pack (matrices + world AABBs): re-uploaded only when a
        # transform changed — a static scene pays no scene upload per frame
        # regardless of instance count (culling is on device)
        scene_f32 = self._pack_scene()
        if self._scene_np is None or not np.array_equal(
            self._scene_np, scene_f32
        ):
            self._scene_np = scene_f32
            self._scene_dev = jnp.asarray(scene_f32)

    def frame_args(self, camera: Camera, delta_time: float = 1.0 / 60.0):
        """The single-frame jit's arguments for one pose: (buffers, scene
        pack, camera pack, exposure carry), uploading only what changed."""
        self._upload_scene()
        # CAMERA pack: 76 floats per frame (planes + view/inv/proj + pos
        # + dt); skipped too when bit-identical (static-pose loops)
        cam_f32 = self._pack_camera(camera, delta_time)
        if self._cam_np is None or not np.array_equal(self._cam_np, cam_f32):
            self._cam_np = cam_f32
            self._cam_dev = jnp.asarray(cam_f32)
        return self.buffers, self._scene_dev, self._cam_dev, self.avg_luminance

    def compile(self, camera: Camera):
        """Ahead-of-time compile of the single-frame program for `camera`'s
        argument shapes (jax.stages.Compiled: memory_analysis, cost)."""
        return self._frame_jit.lower(*self.frame_args(camera)).compile()

    def render_sequence(self, cameras, delta_time: float = 1.0 / 60.0):
        """Render a camera path as ONE device dispatch.

        cameras: list of Camera (a real animation path — each frame gets its
        own frustum/view/projection pack and the exposure EMA carries across
        frames exactly like per-frame render() calls). Returns the stacked
        (N, H, W, 3) uint8 frames (device array). The playback/benchmark
        analog of the reference's frame loop (App.cpp:354-380) without
        per-frame host round-trips."""
        self._upload_scene()
        cam_seq = np.stack([self._pack_camera(c, delta_time) for c in cameras])
        frames, avg = self._frame_seq_jit(
            self.buffers, self._scene_dev, jnp.asarray(cam_seq),
            self.avg_luminance,
        )
        self.avg_luminance = avg
        return frames

    # ------------------------------------------------------------------
    def render(
        self, camera: Camera, delta_time: float = 1.0 / 60.0, collect_stats: bool = True
    ):
        """One frame -> (H, W, 3) uint8 (device array).

        collect_stats=False skips the host readback of the bin counters so
        frames stay fully async (benchmark path)."""
        p = self.packed
        rgb8, avg, bin_counts, light_trunc, vis_counts = self._frame_jit(
            *self.frame_args(camera, delta_time)
        )
        self.avg_luminance = avg
        if collect_stats:
            counts_np = np.asarray(bin_counts)
            overflow = int(np.maximum(counts_np - self.bin_cap, 0).max())
            vis_np = np.asarray(vis_counts)
            n_vis_lights = int(vis_np[1])
            self.last_stats = FrameStats(
                visible_instances=int(vis_np[0]),
                total_instances=p.instance_count,
                visible_lights=n_vis_lights,
                bin_overflow=overflow,
                lights_truncated=max(0, n_vis_lights - self.max_active_lights),
                light_tile_overflow=int(light_trunc),
            )
            if self.last_stats.lights_truncated:
                import logging

                logging.getLogger(__name__).warning(
                    "%d visible lights exceed max_active_lights=%d; excess "
                    "lights are dropped (raise max_active_lights)",
                    n_vis_lights, self.max_active_lights,
                )
        return rgb8
