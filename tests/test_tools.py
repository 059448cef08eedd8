"""Smoke coverage for the committed measurement tools: tools that aren't
exercised by the pipeline tests rot silently as the pipeline API moves —
profile_pipeline is run here end-to-end on a tiny scene so a signature drift
fails fast."""

import numpy as np

from direct12pbrrenderer.config import RenderConfig
from direct12pbrrenderer.scene.camera import Camera

from test_pipeline import build_scene


def test_profile_pipeline_smoke():
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.tools.profile import profile_pipeline

    cfg = RenderConfig(width=128, height=96, max_triangles=2048,
                       max_vertices=2048, max_instances=4, max_lights=16)
    pipe = DeferredRenderPipeline(
        build_scene(), cfg, tile_h=24, tile_w=128, bin_cap=256,
        prefilter_size=8, brdf_lut_size=16,
    )
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    t = profile_pipeline(pipe, cam, iters=1)
    # every stage of the frame is attributed and timed
    for stage in ("geometry", "binning", "raster", "gbuffer_shade",
                  "light_cull", "deferred_shade", "exposure_tonemap",
                  "full_frame"):
        assert stage in t and t[stage] >= 0.0, (stage, t)


def test_tools_import_surface():
    # the profiler's and bench scenes' entry points stay importable
    from direct12pbrrenderer.tools import profile, stress_scene

    assert callable(profile.main)
    assert callable(stress_scene.bench_pipeline)
