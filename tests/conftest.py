"""Test configuration: force CPU with 8 virtual devices so sharding tests run
without a multi-GPU host. Tests that need the card carry the `gpu` marker and
take the `gpu_device` fixture, which skips them here; on the card they run
with `python -m pytest tests/ -m gpu -p no:cacheprovider` and
D12PBR_TEST_GPU=1 (that variable keeps this file from pinning the CPU)."""

import os

ON_GPU = os.environ.get("D12PBR_TEST_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

# ---------------------------------------------------------------------------
# fast/slow split: `pytest -m "not slow"` is the <2-minute core suite (every
# package module keeps at least one fast test); the full suite (~12 min on an
# 8-device CPU host) adds the 1080p-class goldens, sharded reference-scene
# equivalence, and other full-pipeline compiles. Centralized here (not as
# per-test decorators) so the tier list is auditable in one place.
# ---------------------------------------------------------------------------

SLOW_MODULES = {
    "test_golden.py",             # full-pipeline CPU golden renders
    "test_golden_reference.py",   # reference-scene hero goldens
    "test_sharded_reference.py",  # 8-device reference-scene equivalence
}

# The slow tier is further split into three independently runnable subsets,
# each < 10 min on a 1-core host (so any CI window can run one):
#   pytest -m slow_golden   — full-pipeline golden renders (incl. hero)
#   pytest -m slow_sharded  — 8-device sharding equivalence suites
#   pytest -m slow_kernels  — everything else (kernel exactness, census,
#                             budgets, scale, e2e import)
SLOW_GOLDEN_MODULES = {"test_golden.py", "test_golden_reference.py"}
SLOW_SHARDED_MODULES = {"test_sharded_reference.py", "test_sharded.py"}

SLOW_TESTS = {
    "test_import_e2e.py::test_imported_model_renders",
    "test_lights_pallas.py::test_pipeline_light_tile_path",
    "test_pipeline.py::test_arbitrary_resolution_pad_and_crop",
    "test_sharded.py::test_sharded_matches_single_chip",
    "test_pipeline.py::test_renders_lit_sphere",
    "test_scale.py::test_stress_scene_pools_autogrow_and_bin_1080p",
    "test_assets.py::test_scene_json_loads",
    "test_raster.py::test_hierarchical_binning_matches_flat",
    "test_postprocess.py::test_bloom_shapes_and_sanity[hw1]",
    "test_postprocess.py::test_bloom_shapes_and_sanity[hw2]",
    # round-3 re-tier (measured --durations on a 1-core host): the heaviest
    # fast-tier tests move here; every module keeps at least one fast test
    "test_viewer.py::test_viewer_serves_page_and_steps_camera",
    "test_raster.py::test_fullscreen_triangle_covers_everything",
    "test_pipeline.py::test_render_sequence_matches_per_frame",
    "test_postprocess.py::test_bloom_fused_matches_literal",
    "test_lights_pallas.py::test_tile_kernel_matches_fori[scattered]",
    "test_pipeline.py::test_exposure_adapts_over_frames",
    "test_raster.py::test_depth_test_less_front_wins",
    "test_assets.py::test_scene_json_roundtrip",
    "test_pipeline.py::test_device_cull_matches_host",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-pipeline / large-shape tests (excluded from "
        "the <2-minute core suite; run the full suite before release)"
    )
    config.addinivalue_line(
        "markers", "slow_golden: slow subset — golden-image renders")
    config.addinivalue_line(
        "markers", "slow_sharded: slow subset — multi-device equivalence")
    config.addinivalue_line(
        "markers", "slow_kernels: slow subset — kernel/census/scale/e2e")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU (compiled Triton kernels); skips on "
        "the CPU through the gpu_device fixture")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.fspath.basename
        key = f"{mod}::{item.name}"
        if mod in SLOW_MODULES or key in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
            if mod in SLOW_GOLDEN_MODULES:
                item.add_marker(pytest.mark.slow_golden)
            elif mod in SLOW_SHARDED_MODULES:
                item.add_marker(pytest.mark.slow_sharded)
            else:
                item.add_marker(pytest.mark.slow_kernels)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none. Decided here, at
    run time, never while test modules are imported."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernels have no CPU path)")
    return devices[0]


REFERENCE_ASSETS = pathlib.Path("/root/reference/DeferredRendering")


@pytest.fixture
def reference_assets() -> pathlib.Path:
    if not REFERENCE_ASSETS.exists():
        pytest.skip("reference asset tree not available")
    return REFERENCE_ASSETS


@pytest.fixture
def asset_loader(reference_assets):
    from direct12pbrrenderer.resource.loader import ResourceLoader

    loader = ResourceLoader(reference_assets)
    old = ResourceLoader._instance
    ResourceLoader.set_instance(loader)
    yield loader
    ResourceLoader._instance = old
