"""The kernel route (one explicit choice per platform, no fallback), the
compile-cache placement and the in-memory procedural sky."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from direct12pbrrenderer.pipeline import deferred

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform,route", [("cpu", "xla"),
                                            ("gpu", "triton")])
def test_kernel_route_per_platform(platform, route):
    assert deferred.kernel_route(platform) == route


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no render path"):
        deferred.kernel_route(platform)


def _tiny(**kw):
    import __graft_entry__ as graft

    return graft._tiny_pipeline(**kw)


def test_cpu_pipeline_takes_xla_and_interpret_hook_takes_kernels():
    pipe, _, cfg = _tiny()
    assert pipe.route == "xla" and not pipe.use_pallas
    assert pipe.light_tile is None
    assert pipe.kernels == "route=xla raster=xla lights=xla-fori"
    hooked = deferred.DeferredRenderPipeline(
        pipe.scene, cfg, bin_cap=512, prefilter_size=8, brdf_lut_size=16,
        max_active_lights=128, pallas_interpret=True)
    assert hooked.route == "triton" and hooked.use_pallas
    assert hooked.light_tile == (32, 32)  # >64 lights -> tile light kernel
    with pytest.raises(RuntimeError, match="needs a GPU"):
        deferred.DeferredRenderPipeline(pipe.scene, cfg, route="triton")
    with pytest.raises(ValueError, match="unknown kernel route"):
        deferred.DeferredRenderPipeline(pipe.scene, cfg, route="mosaic")


def test_gpu_platform_picks_kernels_and_refuses_interpret(monkeypatch):
    pipe, _, cfg = _tiny()
    monkeypatch.setattr(deferred, "default_platform", lambda: "gpu")
    gpu = deferred.DeferredRenderPipeline(
        pipe.scene, cfg, bin_cap=512, prefilter_size=8, brdf_lut_size=16,
        max_active_lights=128)
    assert gpu.route == "triton" and gpu.use_pallas
    assert not gpu.pallas_interpret
    assert gpu.light_tile == (32, 32)
    assert gpu.kernels == ("route=triton raster=pallas-triton "
                           "lights=pallas-triton")
    # the A/B reference path stays reachable on the card, explicitly
    xla = deferred.DeferredRenderPipeline(pipe.scene, cfg, route="xla",
                                          max_active_lights=128)
    assert not xla.use_pallas and xla.light_tile is None
    with pytest.raises(ValueError, match="test hook"):
        deferred.DeferredRenderPipeline(pipe.scene, cfg,
                                        pallas_interpret=True)


def test_default_platform_follows_default_device():
    with jax.default_device(jax.devices("cpu")[0]):
        assert deferred.default_platform() == "cpu"
    assert deferred.default_platform() == jax.default_backend()


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from direct12pbrrenderer.utils.compile_cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(from_env, tmp_path):
    if from_env:
        want = str(tmp_path / "cache")
        used, config = _cache_dir_in_child(want)
        assert used == want and config == want
    else:
        used, config = _cache_dir_in_child(None)
        assert used == config == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_procedural_sky_in_memory():
    from direct12pbrrenderer.app.console import procedural_sky

    sky = procedural_sky(16, sun_dir=(0.0, 1.0, 0.0), sun_intensity=50.0)
    assert sky.texture_path == ""  # nothing written, nothing to load
    cube = sky.cubemap
    assert len(cube.faces) == 6 and cube.size == 16
    faces = cube.face_arrays(0)[..., :3]
    assert np.isfinite(faces).all() and faces.min() >= 0.0
    # the sun straight up lands in the +Y face (index 2)
    assert faces[2].max() > 2.0 * faces[[0, 1, 3, 4, 5]].max()
    sh = np.asarray(sky.sh.as_array())
    assert sh.shape == (7, 4) and np.isfinite(sh).all() and np.abs(sh).max() > 0


def test_pipeline_uses_the_sky_for_ibl():
    pipe, _, _ = _tiny(sky_size=16)
    assert float(np.abs(np.asarray(pipe.sh_pack)).max()) > 0.0
    assert float(np.asarray(pipe.prefiltered_mip_faces[0]).max()) > 0.0
    bare, _, _ = _tiny()
    assert float(np.abs(np.asarray(bare.sh_pack)).max()) == 0.0
