"""chip_smoke.py: refuses to run without a GPU, and its phase functions hold
at tiny sizes on the CPU (kernels through the Pallas interpreter, the
sharded phase on 4 virtual devices). On the card the `gpu` case runs the
phases with the compiled kernels."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = dict(width=128, height=96, cells=(32, 16), sky_size=16,
            brdf_lut_size=32, bin_cap=512)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(alone, tmp_path):
    """Exits non-zero with a message and prints no result line, in the repo
    and in a directory holding only the script."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def _bench(name, **kw):
    from direct12pbrrenderer.tools import stress_scene

    tiny = dict(TINY)
    w, h = tiny.pop("width"), tiny.pop("height")
    tiny.update(kw)
    return stress_scene.bench_pipeline(name, w, h, **tiny)


@pytest.mark.parametrize("name", ["sponza_class", "lights1k"])
def test_frame_phase_tiny(name):
    pipe, cam = _bench(name, pallas_interpret=True)
    out = chip_smoke.frame_phase(name, pipe, cam, "cpu", frames=2,
                                 lights=name == "lights1k")
    assert out["bin_overflow"] == 0 and out["lit_fraction"] > 0.05
    assert "pallas-triton-interpret" in out["kernels"]
    assert len(out["render_ms"]) == 2


def test_kernel_checks_tiny():
    pipe, cam = _bench("sponza_class", pallas_interpret=True)
    r = chip_smoke.raster_check(pipe, cam, "cpu", runs=1)
    assert r["id_mismatch_fraction"] <= 1e-4 and r["covered_fraction"] > 0.2
    pipe, cam = _bench("lights1k", pallas_interpret=True)
    lt = chip_smoke.lights_check(pipe, cam, "cpu", runs=1)
    assert lt["active_lights"] > 64
    assert lt["max_relative_error"] <= 1e-4


def test_device_vs_cpu_phase_on_cpu():
    rows = chip_smoke.cpu_gpu_check("cpu", sky_size=8)
    assert [r["scene"] for r in rows] == ["sphere", "terrain"]
    assert all(r["rmse_u8"] == 0.0 for r in rows)  # same device twice


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_four_cards_phase_on_virtual_devices():
    out = chip_smoke.four_cards_check(
        "cpu", n=4, width=128, height=128, cells=(32, 16), sky_size=16,
        runs=1, brdf_lut_size=32, bin_cap=512)
    assert out["rmse_u8"] <= 1e-3 and out["cards"] == 4


def test_result_line_is_last_and_exact(monkeypatch, capsys):
    """With every phase stubbed out, main() ends with exactly the contract
    line, device as JAX reports it."""
    dev = jax.devices()[0]

    class _Gpu:
        platform, device_kind = "gpu", dev.device_kind

    monkeypatch.setattr(jax, "devices", lambda *a: [_Gpu()])
    monkeypatch.setattr("direct12pbrrenderer.utils.device_info.card_line",
                        lambda: "Card X, 700.00 W")
    for fn in ("frame_phase", "raster_check", "lights_check",
               "cpu_gpu_check", "four_cards_check"):
        monkeypatch.setattr(chip_smoke, fn, lambda *a, **k: {})
    from direct12pbrrenderer.tools import stress_scene

    monkeypatch.setattr(stress_scene, "bench_pipeline",
                        lambda *a, **k: (type("P", (), {"kernels": "k"})(),
                                         None))
    monkeypatch.setattr(
        "direct12pbrrenderer.utils.compile_cache.enable_compile_cache",
        lambda: "cache")
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "card: Card X, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": dev.device_kind, "count": 1}}


@pytest.mark.gpu
def test_phases_on_card(gpu_device):
    pipe, cam = _bench("sponza_class")
    assert pipe.route == "triton"
    chip_smoke.raster_check(pipe, cam, "card", runs=2)
    pipe, cam = _bench("lights1k")
    chip_smoke.lights_check(pipe, cam, "card", runs=2)
    chip_smoke.cpu_gpu_check("card", sky_size=16)
