"""chip_smoke.py and the compile-cache helper, on the CPU.

The smoke script must refuse to run anywhere but on a GPU; its phases are
rehearsed here at tiny sizes on the CPU backend (the 4-device phase on
virtual devices), which checks their control flow and golden comparisons
but measures nothing.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@pytest.fixture
def restore_cache_dir():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_fixed_dir_when_env_unset(monkeypatch, restore_cache_dir):
    import jax

    from jincresize_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache") == str(compile_cache.CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    assert compile_cache.enable_compile_cache() == got  # same path every call


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    import jax

    from jincresize_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )


def _no_result(r) -> bool:
    lines = r.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert _no_result(r), r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert _no_result(r), r.stdout


def test_device_phase_refuses_cpu_backend():
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeError, match="not 'gpu'"):
        chip_smoke.device_phase()


def test_golden_rows_cover_borders_and_exceptions():
    import chip_smoke

    from jincresize_tpu.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu.phase import plan_phases

    op = build_plane_operator(160, 120, 400, 300, radius_for_tap(3))
    rows = set(chip_smoke.golden_rows(op, extra=(150, 151)).tolist())
    assert set(range(op.y_lo)) <= rows
    assert set(range(op.y_hi, op.dst_height)) <= rows
    assert {int(r) for r in plan_phases(op).y.exceptions} <= rows
    assert {150, 151} <= rows


@pytest.mark.parametrize(
    "case",
    [
        ("tiny yuv420p10 mpeg2", (64, 48), (128, 96), 3, 2, {"cplace": "mpeg2"}),
        ("tiny fp32 deep", (240, 136), (120, 68), 16, 2, {}),
    ],
    ids=["yuv420p10", "fp32-deep"],
)
def test_served_case_rehearsal(case):
    """Phase 2's case runner at tiny sizes: build, times, golden parity."""
    import chip_smoke

    from jincresize_tpu.clip import gray, yuv420p

    name, src, dst, tap, frames, kw = case
    fmt = yuv420p(10) if "yuv" in name else gray(32)
    chip_smoke.served_case(name, fmt, src, dst, tap, frames, **kw)


@pytest.mark.parametrize("i", [0, 5, 10, 12, 14, 15])
def test_sweep_case_rehearsal(i):
    """Phase 3 cases on the CPU (periodic, crop, wide-phase, drifted, deep)."""
    import chip_smoke

    chip_smoke.sweep_case(*chip_smoke.SWEEP[i])


def test_multi_phase_rehearsal():
    """Phase 5 on 4 virtual CPU devices at a tiny size: both meshes, output
    spread over 4 devices, one-device and golden comparisons."""
    import jax

    import chip_smoke

    assert len(jax.devices()) >= 4
    chip_smoke.multi_phase(src=(192, 128), dst=(384, 256), tap=8, frames=4)


def test_last_line_is_the_contract_json(monkeypatch, capsys):
    """With every phase passing, the last stdout line is the JSON object."""
    import chip_smoke

    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: ["card, 700.00 W"])
    monkeypatch.setattr(chip_smoke, "device_phase", lambda min_count=1: info)
    monkeypatch.setattr(chip_smoke, "card_tests_phase", lambda: None)
    monkeypatch.setattr(chip_smoke, "SERVED", [])
    monkeypatch.setattr(chip_smoke, "SWEEP", [])
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": info}
    np.testing.assert_equal(list(json.loads(last)), ["ok", "device"])
