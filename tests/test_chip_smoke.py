"""``chip_smoke.py``: its phases at tiny sizes on the CPU, its refusal of a
machine without a GPU, and the phase selection of ``--devices``.

The full-size run needs the card: ``python chip_smoke.py`` (and
``python -m pytest tests -m gpu`` on a machine with one).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cache_dir(monkeypatch, tmp_path):
    """Keep the phases (which enable the persistent cache, as a user run
    does) from pointing this test process's CPU programs at the checkout."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


TINY = {
    "headline": dict(nx=15, gate=1.0),
    "cli": dict(nx=15, re=100.0, gate=1.0),
    "reference": dict(sizes=(15, 16), n_iters=5),
    "large": dict(sizes=((16, 5),)),
    "sequenced": dict(nx=64, re=100.0, gate=1.0),
    "algorithms": dict(nx=15),
    "four_cards": dict(nx=16, n_iters=5, invariance_nx=16),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_size(name, no_cache_dir, capsys):
    clock = chip_smoke.CompileClock()
    fn = getattr(chip_smoke, f"phase_{name}")
    assert chip_smoke.run_phase(name, lambda: fn(**TINY[name]), clock)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"phase {name}: wall ") and " PASS " in line


def test_failed_check_fails_the_phase(capsys):
    clock = chip_smoke.CompileClock()

    def phase():
        chip_smoke.check(False, "deliberate")

    assert not chip_smoke.run_phase("broken", phase, clock)
    assert "FAIL" in capsys.readouterr().out


def test_main_refuses_a_cpu_device(no_cache_dir, capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"
    assert not any(" PASS " in line for line in out)


@pytest.mark.parametrize("devices,names", [
    (1, ["headline", "cli", "reference", "large", "sequenced",
         "algorithms"]),
    (4, ["four_cards"]),
])
def test_devices_option_selects_phases(devices, names):
    assert [n for n, _ in chip_smoke.select_phases(devices)] == names


@pytest.mark.gpu
def test_chip_smoke_on_the_card():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1500)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and last["ok"] is True, out.stdout[-3000:]
    assert last["device"]["platform"] == "gpu"
