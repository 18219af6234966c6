"""chip_smoke.py: refuses to run without a GPU, and its four-device mesh
phase and helpers hold on virtual CPU devices at a tiny size."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_channel_rel_and_dot_count():
    a = np.ones((4, 4, 3), np.float32)
    b = a * np.asarray([1.0, 1.01, 0.98], np.float32)
    assert chip_smoke.channel_rel(b, a) == pytest.approx(0.02, rel=1e-5)
    assert chip_smoke.count_dots("x = stablehlo.dot_general %a, %b") == 1
    assert chip_smoke.count_dots("x = stablehlo.add %a, %b") == 0


def test_four_card_phase_on_virtual_cpu_devices():
    """The --four comparison, on four of the suite's virtual CPU devices:
    the (dp=2, sp=2) render and train loss agree with one device."""
    rel_frame, rel_loss = chip_smoke.four_card_phase(
        jax.devices()[:4], width=16, height=16, spp=16, bounces=3)
    assert rel_frame < chip_smoke.CHANNEL_TOL
    assert rel_loss < chip_smoke.LOSS_TOL
