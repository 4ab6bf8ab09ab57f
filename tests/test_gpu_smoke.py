"""chip_smoke.py's parity phase on a GPU: the 1D reference-pinned driver
configs and the CPU-pinned disc configs, run by the drivers on the card.

The suite pins the CPU (conftest), so the phase runs in a subprocess without
the pin.  On a machine with a GPU:

    python -m pytest -m gpu tests/test_gpu_smoke.py
"""
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    """Environment for a GPU subprocess; skips when the machine has no
    NVIDIA GPU (decided here, not at import, so every worker collects the
    same tests)."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        pytest.skip('no NVIDIA GPU: nvidia-smi not found')
    r = subprocess.run([smi, '-L'], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0 or 'GPU' not in r.stdout:
        pytest.skip('no NVIDIA GPU listed by nvidia-smi')
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env.pop('XLA_FLAGS', None)
    return env


@pytest.mark.gpu
def test_gpu_parity_phase(gpu_env):
    code = ('import chip_smoke as c; c.preflight(1); c.phaseParity(); '
            'print("PARITY OK")')
    r = subprocess.run([sys.executable, '-c', code], env=gpu_env, cwd=HERE,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-3000:]
    assert 'PARITY OK' in r.stdout, r.stdout[-2000:]
