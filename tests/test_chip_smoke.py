"""chip_smoke.py and bench.py off the GPU, and chip_smoke's phases on the
CPU against the same pinned data the GPU run checks, so the pins cannot
drift from the code."""
import importlib
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
import pynucleus_tpu.nl.assembly as assembly

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpuEnv():
    return dict(os.environ, JAX_PLATFORMS='cpu')


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_refuses_to_run_without_gpu(script):
    r = subprocess.run([sys.executable, script], env=_cpuEnv(), cwd=HERE,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0, r.stdout[-2000:]
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout, r.stdout
    assert 'needs a GPU' in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize('path', ['host', 'device'])
def test_smoke_phases_on_cpu(path, monkeypatch):
    """parity (disc noRef 3), main (noRef 2 and 3), h2_vs_dense and f32 at
    noRef 3; 'device' takes the assembly branches a GPU takes."""
    if path == 'device':
        monkeypatch.setattr(assembly, '_onAccelerator', lambda: True)
    pinned = chip_smoke.checkDiscPin(3)
    rungs = chip_smoke.phaseMain((2, 3), pinned['iterations'])
    mS = rungs[3][1]
    chip_smoke.phaseH2VsDense(mS)
    chip_smoke.phaseF32(mS, 3)


def test_four_device_phase_on_cpu():
    """--four's phases on four of the suite's virtual CPU devices (disc at
    noRef 2)."""
    chip_smoke.phaseFour('cpu', discRung=2)


MODULES = ['drivers.' + f[:-3] for f in sorted(os.listdir(
    os.path.join(HERE, 'drivers'))) if f.endswith('.py') and f[0] != '_'] + \
    ['examples.' + f[:-3] for f in sorted(os.listdir(
        os.path.join(HERE, 'examples'))) if f.endswith('.py') and
     f[0] != '_']


@pytest.mark.parametrize('module', MODULES)
def test_import_leaves_platform_alone(module):
    """Drivers and examples use JAX's default backend: importing one does
    not choose a platform."""
    prev = jax.config.jax_platforms
    jax.config.update('jax_platforms', 'cpu,cuda')
    try:
        importlib.reload(importlib.import_module(module))
        assert jax.config.jax_platforms == 'cpu,cuda'
    finally:
        jax.config.update('jax_platforms', prev)
    assert jax.devices()[0].platform == 'cpu'
