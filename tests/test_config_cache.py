"""Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR when
set, else one fixed, gitignored directory inside the checkout."""
import os
import subprocess
import sys

import pytest

from pynucleus_tpu import config

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('envDir', [None, 'given'], ids=['default', 'env'])
def test_compile_cache_dir(envDir, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    want = config.DEFAULT_CACHE_DIR
    if envDir is not None:
        want = str(tmp_path / 'cache')
        env['JAX_COMPILATION_CACHE_DIR'] = want
    assert config.compileCacheDir(env) == want
    code = ('import jax, pynucleus_tpu; from pynucleus_tpu.config import '
            'compileCacheDir; print(jax.config.jax_compilation_cache_dir); '
            'print(compileCacheDir())')
    r = subprocess.run([sys.executable, '-c', code], env=env, cwd=HERE,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [want, want]
    if envDir is None:
        assert os.path.dirname(want) == HERE
        with open(os.path.join(HERE, '.gitignore')) as f:
            ignored = f.read().split()
        assert os.path.basename(want) + '/' in ignored
