import os

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerator hardware; tests that need the GPU are marked `gpu` and
# run in a subprocess without this pin.  The platform is also set through
# jax.config, which wins over an environment the process inherited.
os.environ['JAX_PLATFORMS'] = 'cpu'
# Keep the suite's compile cache apart from the drivers' so test entries
# don't churn it (config.py reads the same variable).
os.environ.setdefault(
    'JAX_COMPILATION_CACHE_DIR',
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 '.jax_cache', 'tests'))
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import pynucleus_tpu  # noqa: E402,F401  (enables x64)

assert jax.devices()[0].platform == 'cpu'
