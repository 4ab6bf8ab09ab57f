"""Global configuration for the nonlocal FEM framework.

The reference library (PyNucleus, base/PyNucleus_base/myTypes64.pyx:10-13)
fixes REAL=float64, INDEX=int32.  We keep float64 for quadrature and solves
(discretization parity with the reference test caches) and enable JAX x64 at
import time.  Performance-critical paths may downcast locally.
"""
import os

# Must run before any jax array is created.
import jax

jax.config.update("jax_enable_x64", True)
# Keep f32 matmuls in full f32: on a GPU the default lets XLA use TF32
# (about three significant digits), and the singular quadrature weights span
# many orders of magnitude.
jax.config.update("jax_default_matmul_precision", "float32")

# Persistent XLA compilation cache: the assembly engine compiles one kernel
# per (panel shape, quadrature size) bucket, so a cold build pays many
# compiles.  JAX reads JAX_COMPILATION_CACHE_DIR itself; without it the cache
# lives at one fixed path inside the checkout.  (JAX keys entries by device
# topology, which includes the host CPU's features, so one directory serves
# every machine.)
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def compileCacheDir(environ=os.environ):
    """The persistent compile cache directory this process uses."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

import numpy as np
import jax.numpy as jnp

REAL = np.float64
INDEX = np.int32
COMPLEX = np.complex128

JREAL = jnp.float64
JINDEX = jnp.int32
JCOMPLEX = jnp.complex128

# Tag conventions, mirroring the reference's DoF numbering convention
# (fem/PyNucleus_fem/DoFMaps.pyx: interior dofs >= 0, boundary dofs < 0).
PHYSICAL = 1
INTERIOR_NONOVERLAPPING = 2
INTERIOR = 3
NO_BOUNDARY = -1234


def toDevice(x, dtype):
    """Transfer host data to device at `dtype`, casting on the HOST.

    `jnp.asarray(np_arr, dtype=...)` with a dtype mismatch jit-compiles a
    per-shape convert_element_type program, and their count scales with the
    number of distinct array shapes.  Casting with numpy first makes the
    transfer compile-free.  Device arrays / tracers keep the jnp path."""
    if isinstance(x, (np.ndarray, list, tuple, int, float)):
        return jnp.asarray(np.asarray(x, dtype))
    return jnp.asarray(x, dtype=dtype)
