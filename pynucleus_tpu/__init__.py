"""pynucleus_tpu: a JAX nonlocal finite element framework.

A ground-up JAX/XLA rebuild of the capabilities of PyNucleus
(sandialabs/PyNucleus): nonlocal operator assembly (fractional, peridynamic,
integrable kernels), dense/sparse/hierarchical (H2) operator formats, Krylov
solvers and geometric multigrid, distributed over device meshes with
jax.sharding instead of MPI.
"""
from . import config  # noqa: F401  — must be first: enables x64
from .config import REAL, INDEX, COMPLEX  # noqa: F401
from .base import (  # noqa: F401
    LinearOperator, Dense_LinearOperator, Diagonal_LinearOperator,
    CSR_LinearOperator, SSS_LinearOperator, solverFactory, driver)

__version__ = '0.1.0'
