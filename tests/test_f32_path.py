"""End-to-end accuracy on the f32 dtype path: the benchmark assembles in
float32 on the GPU; pin the discretization errors on that path so a dtype
regression cannot land silently."""
import numpy as np
import jax.numpy as jnp

from pynucleus_tpu.fem import simpleInterval, P1_DoFMap, assembleRHS, constant
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder
from pynucleus_tpu.base.solvers import solverFactory


def _solve(dtype, denseGrid=False):
    m = simpleInterval(-1.0, 1.0)
    for _ in range(6):
        m = m.refine()
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(1, 0.75)
    params = {'dtype': dtype}
    if denseGrid:
        params['denseGrid'] = True
    A = nonlocalBuilder(dm, kernel, params=params).getDense()
    b = assembleRHS(dm, constant(1.0))
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance = 1e-6
    cg.maxIter = 500
    u = cg.solve(jnp.asarray(np.asarray(b.data, dtype=dtype)))
    # analytic solution of (-Delta)^s u = 1 on (-1,1):
    # u = 2^{-2s} sqrt(pi) / (Gamma(s+1/2) Gamma(1+s)) (1-x^2)^s
    from scipy.special import gamma
    s = 0.75
    xs = np.asarray(dm.getDoFCoordinates())[:, 0]
    uex = (2.0 ** (-2 * s) * np.sqrt(np.pi)
           / (gamma(s + 0.5) * gamma(1.0 + s))) * (1 - xs ** 2) ** s
    err = np.abs(np.asarray(u) - uex).max()
    return err


def test_f32_assembly_solve_accuracy():
    e64 = _solve(np.float64)
    e32 = _solve(np.float32)
    # discretization error dominates; f32 may add a small rounding floor
    assert e32 < max(2.0 * e64, 5e-4), (e32, e64)


def test_f32_grid_path_accuracy():
    e32g = _solve(np.float32, denseGrid=True)
    e64 = _solve(np.float64)
    assert e32g < max(2.0 * e64, 5e-4), (e32g, e64)
