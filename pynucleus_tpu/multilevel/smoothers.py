"""Classical relaxation smoothers/solvers: Gauss-Seidel, SOR, SSOR.

Counterpart of /root/reference/multilevelSolver/PyNucleus_multilevelSolver/
smoothers.pyx (sorPreconditioner:35, ssorSmoother:247,
gaussSeidelSmoother:264).  These sweeps have sequential row dependencies
and do not vectorize, so they run host-side via sparse
triangular solves; the device smoothers in the multigrid cycle are
damped Jacobi and Chebyshev (gmg.py).  They are provided for component
parity and as standalone preconditioners/solvers.
"""
import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular

from ..base.solvers import solver, solverFactory
from ..base.linear_operators import LinearOperator

__all__ = ['gaussSeidel_solver', 'sor_solver', 'ssor_solver']


def _toCSR(A):
    if hasattr(A, 'to_scipy'):
        return A.to_scipy().tocsr()
    return sp.csr_matrix(np.asarray(A.toarray()))


def _sweepOperator(solverObj):
    """Materialize the sweep action M^{-1} as a dense device operator so it
    can live inside the jitted Krylov cores (these host smoothers exist for
    component parity; the device preconditioners are Jacobi/Chebyshev/MG).
    O(n^2) setup -- intended for moderate problem sizes."""
    from ..base.linear_operators import Dense_LinearOperator
    import jax.numpy as jnp
    n = solverObj.num_rows
    eye = np.eye(n)
    cols = np.stack([solverObj.solve(eye[:, j]) for j in range(n)], axis=1)
    return Dense_LinearOperator(jnp.asarray(cols))


class gaussSeidel_solver(solver):
    """Forward Gauss-Seidel sweeps: (L + D) x_{k+1} = b - U x_k
    (ref smoothers.pyx gaussSeidelSmoother:264)."""
    omega = 1.0

    def __init__(self, A=None, numSweeps=1, **kwargs):
        super().__init__(A)
        self.numSweeps = numSweeps

    def setup(self, A=None):
        if A is not None:
            self.A = A
            self.num_rows = A.num_rows
        Ac = _toCSR(self.A)
        om = self.omega
        D = sp.diags(Ac.diagonal())
        self.LD = (sp.tril(Ac, -1) + D / om).tocsr()
        self.U = (sp.triu(Ac, 1) + (1.0 - 1.0 / om) * D).tocsr()
        self.initialized = True

    def solve(self, b, x=None):
        b = np.asarray(b)
        x = np.zeros_like(b) if x is None else np.array(x, dtype=b.dtype)
        for _ in range(self.numSweeps):
            x = spsolve_triangular(self.LD, b - self.U @ x, lower=True)
        return x

    def asPreconditioner(self):
        return _sweepOperator(self)


class sor_solver(gaussSeidel_solver):
    """Successive over-relaxation (ref smoothers.pyx sorPreconditioner:35)."""

    def __init__(self, A=None, omega=1.5, numSweeps=1, **kwargs):
        super().__init__(A, numSweeps=numSweeps)
        self.omega = omega


class ssor_solver(solver):
    """Symmetric SOR: forward then backward sweep
    (ref smoothers.pyx ssorSmoother:247)."""

    def __init__(self, A=None, omega=1.0, numSweeps=1, **kwargs):
        super().__init__(A)
        self.omega = omega
        self.numSweeps = numSweeps

    def setup(self, A=None):
        if A is not None:
            self.A = A
            self.num_rows = A.num_rows
        Ac = _toCSR(self.A)
        om = self.omega
        D = sp.diags(Ac.diagonal())
        self.LD = (sp.tril(Ac, -1) + D / om).tocsr()
        self.DU = (sp.triu(Ac, 1) + D / om).tocsr()
        self.Lp = (sp.tril(Ac, -1) + (1.0 - 1.0 / om) * D).tocsr()
        self.Up = (sp.triu(Ac, 1) + (1.0 - 1.0 / om) * D).tocsr()
        self.initialized = True

    def solve(self, b, x=None):
        b = np.asarray(b)
        x = np.zeros_like(b) if x is None else np.array(x, dtype=b.dtype)
        for _ in range(self.numSweeps):
            x = spsolve_triangular(self.LD, b - self.Up @ x, lower=True)
            x = spsolve_triangular(self.DU, b - self.Lp @ x, lower=False)
        return x

    def asPreconditioner(self):
        return _sweepOperator(self)


solverFactory.register('gauss_seidel', gaussSeidel_solver, aliases=['gs'])
solverFactory.register('sor', sor_solver)
solverFactory.register('ssor', ssor_solver)
