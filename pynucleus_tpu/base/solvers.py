"""Direct and Krylov solvers.

Counterpart of /root/reference/base/PyNucleus_base/solvers.pyx and linalg.pyx.
The Cython loops become jitted ``lax.while_loop`` kernels; direct solves use
``jax.scipy.linalg`` on device.  Semantics (initial guess, convergence
criteria, returned iteration counts) mirror the reference so that regression
values (iteration counts, residual norms) pinned in the reference test caches
are reproduced:

  - iterative_solver: x0=0 default, absolute tolerance 1e-5 unless
    relativeTolerance (ref solvers.pyx:248-305)
  - cg_solver: preconditioner-norm convergence criterion sqrt(r.M.r) unless
    use2norm (ref solvers.pyx:329-455)
  - gmres_solver: restarted MGS-Arnoldi (ref solvers.pyx:458+)

Inner products and norms are pluggable (ref ip_norm.pyx); with jax.sharding
the default jnp implementations are already SPMD-correct, so the distributed
variants are the same code operating on sharded arrays.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import REAL
from .linear_operators import (LinearOperator, Dense_LinearOperator,
                               Diagonal_LinearOperator, asOperator)

__all__ = ['solver', 'lu_solver', 'chol_solver', 'jacobi_solver',
           'iterative_solver', 'krylov_solver', 'cg_solver', 'gmres_solver',
           'bicgstab_solver', 'preconditioner', 'solverFactory']


class solver:
    """Base solver: setup once, then __call__(b) -> x or solve(b, x)."""

    def __init__(self, A=None, num_rows=-1):
        self.A = A
        self.num_rows = A.num_rows if A is not None else num_rows
        self.initialized = False

    def setup(self, A=None):
        if A is not None:
            self.A = A
        self.initialized = True

    def solve(self, b, x=None):
        raise NotImplementedError()

    def __call__(self, b, x=None):
        return self.solve(b, x)

    def asPreconditioner(self):
        return preconditioner(self)


class preconditioner(LinearOperator):
    """Wrap a solver as a LinearOperator (ref solvers.pyx preconditioner).

    Registered as a pytree: the wrapped solver object is static metadata, so a
    preconditioner can be passed through jit.  Its ``solve`` must itself be
    traceable (all concrete arrays are closed over as constants).
    """

    def __init__(self, solOp, collectResiduals=False):
        self.solOp = solOp
        self.num_rows = solOp.num_rows
        self.num_columns = solOp.num_rows

    def matvec(self, x):
        return self.solOp.solve(x)


jax.tree_util.register_pytree_node(
    preconditioner,
    lambda op: ((), (op.solOp,)),
    lambda s, d: preconditioner(s[0]))


class _luPrecOperator(LinearOperator):
    def __init__(self, lu, piv):
        self.lu, self.piv = lu, piv
        self.num_rows = self.num_columns = lu.shape[0]

    def matvec(self, x):
        return jax.scipy.linalg.lu_solve((self.lu, self.piv), x)


jax.tree_util.register_pytree_node(
    _luPrecOperator,
    lambda op: ((op.lu, op.piv), ()),
    lambda s, d: _luPrecOperator(*d))


class _cholPrecOperator(LinearOperator):
    def __init__(self, L):
        self.L = L
        self.num_rows = self.num_columns = L.shape[0]

    def matvec(self, x):
        y = jax.scipy.linalg.solve_triangular(self.L, x, lower=True)
        return jax.scipy.linalg.solve_triangular(self.L.T, y, lower=False)


jax.tree_util.register_pytree_node(
    _cholPrecOperator,
    lambda op: ((op.L,), ()),
    lambda s, d: _cholPrecOperator(*d))


class lu_solver(solver):
    """Dense LU on device (ref solvers.pyx:80 lu_solver via superlu)."""

    def setup(self, A=None):
        if A is not None:
            self.A = A
        data = jnp.asarray(self.A.toarray()) if not isinstance(self.A, Dense_LinearOperator) \
            else self.A.data
        self.lu, self.piv = jax.scipy.linalg.lu_factor(data)
        self.initialized = True

    def solve(self, b, x=None):
        return jax.scipy.linalg.lu_solve((self.lu, self.piv), b)

    def asPreconditioner(self):
        return _luPrecOperator(self.lu, self.piv)


class chol_solver(solver):
    """Dense Cholesky on device (ref opt_true_solver_cholmod.pxi:8)."""

    def setup(self, A=None):
        if A is not None:
            self.A = A
        data = jnp.asarray(self.A.toarray()) if not isinstance(self.A, Dense_LinearOperator) \
            else self.A.data
        self.L = jnp.linalg.cholesky(data)
        self.initialized = True

    def solve(self, b, x=None):
        y = jax.scipy.linalg.solve_triangular(self.L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(self.L.T, y, lower=False)

    def asPreconditioner(self):
        return _cholPrecOperator(self.L)


class jacobi_solver(solver):
    """Diagonal scaling (ref solvers.pyx:229)."""

    def setup(self, A=None):
        if A is not None:
            self.A = A
        self.invD = 1.0 / self.A.diagonal
        self.initialized = True

    def solve(self, b, x=None):
        return self.invD * b

    def asPreconditioner(self):
        return Diagonal_LinearOperator(self.invD)


class _hostPrecOperator(LinearOperator):
    """Preconditioner applying a host function (ILU/IChol triangular solves
    — sequential by nature, so they stay on host like the reference's
    Cython solves) inside jitted Krylov loops via jax.pure_callback."""

    def __init__(self, fn, n):
        self._fn = fn
        self.num_rows = self.num_columns = n

    def matvec(self, x):
        out = jax.ShapeDtypeStruct(x.shape, x.dtype)
        return jax.pure_callback(
            lambda v: np.asarray(self._fn(np.asarray(v)), dtype=v.dtype),
            out, x, vmap_method='sequential')


jax.tree_util.register_pytree_node(
    _hostPrecOperator,
    lambda op: ((), (op._fn, op.num_rows)),
    lambda s, d: _hostPrecOperator(*s))


def _toCSRTriple(A):
    """(indptr, indices, data, n) of an operator, via scipy."""
    import scipy.sparse as sp
    if hasattr(A, 'indptr') and getattr(A, 'indptr', None) is not None:
        M = sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                           np.asarray(A.indptr)),
                          shape=(A.num_rows, A.num_columns))
    else:
        M = sp.csr_matrix(np.asarray(A.toarray()))
    M.sum_duplicates()
    M.sort_indices()
    return M


class ichol_solver(solver):
    """Incomplete Cholesky IC(0) (ref solver_ichol.pxi / linalg.pyx:44
    ichol_csr): native C++ factorization + host triangular solves."""

    def setup(self, A=None):
        from .sparse_native import IChol
        if A is not None:
            self.A = A
        M = _toCSRTriple(self.A)
        self._fac = IChol(M.indptr, M.indices, M.data, M.shape[0])
        self.num_rows = M.shape[0]
        self.initialized = True

    def solve(self, b, x=None):
        return jnp.asarray(self._fac.apply(np.asarray(b)))

    def asPreconditioner(self):
        return _hostPrecOperator(self._fac.apply, self.num_rows)

    def __str__(self):
        return 'Incomplete Cholesky'


class ilu_solver(solver):
    """Incomplete LU via scipy's SuperLU spilu — the reference uses the
    same backend (ref solvers.pyx:188 ilu_solver, fill_factor=1)."""

    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.fill_factor = 1.0

    def setup(self, A=None):
        from scipy.sparse.linalg import spilu
        if A is not None:
            self.A = A
        M = _toCSRTriple(self.A).tocsc()
        self._ilu = spilu(M, fill_factor=self.fill_factor)
        self.num_rows = M.shape[0]
        self.initialized = True

    def solve(self, b, x=None):
        return jnp.asarray(self._ilu.solve(np.asarray(b)))

    def asPreconditioner(self):
        return _hostPrecOperator(self._ilu.solve, self.num_rows)

    def __str__(self):
        return 'Incomplete LU'


class iterative_solver(solver):
    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.maxIter = -1
        self.tolerance = 1e-5
        self.relativeTolerance = False
        self.x0 = None
        self.residuals = []

    def setInitialGuess(self, x0=None):
        self.x0 = x0

    def setNormInner(self, norm, inner):
        # retained for API parity; jnp norms are SPMD-correct on sharded arrays
        pass

    def _tol(self, b):
        if self.relativeTolerance:
            if self.x0 is None:
                r = b
            else:
                r = b - self.A.matvec(self.x0)
            return self.tolerance * float(jnp.linalg.norm(r))
        return self.tolerance


class krylov_solver(iterative_solver):
    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.prec = None

    def setPreconditioner(self, prec, left=True):
        self.prec = prec
        self.isLeftPrec = left

    def setup(self, A=None):
        if A is not None:
            self.A = A
            self.num_rows = A.num_rows
        self.initialized = True


@partial(jax.jit, static_argnames=('maxiter', 'use2norm', 'use_prec'))
def _cg_core(A, M, b, x0, tol, maxiter, use2norm=False, use_prec=False):
    """PCG mirroring ref solvers.pyx:329-455. Returns (x, iters, residuals)."""
    x = x0
    r = b - A.matvec(x)

    if use_prec:
        p = M.matvec(r)
        betaOld = jnp.vdot(r, p)
        convCrit = jnp.sqrt(jnp.vdot(r, r)) if use2norm else jnp.sqrt(betaOld)
    else:
        p = r
        betaOld = jnp.vdot(r, r)
        convCrit = jnp.sqrt(betaOld)

    res_hist = jnp.full((maxiter + 1,), jnp.nan, dtype=b.dtype)
    res_hist = res_hist.at[0].set(convCrit)

    def cond(state):
        x, r, p, betaOld, k, convCrit, res_hist = state
        return (convCrit > tol) & (k < maxiter)

    def body(state):
        x, r, p, betaOld, k, convCrit, res_hist = state
        Ap = A.matvec(p)
        alpha = betaOld / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if use_prec:
            Br = M.matvec(r)
            beta = jnp.vdot(r, Br)
            convCrit = jnp.sqrt(jnp.vdot(r, r)) if use2norm else jnp.sqrt(beta)
            p = Br + (beta / betaOld) * p
        else:
            beta = jnp.vdot(r, r)
            convCrit = jnp.sqrt(beta)
            p = r + (beta / betaOld) * p
        res_hist = res_hist.at[k + 1].set(convCrit)
        return (x, r, p, beta, k + 1, convCrit, res_hist)

    x, r, p, betaOld, iters, convCrit, res_hist = lax.while_loop(
        cond, body, (x, r, p, betaOld, jnp.int32(0), convCrit, res_hist))
    return x, iters, res_hist


class cg_solver(krylov_solver):
    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.use2norm = False
        self.maxIter = 50

    def solve(self, b, x=None):
        b = jnp.asarray(b)
        tol = self._tol(b)
        x0 = self.x0 if self.x0 is not None else jnp.zeros_like(b)
        maxiter = self.maxIter if self.maxIter > 0 else 50
        use_prec = self.prec is not None
        M = self.prec if use_prec else Diagonal_LinearOperator(jnp.ones_like(b))
        x, iters, res = _cg_core(self.A, M, b, x0, tol, maxiter,
                                 use2norm=self.use2norm, use_prec=use_prec)
        res = np.asarray(res)
        self.residuals = list(res[~np.isnan(res)])
        # reference convention (solvers.pyx:329-455): returns the loop index
        # at the convergence check, i.e. steps-1 when converged early
        it = int(iters)
        self.iterations = it - 1 if (it < maxiter and it > 0) else it
        return x


def _gmres_cycle(A, M, b, x0, tol, restart, use_prec, flexible):
    """One restart cycle of right-preconditioned MGS-Arnoldi GMRES.

    Runs the full restart length with masking after convergence (static
    shapes for jit); the least-squares solve uses only the active columns by
    keeping converged columns as identity rows.  Returns (x, resnorm, k)."""
    n = b.shape[0]
    dtype = b.dtype

    r = b - A.matvec(x0)
    beta = jnp.linalg.norm(r)

    V = jnp.zeros((restart + 1, n), dtype=dtype)
    V = V.at[0].set(jnp.where(beta > 0, r / beta, r))
    Z = jnp.zeros((restart, n), dtype=dtype)
    H = jnp.zeros((restart + 1, restart), dtype=dtype)
    cs = jnp.ones((restart,), dtype=dtype)
    sn = jnp.zeros((restart,), dtype=dtype)
    g = jnp.zeros((restart + 1,), dtype=dtype).at[0].set(beta)

    def body(j, carry):
        V, Z, H, cs, sn, g, resnorm, k, done, hist = carry

        def step(args):
            V, Z, H, cs, sn, g = args
            v = V[j]
            z = M.matvec(v) if use_prec else v
            w = A.matvec(z)

            def ortho(i, wh):
                w, hcol = wh
                hij = jnp.where(i <= j, jnp.vdot(V[i], w), 0.0)
                return (w - hij * V[i], hcol.at[i].set(hij))
            w, hcol = lax.fori_loop(
                0, restart, ortho,
                (w, jnp.zeros((restart + 1,), dtype=dtype)))
            hnorm = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hnorm)
            Vn = V.at[j + 1].set(jnp.where(hnorm > 1e-300, w / hnorm, w))
            Zn = Z.at[j].set(z)

            # complex-safe Givens: G = [[c, s], [-conj(s), conj(c)]] with
            # c = conj(a)/r, s = conj(b)/r eliminates b and is unitary; for
            # real data this reduces to the classical rotation
            def rot(i, hc):
                hi = jnp.where(i < j, cs[i] * hc[i] + sn[i] * hc[i + 1], hc[i])
                hi1 = jnp.where(i < j,
                                -jnp.conj(sn[i]) * hc[i]
                                + jnp.conj(cs[i]) * hc[i + 1],
                                hc[i + 1])
                return hc.at[i].set(hi).at[i + 1].set(hi1)
            hcol = lax.fori_loop(0, restart, rot, hcol)
            denom = jnp.sqrt(jnp.abs(hcol[j]) ** 2
                             + jnp.abs(hcol[j + 1]) ** 2)
            c = jnp.where(denom > 0, jnp.conj(hcol[j]) / denom,
                          jnp.ones((), dtype=dtype))
            s_ = jnp.where(denom > 0, jnp.conj(hcol[j + 1]) / denom,
                           jnp.zeros((), dtype=dtype))
            hcol = hcol.at[j].set(denom.astype(dtype)).at[j + 1].set(0.0)
            gn = g.at[j + 1].set(-jnp.conj(s_) * g[j]).at[j].set(c * g[j])
            Hn = H.at[:, j].set(hcol)
            return Vn, Zn, Hn, cs.at[j].set(c), sn.at[j].set(s_), gn

        V2, Z2, H2, cs2, sn2, g2 = lax.cond(
            done, lambda a: a, step, (V, Z, H, cs, sn, g))
        resnorm2 = jnp.where(done, resnorm, jnp.abs(g2[j + 1]))
        k2 = jnp.where(done, k, j + 1)
        hist2 = jnp.where(done, hist[j], resnorm2)
        hist = hist.at[j].set(hist2)
        done2 = done | (resnorm2 <= tol)
        return (V2, Z2, H2, cs2, sn2, g2, resnorm2, k2, done2, hist)

    hist0 = jnp.full((restart,), jnp.nan, dtype=dtype)
    V, Z, H, cs, sn, g, resnorm, k, done, hist = lax.fori_loop(
        0, restart, body,
        (V, Z, H, cs, sn, g, beta, jnp.int32(0), beta <= tol, hist0))

    # back substitution on the k-active upper-triangular system; inactive
    # columns have H[i, i] = 0 -> replace by identity with zero rhs
    active = jnp.arange(restart) < k
    Hd = H[:restart, :restart]
    Hd = jnp.where(active[None, :] & active[:, None], Hd, 0.0)
    Hd = Hd + jnp.diag(jnp.where(active, 0.0, 1.0))
    grhs = jnp.where(active, g[:restart], 0.0)
    y = jax.scipy.linalg.solve_triangular(Hd, grhs, lower=False)
    dx = (Z.T @ y) if use_prec else (V[:restart].T @ y)
    return x0 + dx, resnorm, k, hist


class gmres_solver(krylov_solver):
    """Restarted GMRES (ref solvers.pyx:458). Right-preconditioned (flexible)
    by default like the reference's use with MG preconditioners."""

    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.restarts = 1
        self.maxIter = 20
        self.flexible = True

    def solve(self, b, x=None):
        b = jnp.asarray(b)
        tol = self._tol(b)
        x0 = self.x0 if self.x0 is not None else jnp.zeros_like(b)
        restart = self.maxIter if self.maxIter > 0 else 20
        use_prec = self.prec is not None
        M = self.prec if use_prec else Diagonal_LinearOperator(jnp.ones_like(b))
        # residual history starts with the unpreconditioned initial
        # residual, then the Givens residual estimate per Arnoldi step
        # (matches the reference's resHist, solvers.pyx gmres)
        residuals = [float(jnp.linalg.norm(b - self.A.matvec(x0)))]
        x = x0
        total_iters = 0
        resnorm = residuals[0]
        for cycle in range(max(self.restarts, 1)):
            x, resnorm, k, hist = _gmres_cycle(self.A, M, b, x, tol, restart,
                                               use_prec, self.flexible)
            resnorm = float(np.real(resnorm))
            k = int(k)
            # residual norms are real; the history buffer carries the
            # solution dtype (complex for complex systems)
            histArr = np.asarray(hist)[:k].real
            residuals.extend(float(v) for v in histArr[~np.isnan(histArr)])
            total_iters += k
            if resnorm <= tol:
                break
        r = b - self.A.matvec(x)
        self.residuals = residuals
        self.explicitResidual = float(jnp.linalg.norm(r))
        # converged solves report steps-1 like the reference's counter
        # (solvers.pyx: the final check decrements on early exit)
        if resnorm <= tol and total_iters > 0:
            self.iterations = total_iters - 1
        else:
            self.iterations = total_iters
        return x


@partial(jax.jit, static_argnames=('maxiter', 'use_prec'))
def _bicgstab_core(A, M, b, x0, tol, maxiter, use_prec=False):
    """BiCGStab mirroring ref solvers.pyx:675."""
    x = x0
    r = b - A.matvec(x)
    r0 = r
    rho = alpha = omega = jnp.array(1.0, dtype=b.dtype)
    v = p = jnp.zeros_like(b)
    resnorm = jnp.linalg.norm(r)

    def cond(state):
        x, r, p, v, rho, alpha, omega, k, resnorm = state
        return (resnorm > tol) & (k < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, k, resnorm = state
        rho_new = jnp.vdot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M.matvec(p) if use_prec else p
        v = A.matvec(ph)
        alpha = rho_new / jnp.vdot(r0, v)
        s = r - alpha * v
        sh = M.matvec(s) if use_prec else s
        t = A.matvec(sh)
        omega = jnp.vdot(t, s) / jnp.vdot(t, t)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        resnorm = jnp.linalg.norm(r)
        return (x, r, p, v, rho_new, alpha, omega, k + 1, resnorm)

    state = (x, r, p, v, rho, alpha, omega, jnp.int32(0), resnorm)
    x, r, p, v, rho, alpha, omega, iters, resnorm = lax.while_loop(cond, body, state)
    return x, iters, resnorm


class bicgstab_solver(krylov_solver):
    def __init__(self, A=None, num_rows=-1):
        super().__init__(A, num_rows)
        self.maxIter = 200

    def solve(self, b, x=None):
        b = jnp.asarray(b)
        tol = self._tol(b)
        x0 = self.x0 if self.x0 is not None else jnp.zeros_like(b)
        use_prec = self.prec is not None
        M = self.prec if use_prec else Diagonal_LinearOperator(jnp.ones_like(b))
        x, iters, resnorm = _bicgstab_core(self.A, M, b, x0, tol,
                                           self.maxIter, use_prec=use_prec)
        it = int(iters)
        self.iterations = it - 1 if (it < self.maxIter and it > 0) else it
        self.residuals = [float(resnorm)]
        return x


class solverFactoryClass:
    """String -> solver construction (ref base/solver_factory.py:13).

    Supports combined names like 'cg-mg' and 'gmres-jacobi': krylov solver
    preconditioned by the second part.
    """

    def __init__(self):
        self.classes = {}

    def register(self, name, classType, isMultilevelSolver=False, aliases=None):
        self.classes[name] = (classType, isMultilevelSolver)
        if aliases:
            for a in aliases:
                self.classes[a] = (classType, isMultilevelSolver)

    def isRegistered(self, name):
        return (name in self.classes) or ('-' in name and
                all(p in self.classes for p in name.split('-', 1)))

    def build(self, name, A=None, setup=False, hierarchy=None, **kwargs):
        if A is None and hierarchy is not None:
            A = hierarchy[-1]['A']
        if name in self.classes:
            classType, isML = self.classes[name]
            if isML:
                s = classType(hierarchy if hierarchy is not None else A, **kwargs)
            else:
                s = classType(A, **kwargs)
        elif '-' in name:
            outer_name, inner_name = name.split('-', 1)
            s = self.build(outer_name, A=A)
            prec_solver = self.build(inner_name, A=A, setup=setup,
                                     hierarchy=hierarchy, **kwargs)
            if setup and not prec_solver.initialized:
                prec_solver.setup()
            s.setPreconditioner(prec_solver.asPreconditioner())
        else:
            raise KeyError(name)
        if setup and not s.initialized:
            s.setup()
        return s

    def __call__(self, name, **kwargs):
        return self.build(name, **kwargs)


solverFactory = solverFactoryClass()
solverFactory.register('lu', lu_solver)
solverFactory.register('chol', chol_solver, aliases=['cholesky', 'cholmod'])
solverFactory.register('jacobi', jacobi_solver)
solverFactory.register('ichol', ichol_solver)
solverFactory.register('ilu', ilu_solver)
solverFactory.register('cg', cg_solver)
solverFactory.register('gmres', gmres_solver)
solverFactory.register('bicgstab', bicgstab_solver)
