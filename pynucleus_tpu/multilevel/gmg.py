"""Geometric multigrid.

Counterpart of /root/reference/multilevelSolver/PyNucleus_multilevelSolver/
(multigrid_{SCALAR}.pxi:86-470, smoothers.pyx, restrictionProlongation.pyx,
hierarchies.py, levels.py).  Design differences:

  - The level hierarchy is a pytree (operators + damped-Jacobi inverse
    diagonals + dense coarse factors), so ONE jit compiles the whole V/W/FMG
    cycle into a single XLA computation — no per-level Python dispatch at
    solve time.
  - Prolongation is built generically for any nested Pk spaces by evaluating
    coarse shape functions at fine dof nodes (replaces the reference's
    generated per-order restriction_*.pxi tables); R = P^T.
  - Smoothers: damped Jacobi (omega=2/3 default) and Chebyshev (both
    parallel); sequential GS/SOR/ILU are intentionally not provided on
    device (ref smoothers.pyx gaussSeidelSmoother has no parallel analogue).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

import scipy.sparse as sp

from ..config import REAL, INDEX
from ..base.linear_operators import (LinearOperator, CSR_LinearOperator,
                                     Dense_LinearOperator)
from ..base.solvers import (iterative_solver, solverFactory, _luPrecOperator)

__all__ = ['buildProlongation', 'multigrid', 'mgPreconditioner',
           'buildMeshHierarchy']


def buildProlongation(dmCoarse, dmFine, dtype=None):
    """P [fineDofs x coarseDofs]: evaluate coarse basis at fine dof nodes.

    Exact for nested Lagrange spaces; replaces the reference's
    buildRestrictionProlongation tables (restrictionProlongation.pyx).
    Assumes dmFine.mesh is the uniform refinement of dmCoarse.mesh (children
    of coarse cell c are fine cells c + k*C, k < 2^mdim, as produced by
    simplexMesh.refine)."""
    meshC, meshF = dmCoarse.mesh, dmFine.mesh
    C = meshC.num_cells
    mdim = meshC.manifold_dim
    nchild = meshF.num_cells // C
    assert nchild * C == meshF.num_cells

    # physical coords of fine dof nodes per fine cell
    VF = meshF.vertices[meshF.cells]                     # [CF, m+1, dim]
    nodesF = np.einsum('jk,ckd->cjd', dmFine.localNodes, VF)  # [CF, dpeF, dim]

    # barycentric coords of those points within the parent coarse cell
    parents = np.tile(np.arange(C), nchild)
    VC = meshC.vertices[meshC.cells[parents]]            # [CF, m+1, dim]
    v0 = VC[:, 0, :]
    span = VC[:, 1:, :] - v0[:, None, :]                 # [CF, m, dim]
    if mdim == meshC.dim:
        spanInv = np.linalg.inv(span)
        xi = np.einsum('cjd,cdm->cjm', nodesF - v0[:, None, :], spanInv)
    else:
        G = np.einsum('cid,cjd->cij', span, span)
        rhs = np.einsum('cjd,cmd->cjm', nodesF - v0[:, None, :], span)
        xi = np.einsum('cjm,cmn->cjn', rhs, np.linalg.inv(G))
    bary = np.concatenate([1.0 - xi.sum(axis=2, keepdims=True), xi], axis=2)

    rows, cols, vals = [], [], []
    dofsF = dmFine.dofs
    dofsC = dmCoarse.dofs
    dpeF = dofsF.shape[1]
    CF = meshF.num_cells
    # evaluate all coarse basis functions at all fine nodes (per fine cell)
    baryFlat = bary.reshape(-1, mdim + 1)
    PHI = dmCoarse.evalPhi(baryFlat)                     # [dpeC, CF*dpeF]
    PHI = PHI.reshape(-1, CF, dpeF)                      # [dpeC, CF, dpeF]
    dpeC = PHI.shape[0]

    fRow = np.broadcast_to(dofsF[None, :, :], (dpeC, CF, dpeF))
    cCol = np.broadcast_to(dofsC[parents].T[:, :, None], (dpeC, CF, dpeF))
    mask = (fRow >= 0) & (cCol >= 0) & (np.abs(PHI) > 1e-14)
    rows = fRow[mask]
    cols = cCol[mask]
    vals = PHI[mask]
    P = sp.coo_matrix((vals, (rows, cols)),
                      shape=(dmFine.num_dofs, dmCoarse.num_dofs)).tocsr()
    # duplicates: same fine dof seen from several cells -> average (values
    # agree for nested spaces, so sum/count is exact)
    cnt = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                        shape=P.shape).tocsr()
    P.sort_indices()
    cnt.sort_indices()
    P.data = P.data / cnt.data
    P.eliminate_zeros()
    if dtype is not None:
        P = P.astype(dtype)
    return CSR_LinearOperator.from_scipy(P)


def buildMeshHierarchy(mesh0, noRef):
    """List of meshes from mesh0 by uniform refinement."""
    meshes = [mesh0]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    return meshes


def pCoarsenHierarchy(mesh, orders=('P1', 'P2', 'P3'), assembler=None,
                      tag=None):
    """p-multigrid hierarchy on ONE mesh: coarser levels are lower
    polynomial orders, prolongation interpolates between the nested Lagrange
    spaces (ref hierarchies.py:261 pCoarsenHierarchy, connectors.py:347
    pCoarsenConnector)."""
    from ..fem.dofmaps import dofmapFactory
    if assembler is None:
        from ..fem.assembly import assembleStiffness
        assembler = assembleStiffness
    levels = []
    dmPrev = None
    for o in orders:
        dm = dofmapFactory(o, mesh) if tag is None \
            else dofmapFactory(o, mesh, tag=tag)
        entry = {'A': assembler(dm), 'dm': dm}
        if dmPrev is not None:
            entry['P'] = buildProlongation(dmPrev, dm)
        levels.append(entry)
        dmPrev = dm
    return levels


class _mgLevels:
    """Pytree container: per-level A, P (to this level), damped-Jacobi
    diagonal, plus dense coarse LU factors.

    smootherKind 'jacobi' (default) or 'chebyshev'; for Chebyshev the
    per-level spectral radii of D^{-1}A are static setup constants
    (ref smoothers.pyx chebyshevSmoother:439)."""

    def __init__(self, As, Ps, Dinvs, omega, coarse_lu, coarse_piv,
                 preSteps=1, postSteps=1, smootherKind='jacobi', rhos=None,
                 precOps=None):
        self.As = As
        self.Ps = Ps                # Ps[l] : level l-1 -> l, Ps[0] unused
        self.Dinvs = Dinvs
        self.omega = omega
        self.coarse_lu = coarse_lu
        self.coarse_piv = coarse_piv
        self.preSteps = preSteps
        self.postSteps = postSteps
        self.smootherKind = smootherKind
        self.rhos = rhos
        # per-level preconditioner appliers for the ILU smoother (host
        # triangular solves via pure_callback; ref smoothers.pyx:482)
        self.precOps = precOps


jax.tree_util.register_pytree_node(
    _mgLevels,
    lambda m: ((m.As, m.Ps, m.Dinvs, m.omega, m.coarse_lu, m.coarse_piv),
               (m.preSteps, m.postSteps, m.smootherKind,
                tuple(m.rhos) if m.rhos is not None else None,
                tuple(m.precOps) if m.precOps is not None else None)),
    lambda s, d: _mgLevels(*d, preSteps=s[0], postSteps=s[1],
                           smootherKind=s[2],
                           rhos=list(s[3]) if s[3] is not None else None,
                           precOps=list(s[4]) if s[4] is not None else None))


def _chebSmooth(A, Dinv, b, x, rho, degree, lowerFrac=0.25, zeroGuess=False):
    """Chebyshev semi-iterative smoother targeting D^{-1}A eigenvalues in
    [lowerFrac*rho, rho] (ref smoothers.pyx:439; no sequential dependency)."""
    lmax = rho
    lmin = lowerFrac * rho
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rhok = 1.0 / sigma
    r = b if zeroGuess else b - A.matvec(x)
    d = (Dinv * r) / theta
    x = (d if zeroGuess else x + d)
    for _ in range(degree - 1):
        rhokp = 1.0 / (2.0 * sigma - rhok)
        r = b - A.matvec(x)
        d = rhokp * rhok * d + (2.0 * rhokp / delta) * (Dinv * r)
        x = x + d
        rhok = rhokp
    return x


def _vcycle(levels: _mgLevels, lvl, b, x, gamma=1):
    """Recursive V/W cycle (ref multigrid pxi solveOnLevel:237-291).  Python
    recursion over a static level count — unrolls under jit."""
    if lvl == 0:
        # mixed-precision hierarchies (f32 fine levels with an f64 coarse
        # factor or vice versa): solve at the factor's dtype
        return jax.scipy.linalg.lu_solve(
            (levels.coarse_lu, levels.coarse_piv),
            b.astype(levels.coarse_lu.dtype)).astype(b.dtype)
    A = levels.As[lvl]
    Dinv = levels.Dinvs[lvl]
    om = levels.omega
    cheb = levels.smootherKind == 'chebyshev'
    ilu = levels.smootherKind == 'ilu'
    # presmooth (first sweep exploits x=0)
    if cheb:
        x = _chebSmooth(A, Dinv, b, x, levels.rhos[lvl], levels.preSteps,
                        zeroGuess=True)
    elif ilu:
        M = levels.precOps[lvl]
        x = M.matvec(b)
        for _ in range(levels.preSteps - 1):
            x = x + M.matvec(b - A.matvec(x))
    else:
        x = om * (Dinv * b)
        for _ in range(levels.preSteps - 1):
            x = x + om * (Dinv * (b - A.matvec(x)))
    # coarse correction
    res = b - A.matvec(x)
    P = levels.Ps[lvl]
    defect = P.rmatvec(res)                       # R = P^T
    xc = jnp.zeros_like(defect)
    for _ in range(gamma):
        xc = _vcycle(levels, lvl - 1, defect, xc, gamma)
    x = x + P.matvec(xc)
    # postsmooth
    if cheb:
        x = _chebSmooth(A, Dinv, b, x, levels.rhos[lvl], levels.postSteps)
    elif ilu:
        M = levels.precOps[lvl]
        for _ in range(levels.postSteps):
            x = x + M.matvec(b - A.matvec(x))
    else:
        for _ in range(levels.postSteps):
            x = x + om * (Dinv * (b - A.matvec(x)))
    return x


@partial(jax.jit, static_argnames=('gamma',))
def _mg_apply(levels, b, gamma=1):
    nl = len(levels.As) - 1
    return _vcycle(levels, nl, b, jnp.zeros_like(b), gamma)


@partial(jax.jit, static_argnames=('gamma', 'maxiter'))
def _mg_solve(levels, b, x0, tol, maxiter, gamma=1):
    A = levels.As[-1]
    nl = len(levels.As) - 1

    def cond(state):
        x, k, rn = state
        return (rn > tol) & (k < maxiter)

    def body(state):
        x, k, rn = state
        r = b - A.matvec(x)
        x = x + _vcycle(levels, nl, r, jnp.zeros_like(b), gamma)
        rn = jnp.linalg.norm(b - A.matvec(x))
        return (x, k + 1, rn)

    rn0 = jnp.linalg.norm(b - A.matvec(x0))
    x, iters, rn = jax.lax.while_loop(cond, body, (x0, jnp.int32(0), rn0))
    return x, iters, rn


@partial(jax.jit, static_argnames=('gamma', 'maxiter'))
def _fmg_solve(levels, b, gamma=1, maxiter=1):
    """Full multigrid pass: coarsen rhs to every level, exact solve on the
    coarsest, then prolong + one cycle per intermediate level; at the FINEST
    level only prolongation + postsmoothing (ref multigrid pxi FMG branch:
    the last level does P.matvec then smoother.eval(postsmoother=True), no
    full cycle)."""
    nl = len(levels.As) - 1
    rhss = [None] * (nl + 1)
    rhss[nl] = b
    for l in range(nl - 1, -1, -1):
        rhss[l] = levels.Ps[l + 1].rmatvec(rhss[l + 1])
    x = jax.scipy.linalg.lu_solve(
        (levels.coarse_lu, levels.coarse_piv),
        rhss[0].astype(levels.coarse_lu.dtype)).astype(rhss[0].dtype)
    for l in range(1, nl):
        x = levels.Ps[l].matvec(x)
        r = rhss[l] - levels.As[l].matvec(x)
        x = x + _vcycle(levels, l, r, jnp.zeros_like(x), gamma)
    x = levels.Ps[nl].matvec(x)
    A = levels.As[nl]
    Dinv = levels.Dinvs[nl]
    om = levels.omega
    if levels.smootherKind == 'chebyshev':
        x = _chebSmooth(A, Dinv, b, x, levels.rhos[nl], levels.postSteps)
    elif levels.smootherKind == 'ilu':
        M = levels.precOps[nl]
        for _ in range(levels.postSteps):
            x = x + M.matvec(b - A.matvec(x))
    else:
        for _ in range(levels.postSteps):
            x = x + om * (Dinv * (b - A.matvec(x)))
    return x


class multigrid(iterative_solver):
    """MG solver over a level list [{'A':..., 'P':..., ('R':...)}, ...]
    ordered coarse -> fine (ref multigrid pxi:86)."""

    def __init__(self, hierarchy=None, smoother=('jacobi', {'omega': 2.0 / 3.0}),
                 deviceMesh=None, shardThreshold=2000, **kwargs):
        self.hierarchyList = hierarchy
        A = hierarchy[-1]['A'] if hierarchy else None
        super().__init__(A)
        self.num_rows = A.num_rows if A is not None else -1
        self.smootherType = smoother
        self.maxIter = 50
        self.cycle = 'V'
        # S2 (distributed GMG, ref algebraicOverlaps.pyx:794-1050 +
        # levels.py:262-298): with a device mesh, levels above the threshold
        # get row-sharded operators (CSR halo / distributed H2); smoothers
        # are Jacobi/Chebyshev, whose diagonal scaling is local, so the only
        # communication per smoothing step is the matvec's halo exchange.
        # Coarse levels stay replicated (ref S5 coarse gather).
        self.deviceMesh = deviceMesh
        self.shardThreshold = shardThreshold

    def _shardOperator(self, A):
        """Wrap a level operator for multi-device execution."""
        from ..parallel.dist_h2 import (DistributedH2Matrix,
                                        DistributedCSROperator)
        from ..nl.h2 import H2Matrix
        if isinstance(A, H2Matrix):
            return DistributedH2Matrix(A, self.deviceMesh)
        if hasattr(A, 'rowids'):
            return DistributedCSROperator(A, self.deviceMesh)
        return A

    def setup(self, A=None):
        levels = self.hierarchyList
        As, Ps, Dinvs = [], [], []
        omega = 2.0 / 3.0
        pre = post = 1
        kind = 'jacobi'
        if isinstance(self.smootherType, tuple):
            kind = self.smootherType[0]
            omega = self.smootherType[1].get('omega', omega)
            pre = self.smootherType[1].get('presmoothingSteps',
                                           3 if kind == 'chebyshev' else 1)
            post = self.smootherType[1].get('postsmoothingSteps', pre)
        elif isinstance(self.smootherType, str):
            kind = self.smootherType
            if kind == 'chebyshev':
                pre = post = 3
        shard = (self.deviceMesh is not None
                 and int(self.deviceMesh.devices.size) > 1)
        for lvlNo, lvl in enumerate(levels):
            A_ = lvl['A']
            if shard and lvlNo > 0 and A_.num_rows >= self.shardThreshold:
                A_ = self._shardOperator(A_)
            As.append(A_)
            Ps.append(lvl.get('P', None) if lvlNo > 0 else None)
            Dinvs.append(1.0 / A_.diagonal)
        if shard:
            self.A = As[-1]
        rhos = None
        precOps = None
        if kind == 'chebyshev':
            from ..base.linalg import estimateSpectralRadius
            rhos = [estimateSpectralRadius(A_, Dinv_)
                    for A_, Dinv_ in zip(As, Dinvs)]
        elif kind == 'ilu':
            # ILU smoother (ref smoothers.pyx:482 iluSmoother): factors on
            # host, applied through pure_callback inside the jitted cycle
            from ..base.solvers import ilu_solver
            precOps = []
            for lvlNo, lvl in enumerate(levels):
                if lvlNo == 0:
                    precOps.append(None)
                    continue
                s = ilu_solver(A=lvl['A'])
                # SuperLU's fill_factor=1 (the reference solver default)
                # truncates too aggressively for smoothing; allow the full
                # ILU fill
                s.fill_factor = 10.0
                s.setup()
                precOps.append(s.asPreconditioner())
        A0 = jnp.asarray(levels[0]['A'].toarray())
        lu, piv = jax.scipy.linalg.lu_factor(A0)
        self.levels = _mgLevels(As, Ps, Dinvs, omega, lu, piv,
                                preSteps=pre, postSteps=post,
                                smootherKind=kind, rhos=rhos,
                                precOps=precOps)
        self.initialized = True

    def solve(self, b, x=None):
        """Host-driven iteration over jitted cycles, recording the residual
        history (ref multigrid pxi solve loop: FMG counts as iteration 1 and
        seeds the V-cycle loop; residuals list starts with the residual
        before the first V-cycle)."""
        b = jnp.asarray(b)
        tol = self._tol(b)
        gamma = 2 if self.cycle in ('W', 'FMG_W') else 1
        if self.cycle in ('FMG_V', 'FMG_W'):
            x = _fmg_solve(self.levels, b, gamma=gamma)
            iters = 1
        else:
            x = self.x0 if self.x0 is not None else jnp.zeros_like(b)
            iters = 0
        A = self.A
        rn = float(jnp.linalg.norm(b - A.matvec(x)))
        residuals = [rn]
        while rn > tol and iters < self.maxIter:
            iters += 1
            x = x + _mg_apply(self.levels, b - A.matvec(x), gamma=gamma)
            rn = float(jnp.linalg.norm(b - A.matvec(x)))
            residuals.append(rn)
        self.iterations = iters
        self.residuals = residuals
        return x

    def asPreconditioner(self, maxIter=1, cycle='V'):
        return mgPreconditioner(self.levels, cycle)


class mgPreconditioner(LinearOperator):
    """One MG cycle as a pytree operator (ref multigridPreconditioner
    pxi:470)."""

    def __init__(self, levels, cycle='V'):
        self.levels = levels
        self.cycle = cycle
        self.num_rows = self.num_columns = levels.As[-1].num_rows

    def matvec(self, b):
        return _mg_apply(self.levels, b, gamma=2 if self.cycle == 'W' else 1)


jax.tree_util.register_pytree_node(
    mgPreconditioner,
    lambda m: ((m.levels,), (m.cycle,)),
    lambda s, d: mgPreconditioner(d[0], s[0]))


solverFactory.register('mg', multigrid, isMultilevelSolver=True)
