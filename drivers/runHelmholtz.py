#!/usr/bin/env python3
"""Complex Helmholtz with impedance boundary conditions, solved by GMRES
preconditioned with a complex-shifted-Laplacian geometric multigrid.

Counterpart of the reference's drivers/runHelmholtz.py:
  A      = S - omega^2 M + i omega MB            (solve operator)
  A_prec = A + 0.5 i omega^2 M                   (shifted MG hierarchy)
where MB is the boundary mass matrix; coarse-level MB is the Galerkin
restriction R MB P.  Everything runs in complex128 on device; the multigrid
cycle and GMRES are the same jitted kernels as the real path.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp

from pynucleus_tpu.base import driver, solverFactory
from pynucleus_tpu.base.linear_operators import CSR_LinearOperator
from pynucleus_tpu.fem import (str2DoFMap, assembleStiffness, assembleMass,
                               assembleRHS)
from pynucleus_tpu.fem.assembly import (assembleSurfaceMass,
                                        assembleSurfaceRHS)
from pynucleus_tpu.fem.meshes import NO_BOUNDARY
from pynucleus_tpu.fem.pdeProblems import helmholtzProblem
from pynucleus_tpu.multilevel.gmg import buildProlongation, multigrid


def _toScipy(A):
    return sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                          np.asarray(A.indptr)),
                         shape=(A.num_rows, A.num_columns))


def _fromScipy(S):
    S = S.tocsr()
    S.sort_indices()
    return CSR_LinearOperator.from_scipy(S)


def main(argv=None):
    d = driver()
    p = helmholtzProblem(d)
    d.add('maxiter', 300)
    d.process(argv=argv)

    # hierarchy structure as in runParallelGMG (ref paramsForMG + input
    # connector: exactly-solved coarse level one past the formula's cg)
    meshes = [p.mesh0]
    for _ in range(p.noRef):
        meshes.append(meshes[-1].refine())
    mdim = meshes[0].manifold_dim
    numInitialCells = {1: 2, 2: 8, 3: 48}[mdim]
    numCells = numInitialCells * (2 ** mdim) ** np.arange(p.noRef + 1)
    cg = 0
    while numCells[cg + 1] < 4500 and cg < p.noRef - 1:
        cg += 1
    cg = min(cg + 1, p.noRef - 1)
    meshes = meshes[cg:]
    DM = str2DoFMap[d.element]
    # impedance (Robin) BC: every dof is free
    dms = [DM(m, tag=NO_BOUNDARY) for m in meshes]
    dm = dms[-1]
    mesh = meshes[-1]
    freq = d.frequency

    Ss = [_toScipy(assembleStiffness(dmL)) for dmL in dms]
    Ms = [_toScipy(assembleMass(dmL)) for dmL in dms]
    Ps = [None] + [buildProlongation(dms[l - 1], dms[l])
                   for l in range(1, len(dms))]
    # fine-level boundary mass, Galerkin-restricted to the coarse levels
    # (ref runHelmholtz.py:85-92)
    MBs = [None] * len(dms)
    MBs[-1] = assembleSurfaceMass(dm)
    for l in range(len(dms) - 2, -1, -1):
        Pl = _toScipy(Ps[l + 1])
        MBs[l] = (Pl.T @ MBs[l + 1] @ Pl).tocsr()

    def getOp(l, shift=0.0):
        A = (Ss[l] - freq ** 2 * Ms[l]).astype(np.complex128) \
            + 1j * freq * MBs[l]
        if shift:
            A = A + 1j * shift * freq ** 2 * Ms[l]
        return _fromScipy(A)

    hierarchy = []
    for l in range(len(dms)):
        entry = {'A': getOp(l, shift=0.5)}
        if l > 0:
            entry['P'] = Ps[l]
            entry['R'] = Ps[l].T
        hierarchy.append(entry)

    tol = max(1e-5, 2e-9)
    ml = multigrid(hierarchy=hierarchy,
                   smoother=('jacobi', {'omega': 0.8,
                                        'presmoothingSteps': 2,
                                        'postsmoothingSteps': 2}))
    ml.tolerance = tol
    ml.maxIter = d.maxiter
    ml.setup()

    A = getOp(len(dms) - 1, shift=0.0)
    M = _fromScipy(Ms[-1].astype(np.complex128))

    b = jnp.asarray(assembleRHS(dm, p.rhs, qOrder=3).data,
                    dtype=jnp.complex128)
    if p.boundaryCond is not None:
        b = b + jnp.asarray(assembleSurfaceRHS(dm, p.boundaryCond))

    gmres = solverFactory.build('gmres', A=A, setup=True)
    gmres.maxIter = d.maxiter
    gmres.restarts = 1
    gmres.tolerance = tol
    gmres.setPreconditioner(ml.asPreconditioner(), left=False)
    x = gmres.solve(b)
    res = gmres.residuals[1:]  # ref residuals exclude the initial residual

    info = d.addOutputGroup('info')
    info.add('DoFs', dm.num_dofs)
    info.add('h', mesh.h)
    info.add('frequency', freq)
    info.log()

    results = d.addOutputGroup('results', tested=True)
    results.add('Tolerance', tol)
    results.add('numIter', len(res))
    results.add('res', float(res[-1]))
    L2 = float(np.sqrt(abs(jnp.vdot(x, M @ x))))
    results.add('solution L2 norm', L2)
    if p.solEx is not None:
        xEx = jnp.asarray(dm.interpolate(p.solEx).data)
        diff = x - xEx
        L2err = float(np.sqrt(abs(jnp.vdot(diff, M @ diff))))
        results.add('L2 error', L2err)
    results.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
