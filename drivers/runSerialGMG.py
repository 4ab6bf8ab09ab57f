#!/usr/bin/env python3
"""Serial geometric multigrid on local PDE problems (Poisson on the unit
square/interval), comparing MG/FMG cycles and (preconditioned) Krylov
solvers.

Counterpart of the reference's drivers/runSerialGMG.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from pynucleus_tpu.base import driver, solverFactory
from pynucleus_tpu.fem import (meshFactory, str2DoFMap, assembleStiffness,
                               assembleMass, assembleRHS, Lambda,
                               P1_DoFMap)
from pynucleus_tpu.fem.pdeProblems import diffusionProblem
from pynucleus_tpu.multilevel.gmg import buildProlongation, multigrid


def main(argv=None):
    d = driver()
    p = diffusionProblem(d)
    solver = d.addGroup('solver')
    d.add('smoother', 'jacobi', group=solver)
    d.add('maxiter', 50, group=solver)
    d.process(argv=argv)

    # mesh hierarchy (ref meshFactory.build bootstrap: refine until the
    # P1 space has dofs, then noRef uniform refinements)
    mesh = p.mesh0
    while P1_DoFMap(mesh).num_dofs == 0:
        mesh = mesh.refine()
    meshes = [mesh]
    for _ in range(d.noRef):
        meshes.append(meshes[-1].refine())
    DM = str2DoFMap[d.element]
    dms = [DM(m) for m in meshes]
    dm = dms[-1]
    mesh = meshes[-1]

    hierarchy = []
    for lvl, dmL in enumerate(dms):
        entry = {'A': assembleStiffness(dmL)}
        if lvl > 0:
            P = buildProlongation(dms[lvl - 1], dmL)
            entry['P'] = P
            entry['R'] = P.T
        hierarchy.append(entry)
    A = hierarchy[-1]['A']

    h = mesh.h
    tol = {'P1': 0.5 * h ** 2, 'P2': 1e-3 * h ** 3,
           'P3': 1e-3 * h ** 4}[d.element]

    rhs = assembleRHS(dm, p.rhsFun)
    b = rhs.data

    smootherParams = {'jacobi': {'presmoothingSteps': 2,
                                 'postsmoothingSteps': 2,
                                 'omega': 2.0 / 3.0}}
    ml = multigrid(hierarchy=hierarchy,
                   smoother=(d.smoother, smootherParams[d.smoother]))
    ml.tolerance = tol
    ml.maxIter = d.maxiter
    ml.setup()

    r0 = float(jnp.linalg.norm(b))

    info = d.addOutputGroup('info')
    info.add('DoFs', dm.num_dofs)
    info.add('element', d.element)
    info.add('Tol', tol)
    info.log()

    rate = d.addOutputGroup('rates', tested=True, aTol=1e-2)
    its = d.addOutputGroup('iterations', tested=True)
    res = d.addOutputGroup('residuals', tested=True, rTol=3e-1)
    errors = d.addOutputGroup('errors', tested=True, rTol=2.0)

    x = None
    for cycle, label in [('V', 'MG'), ('FMG_V', 'FMG')]:
        ml.cycle = cycle
        x = ml.solve(b)
        numIter = ml.iterations
        resNorm = float(jnp.linalg.norm(b - A @ x))
        rate.add('Rate of convergence ' + label, (resNorm / r0) ** (1 / numIter))
        its.add('Number of iterations ' + label, numIter)
        res.add('Residual norm ' + label, resNorm)

    for name, label, maxi in [('cg', 'CG', d.maxiter),
                              ('gmres', 'GMRES', d.maxiter // 5),
                              ('bicgstab', 'BICGSTAB', d.maxiter)]:
        s = solverFactory.build(name, A=A, setup=True)
        s.tolerance = tol
        s.maxIter = maxi
        if name == 'gmres':
            s.restarts = 5
        x = s.solve(b)
        numIter = max(s.iterations, 1)
        resNorm = float(jnp.linalg.norm(b - A @ x))
        rate.add('Rate of convergence ' + label, (resNorm / r0) ** (1 / numIter))
        its.add('Number of iterations ' + label, numIter)
        res.add('Residual norm ' + label, resNorm)

        s2 = solverFactory.build(name, A=A, setup=True)
        s2.tolerance = tol
        s2.maxIter = maxi
        if name == 'gmres':
            s2.restarts = 5
        s2.setPreconditioner(ml.asPreconditioner())
        x = s2.solve(b)
        numIter = max(s2.iterations, 1)
        resNorm = float(jnp.linalg.norm(b - A @ x))
        rate.add('Rate of convergence P' + label, (resNorm / r0) ** (1 / numIter))
        its.add('Number of iterations P' + label, numIter)
        res.add('Residual norm P' + label, resNorm)

    if p.L2ex is not None:
        M = assembleMass(dm)
        z = assembleRHS(dm, p.exactSolution)
        L2err = float(np.sqrt(abs(jnp.vdot(x, M @ x) - 2 * jnp.vdot(z.data, x)
                                  + p.L2ex)))
        errors.add('L^2 error', L2err)
        errors.add('L^2 error constant', L2err / h ** 2)
    if p.H10ex is not None:
        H10err = float(np.sqrt(abs(p.H10ex - jnp.vdot(b, x))))
        errors.add('H^1_0 error', H10err)
        errors.add('H^1_0 error constant', H10err / h)

    for g in (rate, its, res, errors):
        g.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
