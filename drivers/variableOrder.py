#!/usr/bin/env python3
"""Variable fractional order studies: assemble and solve fractional Poisson
problems for a family of spatially varying orders s(x, y) in dense (and
optionally H2) format.

Counterpart of the reference's drivers/variableOrder.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import driver, solverFactory, krylov_solver, invDiagonal
from pynucleus_tpu.fem import meshFactory, dofmapFactory, functionFactory
from pynucleus_tpu.nl.kernels import (getFractionalKernel,
                                      constFractionalOrder,
                                      variableConstFractionalOrder,
                                      leftRightFractionalOrder,
                                      innerOuterFractionalOrder)
from pynucleus_tpu.nl.assembly import assembleNonlocal


def main(argv=None):
    d = driver()
    d.add('domain', acceptedValues=['interval', 'square', 'circle'])
    d.add('do_dense', True)
    d.add('do_h2', False)
    d.add('do_transpose', False)
    d.add('solver', acceptedValues=['lu', 'cg', 'gmres'])
    d.add('maxIter', 1000)
    d.add('tol', 1e-7)
    d.add('element', acceptedValues=['P1', 'P0'])
    d.add('s1', 0.25)
    d.add('s2', 0.75)
    d.add('noRef', -1)
    d.declareFigure('variableOrder')
    d.process(argv=argv)

    s1, s2 = d.s1, d.s2
    smean = 0.5 * (s1 + s2)
    if d.domain == 'interval':
        noRef = d.noRef if d.noRef > 0 else 8
        mesh = meshFactory('interval', a=-1, b=1)
        if d.element == 'P0':
            assert s1 < 0.5 and s2 < 0.5
            sVals = [constFractionalOrder(s1),
                     constFractionalOrder(s2),
                     leftRightFractionalOrder(s1, s2),
                     leftRightFractionalOrder(s1, s2, s1, smean),
                     leftRightFractionalOrder(s1, s2, s2, smean)]
        else:
            sVals = [constFractionalOrder(s1),
                     constFractionalOrder(s2),
                     variableConstFractionalOrder(s1),
                     variableConstFractionalOrder(s2),
                     leftRightFractionalOrder(s1, s2, s1, s1),
                     leftRightFractionalOrder(s1, s2, smean, smean),
                     leftRightFractionalOrder(s1, s2, s2, s2)]
    elif d.domain == 'square':
        noRef = d.noRef if d.noRef > 0 else 5
        mesh = meshFactory('square', ax=-1, ay=-1, bx=1, by=1)
        sVals = [leftRightFractionalOrder(s1, s2)]
    elif d.domain == 'circle':
        noRef = d.noRef if d.noRef > 0 else 5
        mesh = meshFactory('disc', n=8)
        sVals = [innerOuterFractionalOrder(mesh.dim, s2, s1, 0.5)]
    else:
        raise NotImplementedError(d.domain)
    for _ in range(noRef):
        mesh = mesh.refine()

    dm = dofmapFactory(d.element, mesh)
    rhs = functionFactory('constant', value=1.)

    results = d.addOutputGroup('results', rTol=3e-2)
    for s in sVals:
        b = np.asarray(dm.assembleRHS(rhs))
        kernel = getFractionalKernel(mesh.dim, s)
        for label, do in [('dense', d.do_dense), ('H2', d.do_h2)]:
            if not do:
                continue
            with d.timer(label + ' assemble ' + str(s)):
                A = assembleNonlocal(dm, kernel, matrixFormat=label.lower())
            with d.timer(label + ' solve ' + str(s)):
                solver = solverFactory.build(d.solver, A=A, setup=True)
                solver.maxIter = d.maxIter
                solver.tolerance = d.tol
                if isinstance(solver, krylov_solver):
                    solver.setPreconditioner(invDiagonal(A))
                x = solver(b, np.zeros(dm.num_dofs))
            res = float(np.linalg.norm(np.asarray(A @ x) - b))
            numIter = len(getattr(solver, 'residuals', []) or [])
            results.add('{} {} resNorm'.format(label, s), res, rTol=1.0)
            results.add('{} {} norm'.format(label, s),
                        float(np.linalg.norm(np.asarray(x))))
            if not s.symmetric and d.do_transpose and label == 'dense':
                At = A.T
                solver = solverFactory.build(d.solver, A=At.to_dense(),
                                             setup=True)
                solver.maxIter = d.maxIter
                solver.tolerance = d.tol
                xt = solver(b, np.zeros(dm.num_dofs))
                results.add('{} {} transpose norm'.format(label, s),
                            float(np.linalg.norm(np.asarray(xt))))
    results.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
