#!/usr/bin/env python3
"""Operator interpolation over the fractional order s (counterpart of
/root/reference/examples/example_operator_interpolation.py).

The family (-Delta)^s for s in [0.05, 0.95] is approximated by Chebyshev
interpolation over sub-intervals; node operators are assembled lazily, so
re-solving for nearby values of s is fast."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import solverFactory
from pynucleus_tpu.fem import meshFactory, dofmapFactory, functionFactory
from pynucleus_tpu.nl.kernels import kernelFactory
from pynucleus_tpu.nl.assembly import assembleNonlocal
from pynucleus_tpu.nl.operator_interpolation import admissibleSet


def main():
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(6):
        mesh = mesh.refine()
    dm = dofmapFactory('P1', mesh)
    from pynucleus_tpu.fem import assembleRHS
    b = np.asarray(assembleRHS(dm, functionFactory('constant',
                                                   value=1.)).data)

    kernel = kernelFactory('fractional', s=admissibleSet([0.05, 0.95]),
                           dim=1)
    t0 = time.perf_counter()
    A = assembleNonlocal(dm, kernel, matrixFormat='dense')
    print('operator creation: {:.3f}s ({} interpolation nodes, lazy)'
          .format(time.perf_counter() - t0, A.getNumInterpolationNodes()))

    for sVal in (0.75, 0.76, 0.3):
        t0 = time.perf_counter()
        A.set(sVal)
        solver = solverFactory('cg-jacobi', A=A, setup=True)
        solver.maxIter = 1000
        solver.tolerance = 1e-8
        u = np.asarray(solver(b, np.zeros(dm.num_dofs)))
        print('s={}: solved in {:.3f}s, |u|_max = {:.5f}'
              .format(sVal, time.perf_counter() - t0, u.max()))
    return A


if __name__ == '__main__':
    main()
