#!/usr/bin/env python3
"""API walkthrough: assemble and solve a nonlocal Poisson problem
(counterpart of /root/reference/examples/example_nonlocal.py:17-80).

A finite-horizon constant (indicator) kernel on an interval with
homogeneous Dirichlet volume condition; then the fractional kernel with
known exact solution on the disc.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import solverFactory
from pynucleus_tpu.fem import dofmapFactory, functionFactory, assembleRHS
from pynucleus_tpu.fem.dofmaps import P1_DoFMap
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.kernels import kernelFactory
from pynucleus_tpu.nl.problems import (nonlocalMeshFactory,
                                       HOMOGENEOUS_DIRICHLET)
from pynucleus_tpu.nl.assembly import assembleNonlocal


def main():
    # ---- finite-horizon indicator kernel on an interval
    kernel = kernelFactory('indicator', dim=1, horizon=0.2)
    mesh, nI = nonlocalMeshFactory.build(
        'interval', kernel=kernel, boundaryCondition=HOMOGENEOUS_DIRICHLET,
        a=-1, b=1)
    for _ in range(4):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, tag=nI['domain'])
    print(dm)
    A = assembleNonlocal(dm, kernel, matrixFormat='sparse')
    b = assembleRHS(dm, functionFactory('constant', value=1.))
    solver = solverFactory('cg', A=A, setup=True)
    solver.tolerance = 1e-10
    solver.maxIter = 1000
    u = np.asarray(solver(np.asarray(b.data), np.zeros(dm.num_dofs)))
    print('max u:', u.max())

    # ---- infinite-horizon fractional kernel with exact solution
    s = 0.75
    kernel = getFractionalKernel(1, s)
    mesh2, nI2 = nonlocalMeshFactory.build(
        'interval', kernel=kernel, boundaryCondition=HOMOGENEOUS_DIRICHLET,
        a=-1, b=1)
    for _ in range(6):
        mesh2 = mesh2.refine()
    dm2 = P1_DoFMap(mesh2, tag=nI2['domain'])
    A2 = assembleNonlocal(dm2, kernel, matrixFormat='dense')
    b2 = assembleRHS(dm2, functionFactory('constant', value=1.))
    u2 = np.asarray(solverFactory('lu', A=A2, setup=True)(
        np.asarray(b2.data), np.zeros(dm2.num_dofs)))
    exact = functionFactory('solFractional', s=s, dim=1)
    uex = np.asarray(dm2.interpolate(exact).data)
    err = np.abs(u2 - uex).max()
    print('fractional solve Linf error vs exact:', err)
    assert err < 5e-3
    return u, u2


if __name__ == '__main__':
    main()
