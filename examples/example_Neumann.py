#!/usr/bin/env python3
"""Neumann (flux) condition for a finite-horizon kernel (counterpart of
/root/reference/examples/example_Neumann.py).

Indicator kernel gamma(x,y) = c(delta) chi_{B_delta(x)}(y), delta = 0.4:

  int (u(x)-u(y)) gamma dy = f  in Omega = (-1, 1),     f = 2
  int (u(x)-u(y)) gamma dy = g  in Omega_I = collar,

with g the flux of the exact solution u = C - x^2 (defined up to the
additive constant; the singular system is solved with CG and compared
after mean alignment)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import solverFactory
from pynucleus_tpu.fem import functionFactory, assembleRHS, Lambda
from pynucleus_tpu.fem.dofmaps import P1_DoFMap
from pynucleus_tpu.fem.meshes import intervalWithInteraction, NO_BOUNDARY
from pynucleus_tpu.nl.kernels import kernelFactory
from pynucleus_tpu.nl.assembly import assembleNonlocal


def main():
    horizon = 0.4
    kernel = kernelFactory('indicator', dim=1, horizon=horizon)
    C = kernel.scalingValue          # c(delta)/2 in the assembly convention
    mesh = intervalWithInteraction(a=-1, b=1, horizon=horizon,
                                   h=horizon / 8)
    for _ in range(2):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, tag=NO_BOUNDARY)   # all dofs are unknowns
    print(dm)

    A = assembleNonlocal(dm, kernel, matrixFormat='sparse')

    def rhsFun(x):
        # L[u](x) = 2C int_{I(x)} (u(x) - u(y)) dy for u = -x^2 over
        # I(x) = [max(-1-delta, x-delta), min(1+delta, x+delta)]:
        # equals f = 2 in the interior and the flux g on the collar
        # (ref example_Neumann.py fluxFun, in closed form)
        xv = x[0]
        a = max(-1.0 - horizon, xv - horizon)
        bnd = min(1.0 + horizon, xv + horizon)
        return 2 * C * ((bnd ** 3 - a ** 3) / 3.0 - xv ** 2 * (bnd - a))

    b = np.asarray(assembleRHS(dm, Lambda(rhsFun), qOrder=6).data)
    # compatibility: project out the constant nullspace component
    ones = np.ones(dm.num_dofs)
    M_lumped = np.asarray(assembleRHS(dm, functionFactory(
        'constant', value=1.)).data)
    b = b - (b.sum() / M_lumped.sum()) * M_lumped

    solver = solverFactory('cg', A=A, setup=True)
    solver.tolerance = 1e-10
    solver.maxIter = 2000
    u = np.asarray(solver(b, np.zeros(dm.num_dofs)))

    coords = dm.getDoFCoordinates()[:, 0]
    uex = -coords ** 2
    # align the additive constant by the lumped-mass mean
    shift = ((u - uex) * M_lumped).sum() / M_lumped.sum()
    err = np.abs(u - uex - shift).max()
    print('Linf error vs exact (mean-aligned):', err)
    assert err < 5e-3, err
    return u


if __name__ == '__main__':
    main()
