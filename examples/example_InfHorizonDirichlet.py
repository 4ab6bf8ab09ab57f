#!/usr/bin/env python3
"""Inhomogeneous Dirichlet volume condition for an infinite-horizon
fractional kernel (counterpart of
/root/reference/examples/example_InfHorizonDirichlet.py).

  (-Delta)^s u = f  in Omega = (-1/2, 1/2),
  u = g             in Omega_I = (-1, 1) \\ Omega,
  u = 0             outside (-1, 1),

with f = 1 and g chosen from the exact solution u = C (1-x^2)_+^s of the
fractional Poisson problem on (-1, 1), so the subdomain problem is exact.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import solverFactory
from pynucleus_tpu.fem import (meshFactory, functionFactory, assembleRHS,
                               squareIndicator)
from pynucleus_tpu.fem.dofmaps import P1_DoFMap
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def main():
    s = 0.75
    kernel = getFractionalKernel(1, s)
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(7):
        mesh = mesh.refine()
    eps = 1e-9
    interiorInd = squareIndicator(np.array([-0.5 + eps]),
                                  np.array([0.5 - eps]))
    bcInd = (functionFactory('constant', value=1.) - interiorInd)
    dmInterior = P1_DoFMap(mesh, tag=interiorInd)
    dmBC = dmInterior.getComplementDoFMap()
    print(dmInterior)

    A = nonlocalBuilder(dmInterior, kernel).getDense()
    A_BC = nonlocalBuilder(dmInterior, kernel, dm2=dmBC).getDenseCross()

    exact = functionFactory('solFractional', s=s, dim=1)
    g = np.asarray(dmBC.interpolate(exact).data)
    f = assembleRHS(dmInterior, functionFactory('constant', value=1.))
    b = np.asarray(f.data) - np.asarray(A_BC @ g)

    u = np.asarray(solverFactory('lu', A=A, setup=True)(
        b, np.zeros(dmInterior.num_dofs)))
    uex = np.asarray(dmInterior.interpolate(exact).data)
    err = np.abs(u - uex).max()
    print('Linf error vs exact:', err)
    assert err < 5e-3
    return u


if __name__ == '__main__':
    main()
