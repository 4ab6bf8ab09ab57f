#!/usr/bin/env python3
"""Fractional-order Brusselator reaction-diffusion system

          du/dt = -(-Delta)^alpha u + (B-1)u + Q^2 v + (B/Q)u^2 + 2Quv + u^2 v
  eta^2 * dv/dt = -(-Delta)^beta  v -  B   u - Q^2 v - (B/Q)u^2 - 2Quv - u^2 v

with zero-flux conditions, stepped IMEX (implicit fractional diffusion,
explicit nonlinearity).

Counterpart of the reference's drivers/brusselator.py +
brusselatorProblem (nonlocalProblems.py:2450-2592).  The whole IMEX step --
two mass matvecs, the nonlinearity, and two dense factorized solves -- runs
as one jitted device function; the time loop is a host loop over it.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from pynucleus_tpu.base import driver
from pynucleus_tpu.fem import assembleMass
from pynucleus_tpu.fem.dofmaps import P1_DoFMap
from pynucleus_tpu.fem.functions import Lambda
from pynucleus_tpu.nl.kernels import getFractionalKernel
from pynucleus_tpu.nl.problems import (nonlocalMeshFactory,
                                       HOMOGENEOUS_NEUMANN,
                                       HOMOGENEOUS_DIRICHLET)
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def main(argv=None):
    d = driver()
    d.add('domain', 'disc')
    d.add('bc', 'Neumann')
    d.add('noRef', 3)
    d.add('problem', 'spots')
    d.add('T', 2.0)
    d.add('dt', 0.01)
    d.add('seed', 42)
    d.add('outputStep', 10)
    d.add('hdf5Output', '')
    d.process(argv=argv)

    # parameters (ref nonlocalProblems.py:2495-2560, 'spots' linearization
    # point x=0.1, 'stripes' x=1.5)
    alpha = beta = 0.75
    eta = 0.2
    xLin = 0.1 if d.problem == 'spots' else 1.5
    s = alpha / beta
    Bcr = (1 + xLin) ** 2 / (1 + (1 - s) * xLin)
    B = Bcr + 0.01
    Q = np.sqrt(s * xLin ** (1 + 1 / s) / (1 + (1 - s) * xLin))

    kernelU = getFractionalKernel(2, alpha, horizon=np.inf)
    bc = HOMOGENEOUS_NEUMANN if d.bc == 'Neumann' else HOMOGENEOUS_DIRICHLET
    mesh, nI = nonlocalMeshFactory.build('disc', kernel=kernelU,
                                         boundaryCondition=bc,
                                         h=10., radius=50.)
    for _ in range(d.noRef):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, tag=nI['tag'])

    rng = np.random.default_rng(d.seed)
    R = 10.0
    if d.problem == 'spots':
        def iU(x):
            r2 = x[0] ** 2 + x[1] ** 2
            return (R ** 2 - r2) ** 2 / R ** 4 * eta if r2 < R ** 2 else 0.0

        def iV(x):
            r2 = x[0] ** 2 + x[1] ** 2
            return (R ** 2 - r2) ** 2 / R ** 4 / eta if r2 < R ** 2 else 0.0
    else:
        def iU(x):
            return rng.random() * eta

        def iV(x):
            return rng.random() / eta

    with d.timer('assemble'):
        S = jnp.asarray(nonlocalBuilder(
            dm, kernelU, zeroExterior=nI['zeroExterior']).getDense().toarray())
        M = jnp.asarray(assembleMass(dm).toarray())

    u = jnp.asarray(dm.interpolate(Lambda(iU)).data)
    v = jnp.asarray(dm.interpolate(Lambda(iV)).data)

    dt = d.dt
    N = int(np.around(d.T / dt))
    dt = d.T / N

    # IMEX Euler: (M + dt S) u+ = M u + dt M_proj f(u, v); the mass-projected
    # nonlinearity uses mass lumping (diagonal), accurate for P1 and keeps
    # the step a pure matvec chain (ref brusselator.py residual/solve split)
    lump = M.sum(axis=1)
    luU = jax.scipy.linalg.lu_factor(M + dt * S)
    luV = jax.scipy.linalg.lu_factor(eta ** 2 * M + dt * S)

    @jax.jit
    def step(u, v):
        quad = (B / Q) * u * u + 2 * Q * u * v + u * u * v
        fU = (B - 1) * u + Q ** 2 * v + quad
        fV = -B * u - Q ** 2 * v - quad
        rhsU = M @ u + dt * (lump * fU)
        rhsV = eta ** 2 * (M @ v) + dt * (lump * fV)
        return (jax.scipy.linalg.lu_solve(luU, rhsU),
                jax.scipy.linalg.lu_solve(luV, rhsV))

    info = d.addOutputGroup('info')
    info.add('dofs', dm.num_dofs)
    info.add('dt', dt)
    info.add('N', N)
    info.add('B', B)
    info.add('Q', Q)
    info.add('Bcr', Bcr)
    info.log()

    h5file = None
    if d.hdf5Output:
        import h5py
        h5file = h5py.File(d.hdf5Output, 'w')
        dm.HDF5write(h5file.create_group('data').create_group('dm'))
        grpU = h5file.create_group('U')
        grpV = h5file.create_group('V')
        grpU.create_dataset('0', data=np.asarray(u))
        grpV.create_dataset('0', data=np.asarray(v))

    for k in range(N):
        u, v = step(u, v)
        if (k + 1) % d.outputStep == 0:
            print('t=%.3f  |U|_max=%.4f  |V|_max=%.4f'
                  % ((k + 1) * dt, float(jnp.abs(u).max()),
                     float(jnp.abs(v).max())))
            if h5file is not None:
                grpU.create_dataset(str(k + 1), data=np.asarray(u))
                grpV.create_dataset(str(k + 1), data=np.asarray(v))
    if h5file is not None:
        h5file.close()

    results = d.addOutputGroup('results', tested=True)
    results.add('U max', float(jnp.abs(u).max()))
    results.add('V max', float(jnp.abs(v).max()))
    results.add('U L2', float(jnp.sqrt(u @ (M @ u))))
    results.add('V L2', float(jnp.sqrt(v @ (M @ v))))
    results.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
