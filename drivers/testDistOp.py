#!/usr/bin/env python3
"""Distributed-operator test/benchmark: assemble the nonlocal operator in
dense/sparse/H2 formats, distribute it over a jax device mesh in 'bcast'
(replicated input vector) and 'halo' (sharded vector + ppermute neighbour
exchange) modes, cross-check the matvecs, and run a distributed CG solve.

Counterpart of the reference's drivers/testDistOp.py: the
reference's MPI ranks map to devices of a jax.sharding.Mesh; Bcast becomes a
replicated sharding, the halo exchange becomes lax.ppermute, and the
distributed CG inner products are jnp.vdot on sharded arrays (XLA inserts the
psum).  Rank counts do not change the numerics, matching the reference caches
where the 4-rank values are pinned.

Set PYNUCLEUS_RANKS=<n> (or --ranks) to choose the device count; under CPU
testing combine with XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from pynucleus_tpu.base import driver, solverFactory
from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator
from pynucleus_tpu.fem import assembleMass, assembleRHS, Lambda
from pynucleus_tpu.nl.problems import (fractionalLaplacianProblem,
                                       nonlocalPoissonProblem)
from pynucleus_tpu.nl.assembly import nonlocalBuilder
from pynucleus_tpu.parallel.dist import (makeDeviceMesh,
                                         DistributedRowBlockOperator,
                                         DistributedHaloOperator)
from pynucleus_tpu.parallel.dist_h2 import (DistributedH2Matrix,
                                            DistributedCSROperator)
from pynucleus_tpu.nl.h2 import H2Matrix


def main(argv=None):
    d = driver()
    import argparse
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--horizon', type=float, default=np.inf)
    preArgs, _ = pre.parse_known_args(argv)
    finiteHorizon = preArgs.horizon < np.inf

    if finiteHorizon:
        p = nonlocalPoissonProblem(d)
        # testDistOp defaults to the fractional kernel (ref
        # nonlocalProblems.py:322 base default), unlike runNonlocal
        if hasattr(d, 'parser'):
            d.parser.set_defaults(kernelType='fractional')
    else:
        p = fractionalLaplacianProblem(d)
    d.add('buildDense', False)
    d.add('buildSparse', False)
    d.add('buildH2', False)
    d.add('buildH2Reduced', False)
    d.add('buildDistributedH2Bcast', False)
    d.add('buildDistributedH2', True)
    d.add('doSolve', False)
    d.add('horizonToMeshSize', -1.)
    d.add('ranks', int(os.environ.get('PYNUCLEUS_RANKS', '4')))
    d.process(argv=argv)

    mesh = makeDeviceMesh(min(d.ranks, len(jax.devices())))

    from pynucleus_tpu.fem.dofmaps import str2DoFMap
    kernel = p.kernel
    m = p.mesh
    if d.horizonToMeshSize > 0 and kernel.finiteHorizon:
        # refine until horizon/h reaches the requested ratio
        # (ref testDistOp.py:96-99)
        while d.horizonToMeshSize > np.around(kernel.horizonValue / m.h, 5):
            m = m.refine()
    else:
        # p.mesh is the (bootstrapped) initial mesh; the driver owns the
        # refinement (ref testDistOp.py:93-95)
        for _ in range(d.noRef):
            m = m.refine()
    dm = str2DoFMap[d.element](m, tag=p.tag)

    info = d.addOutputGroup('info')
    info.add('mesh size', dm.mesh.h)
    info.add('DoFs', dm.num_dofs)
    info.add('devices', mesh.devices.size)
    info.log()

    analytic = p.analyticSolution
    if analytic is not None:
        x = jnp.asarray(dm.interpolate(analytic).data)
    else:
        # probe vector: sin in the first coordinate (ref testDistOp.py:126
        # functionFactory('sin1d'))
        x = jnp.asarray(dm.interpolate(
            Lambda(lambda xx: np.sin(np.pi * xx[0]))).data)

    builder = nonlocalBuilder(dm, kernel, zeroExterior=p.zeroExterior)

    ops = {}
    if d.buildDense:
        with d.timer('assemble dense'):
            ops['A_dense'] = builder.getDense()
    if d.buildSparse:
        with d.timer('assemble sparse'):
            ops['A_sparse'] = builder.getSparse()
    if d.buildH2:
        with d.timer('assemble H2'):
            ops['A_h2'] = builder.getH2()
    if d.buildH2Reduced:
        # the reference assembles on the global communicator and reduces to
        # rank 0; in the sharded model every device sees the same operator,
        # so the reduced build coincides with the plain one
        with d.timer('assemble H2 reduced'):
            ops['A_h2_reduced'] = builder.getH2()
    base = ops.get('A_h2', ops.get('A_sparse', ops.get('A_dense')))
    if d.buildDistributedH2Bcast:
        # global-vector mode (ref DistributedH2Matrix_globalData,
        # clusterMethodCy.pyx:3127): H2 structure stays intact, owners ship
        # full outboxes
        if isinstance(base, H2Matrix):
            ops['A_distributed_bcast'] = DistributedH2Matrix(
                base, mesh, bcast=True)
        else:
            ops['A_distributed_bcast'] = DistributedRowBlockOperator(
                base, mesh)
    if d.buildDistributedH2:
        # local-vector halo mode (ref DistributedH2Matrix_localData,
        # clusterMethodCy.pyx:3368): sharded near CSR + cluster coefficient
        # exchange -- no densification
        if isinstance(base, H2Matrix):
            ops['A_distributed_halo'] = DistributedH2Matrix(base, mesh)
        elif hasattr(base, 'rowids'):
            ops['A_distributed_halo'] = DistributedCSROperator(base, mesh)
        else:
            ops['A_distributed_halo'] = DistributedHaloOperator(base, mesh)

    ys = {k: np.asarray(op.matvec(x)) for k, op in ops.items()}

    matvecErrors = d.addOutputGroup('matvec errors', tested=True, rTol=1.)
    pairs = [('A_dense', 'A_h2', '|(A_dense - A_h2) * x |'),
             ('A_dense', 'A_h2_reduced', '|(A_dense - A_h2_reduced) * x|'),
             ('A_dense', 'A_distributed_bcast',
              '|(A_dense - A_distributed_bcast) * x|'),
             ('A_dense', 'A_distributed_halo',
              '|(A_dense - A_distributed_halo) * x|'),
             ('A_h2', 'A_h2_reduced', '|(A_h2 - A_h2_reduced) * x |'),
             ('A_h2', 'A_distributed_bcast',
              '|(A_h2 - A_distributed_bcast) * x|'),
             ('A_h2', 'A_distributed_halo',
              '|(A_h2 - A_distributed_halo) * x|'),
             ('A_sparse', 'A_distributed_bcast',
              '|(A_sparse - A_distributed_bcast) * x|'),
             ('A_sparse', 'A_distributed_halo',
              '|(A_sparse - A_distributed_halo) * x|')]
    for a, b, label in pairs:
        if a in ys and b in ys:
            matvecErrors.add(label, float(np.linalg.norm(ys[a] - ys[b])))
    matvecErrors.log()

    if d.doSolve and (d.buildDistributedH2 or d.buildDistributedH2Bcast):
        A_dist = ops.get('A_distributed_halo',
                         ops.get('A_distributed_bcast'))
        b = assembleRHS(dm, p.rhs, qOrder=3).data
        cg = solverFactory.build('cg', A=A_dist, setup=True)
        cg.maxIter = 1000
        u = cg.solve(jnp.asarray(b))
        iterCG = cg.iterations
        solveGroup = d.addOutputGroup('solve', tested=True, rTol=2e-1)
        solveGroup.add('residual norm', cg.residuals[-1])
        solveGroup.add('CG iterations', iterCG)
        if analytic is not None:
            M = assembleMass(dm)
            uEx = jnp.asarray(dm.interpolate(analytic).data)
            diff = u - uEx
            errL2 = float(np.sqrt(abs(jnp.vdot(diff, M @ diff))))
            solveGroup.add('L2 error', errL2)
        solveGroup.log()

    d.finish()
    return d


if __name__ == '__main__':
    main()
