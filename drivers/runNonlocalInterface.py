#!/usr/bin/env python3
"""Two-domain nonlocal interface problem with solution and flux jumps.

Counterpart of the reference's drivers/runNonlocalInterface.py:
each subdomain assembles its own finite-horizon nonlocal Neumann operator
(interface pairs weighted by interfaceTwoPoint so the two forms tile the
doubled interaction region), the global system couples them through
restriction/prolongation maps, jumps enter the right-hand side.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from pynucleus_tpu.base import driver
from pynucleus_tpu.fem import assembleMass, assembleRHS, Lambda
from pynucleus_tpu.fem.dofmaps import str2DoFMap
from pynucleus_tpu.fem.meshes import NO_BOUNDARY
from pynucleus_tpu.fem.splitting import meshSplitter, dofmapSplitter
from pynucleus_tpu.nl.problems import nonlocalInterfaceProblem
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def main(argv=None):
    d = driver()
    nIP = nonlocalInterfaceProblem(d)
    d.add('solver', 'lu')
    d.add('tol', 1e-5)
    d.add('maxiter', 100)
    d.process(argv=argv)

    DM = str2DoFMap[d.element]
    dm = DM(nIP.mesh, tag=NO_BOUNDARY)

    split = meshSplitter(nIP.mesh, {'mesh1': nIP.subdomainIndicator1,
                                    'mesh2': nIP.subdomainIndicator2})
    dm1 = split.getSubMap('mesh1', dm)
    R1, P1 = split.getRestrictionProlongation('mesh1', dm, dm1)
    dm2 = split.getSubMap('mesh2', dm)
    R2, P2 = split.getRestrictionProlongation('mesh2', dm, dm2)

    meshInfo = d.addOutputGroup('meshInfo')
    meshInfo.add('num_dofs_domain1', dm1.num_dofs)
    meshInfo.add('num_dofs_domain2', dm2.num_dofs)
    meshInfo.log()

    dmSplit1 = dofmapSplitter(dm1, {
        'interface': nIP.interfaceIndicator,
        'domain': nIP.domainIndicator1 + nIP.interfaceIndicator,
        'bc': nIP.dirichletIndicator1})
    R1I, P1I = dmSplit1.getRestrictionProlongation('interface')
    R1D, P1D = dmSplit1.getRestrictionProlongation('domain')
    R1B, P1B = dmSplit1.getRestrictionProlongation('bc')
    dmSplit2 = dofmapSplitter(dm2, {
        'interface': nIP.interfaceIndicator,
        'domain': nIP.domainIndicator2 + nIP.interfaceIndicator,
        'bc': nIP.dirichletIndicator2})
    R2I, P2I = dmSplit2.getRestrictionProlongation('interface')
    R2D, P2D = dmSplit2.getRestrictionProlongation('domain')
    R2B, P2B = dmSplit2.getRestrictionProlongation('bc')

    with d.timer('assemble matrices'):
        A1 = np.asarray(nonlocalBuilder(
            dm1, nIP.kernel1, zeroExterior=False).getDense().toarray())
        A2 = np.asarray(nonlocalBuilder(
            dm2, nIP.kernel2, zeroExterior=False).getDense().toarray())

    R1d, P1d = R1.toarray(), P1.toarray()
    R2d, P2d = R2.toarray(), P2.toarray()
    R1Dd, P1Dd = R1D.toarray(), P1D.toarray()
    R2Dd, P2Dd = R2D.toarray(), P2D.toarray()
    R1Bd, P1Bd = R1B.toarray(), P1B.toarray()
    R2Bd, P2Bd = R2B.toarray(), P2B.toarray()
    P1Id, P2Id = P1I.toarray(), P2I.toarray()

    # domain-domain interaction + identity on the fake-Dirichlet boundary
    # (ref runNonlocalInterface.py:105-116)
    A = (P1d @ P1Dd @ (R1Dd @ A1 @ P1Dd) @ R1Dd @ R1d
         + P2d @ P2Dd @ (R2Dd @ A2 @ P2Dd) @ R2Dd @ R2d)
    A += P1d @ P1Bd @ R1Bd @ R1d + P2d @ P2Bd @ R2Bd @ R2d

    fl, fr = nIP.forcing_left, nIP.forcing_right
    ls1, ls2 = nIP.localSubdomainIndicator1, nIP.localSubdomainIndicator2
    li = nIP.localInterfaceIndicator
    wideInterface = nIP.interfaceIndicator
    mult = float(nIP.mult(np.zeros(1))[0])
    fj = nIP.flux_jump

    def f(x):
        # forcing on each subdomain + flux jump on the (wide) interface
        # region (ref runNonlocalInterface.py:112-114: indicatorFunctor with
        # nIP.interfaceIndicator)
        val = 0.0
        if float(ls1(x)[0]) > 0.5:
            val += float(fl(x)[0])
        if float(ls2(x)[0]) > 0.5:
            val += float(fr(x)[0])
        if float(wideInterface(x)[0]) > 0.5:
            val += mult * float(fj(x)[0])
        return val

    dmSplitRHS = dofmapSplitter(dm, {'domain': ls1 + ls2 + li})
    dmRHS = dmSplitRHS.getSubMap('domain')
    R_RHS, P_RHS = dmSplitRHS.getRestrictionProlongation('domain')
    # 1D exact-flux data has integrable kinks -> very high order; the 2D sin
    # data is smooth per cell (breakpoints are grid lines)
    if nIP.dim == 1:
        qOrder = 80 if (nIP.kernel1.kernelType == 'fractional'
                        or nIP.kernel2.kernelType == 'fractional') else 3
    else:
        qOrder = 6
    with d.timer('assemble rhs'):
        b = P_RHS.toarray() @ np.asarray(
            assembleRHS(dmRHS, Lambda(f), qOrder=qOrder).data)

    # solution jump and Dirichlet data enter through the rhs
    # (ref runNonlocalInterface.py:128-136)
    h = np.asarray(dmSplit2.getSubMap('interface').interpolate(
        nIP.sol_jump).data)
    b -= P2d @ P2Dd @ (R2Dd @ A2 @ P2Id) @ h
    g1 = np.asarray(dmSplit1.getSubMap('bc').interpolate(nIP.diri_left).data)
    g2 = np.asarray(dmSplit2.getSubMap('bc').interpolate(nIP.diri_right).data)
    b -= P1d @ P1Dd @ (R1Dd @ A1 @ P1Bd) @ g1
    b -= P2d @ P2Dd @ (R2Dd @ A2 @ P2Bd) @ g2

    with d.timer('solve'):
        u = np.linalg.solve(A, b)

    u1 = R1d @ u + P1Bd @ g1
    u2 = R2d @ u + P2Id @ h + P2Bd @ g2

    results = d.addOutputGroup('results', tested=True)
    if nIP.sol_1 is not None and nIP.sol_2 is not None:
        M1 = np.asarray(assembleMass(dm1).toarray())
        M2 = np.asarray(assembleMass(dm2).toarray())
        u1ex = np.asarray(dm1.interpolate(nIP.sol_1).data)
        u2ex = np.asarray(dm2.interpolate(nIP.sol_2).data)
        e1, e2 = u1 - u1ex, u2 - u2ex
        results.add('domain1L2err', float(np.sqrt(e1 @ (M1 @ e1))))
        results.add('domain2L2err', float(np.sqrt(e2 @ (M2 @ e2))))
    results.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
