#!/usr/bin/env python3
"""Local PDE interface problem on two subdomains with solution and flux
jumps at the interface, solved by LU or overlapping-free domain
decomposition (alternating Schwarz / restricted additive Schwarz).

Counterpart of the reference's drivers/interfaceProblem.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import driver
from pynucleus_tpu.fem import (assembleMass, assembleStiffness, assembleRHS,
                               Lambda)
from pynucleus_tpu.fem.functions import constant, squareIndicator
from pynucleus_tpu.fem.dofmaps import P1_DoFMap
from pynucleus_tpu.fem.meshes import NO_BOUNDARY, simpleInterval, uniformSquare
from pynucleus_tpu.fem.splitting import meshSplitter, dofmapSplitter
from pynucleus_tpu.fem.assembly import assembleSurfaceRHS, _vertexDofMap


def main(argv=None):
    d = driver()
    d.add('domain', 'doubleInterval')
    d.add('problem', 'sin-solJump-fluxJump')
    d.add('coeff1', 1.0)
    d.add('coeff2', 1.0)
    d.add('hTarget', 0.05)
    d.add('solver', 'lu')
    d.process(argv=argv)

    eps = 1e-9
    L2ex_left = L2ex_right = None
    if d.domain == 'doubleInterval':
        a, b, c = 0.0, 2.0, 1.0
        mesh = simpleInterval(a, b).refine()
        domainIndicator1 = squareIndicator(np.array([a + eps]),
                                           np.array([c - eps]))
        domainIndicator2 = squareIndicator(np.array([c + eps]),
                                           np.array([b - eps]))
        interfaceIndicator = squareIndicator(np.array([c - eps]),
                                             np.array([c + eps]))
    elif d.domain == 'doubleSquare':
        ax, ay, bx, by, cx = 0.0, 0.0, 2.0, 1.0, 1.0
        mesh = uniformSquare(N=3, M=2, ax=ax, ay=ay, bx=bx, by=by).refine()
        domainIndicator1 = squareIndicator(np.array([ax + eps, ay + eps]),
                                           np.array([cx - eps, by - eps]))
        domainIndicator2 = squareIndicator(np.array([cx + eps, ay + eps]),
                                           np.array([bx - eps, by - eps]))
        interfaceIndicator = squareIndicator(np.array([cx - eps, ay + eps]),
                                             np.array([cx + eps, by - eps]))
    else:
        raise NotImplementedError(d.domain)
    dirichletIndicator1 = constant(1.) - domainIndicator1 - interfaceIndicator
    dirichletIndicator2 = constant(1.) - domainIndicator2 - interfaceIndicator

    c1, c2 = d.coeff1, d.coeff2
    if d.problem == 'polynomial':
        sol_1 = Lambda(lambda x: x[0] ** 2)
        sol_2 = Lambda(lambda x: (x[0] - 1) ** 2)
        forcing_left = constant(-2 * c1)
        forcing_right = constant(-2 * c2)
        flux_jump = constant(2 * c1)
    elif d.problem == 'sin-solJump-fluxJump' and d.domain == 'doubleInterval':
        # u1 = sin(pi x), u2 = 1 - 2 sin(pi x)
        # (ref interfaceProblem.py:63-77)
        sol_1 = Lambda(lambda x: np.sin(np.pi * x[0]))
        sol_2 = Lambda(lambda x: 1 - 2 * np.sin(np.pi * x[0]))
        forcing_left = Lambda(lambda x: np.pi ** 2 * c1 * np.sin(np.pi * x[0]))
        forcing_right = Lambda(
            lambda x: -2 * np.pi ** 2 * c2 * np.sin(np.pi * x[0]))
        flux_jump = constant(-np.pi * c1 - 2 * np.pi * c2)
        L2ex_left = 0.5
        L2ex_right = 3. + 8 / np.pi
    elif d.problem == 'sin-solJump-fluxJump':
        # doubleSquare variant (ref interfaceProblem.py:156-176)
        sol_1 = Lambda(lambda x: 2 + 2 * np.sin(np.pi * x[0])
                       * np.sin(2 * np.pi * x[1]))
        sol_2 = Lambda(lambda x: 1 - np.sin(np.pi * x[0])
                       * np.sin(np.pi * x[1]))
        forcing_left = Lambda(lambda x: c1 * 10 * np.pi ** 2
                              * np.sin(np.pi * x[0]) * np.sin(2 * np.pi * x[1]))
        forcing_right = Lambda(lambda x: -c2 * 2 * np.pi ** 2
                               * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]))
        flux_jump = Lambda(lambda x: -2 * np.pi * c1 * np.sin(2 * np.pi * x[1])
                           - np.pi * c2 * np.sin(np.pi * x[1]))
        L2ex_left = 5.0
        L2ex_right = 1.25 + 8. / np.pi ** 2
    else:
        raise NotImplementedError(d.problem)
    diri_left, diri_right = sol_1, sol_2
    sol_jump = Lambda(lambda x: float(sol_2(x)[0]) - float(sol_1(x)[0]))

    while mesh.h > d.hTarget:
        mesh = mesh.refine()

    dm = P1_DoFMap(mesh, tag=NO_BOUNDARY)
    split = meshSplitter(mesh, {'mesh1': domainIndicator1,
                                'mesh2': domainIndicator2})
    dm1 = split.getSubMap('mesh1', dm)
    R1, P1 = split.getRestrictionProlongation('mesh1', dm, dm1)
    dm2 = split.getSubMap('mesh2', dm)
    R2, P2 = split.getRestrictionProlongation('mesh2', dm, dm2)

    dmSplit1 = dofmapSplitter(dm1, {
        'interface': interfaceIndicator,
        'domain': domainIndicator1 + interfaceIndicator,
        'bc': dirichletIndicator1})
    R1D, P1D = dmSplit1.getRestrictionProlongation('domain')
    R1B, P1B = dmSplit1.getRestrictionProlongation('bc')
    dmSplit2 = dofmapSplitter(dm2, {
        'interface': interfaceIndicator,
        'domain': domainIndicator2 + interfaceIndicator,
        'bc': dirichletIndicator2})
    R2I, P2I = dmSplit2.getRestrictionProlongation('interface')
    R2D, P2D = dmSplit2.getRestrictionProlongation('domain')
    R2B, P2B = dmSplit2.getRestrictionProlongation('bc')

    A1 = c1 * np.asarray(assembleStiffness(dm1).toarray())
    A2 = c2 * np.asarray(assembleStiffness(dm2).toarray())

    R1d, P1d = R1.toarray(), P1.toarray()
    R2d, P2d = R2.toarray(), P2.toarray()
    R1Dd, P1Dd = R1D.toarray(), P1D.toarray()
    R2Dd, P2Dd = R2D.toarray(), P2D.toarray()
    R1Bd, P1Bd = R1B.toarray(), P1B.toarray()
    R2Bd, P2Bd = R2B.toarray(), P2B.toarray()
    P2Id = P2I.toarray()

    A = (P1d @ P1Dd @ (R1Dd @ A1 @ P1Dd) @ R1Dd @ R1d
         + P2d @ P2Dd @ (R2Dd @ A2 @ P2Dd) @ R2Dd @ R2d)
    A += P1d @ P1Bd @ R1Bd @ R1d + P2d @ P2Bd @ R2Bd @ R2d

    bD1 = np.asarray(assembleRHS(dmSplit1.getSubMap('domain'),
                                 forcing_left, qOrder=5).data)
    bD2 = np.asarray(assembleRHS(dmSplit2.getSubMap('domain'),
                                 forcing_right, qOrder=5).data)
    b = P1d @ P1Dd @ bD1 + P2d @ P2Dd @ bD2

    # flux-jump surface term on the interface facets of subdomain 1
    if mesh.manifold_dim == 1:
        vdof1 = _vertexDofMap(dm1)
        iv = np.nonzero(np.abs(dm1.mesh.vertices[:, 0] - 1.0) < 1e-12)[0]
        bI = np.zeros(dm1.num_dofs)
        for v in iv:
            if vdof1[v] >= 0:
                bI[vdof1[v]] += float(flux_jump(dm1.mesh.vertices[v])[0])
    else:
        edges = dm1.mesh.boundaryEdges
        onIf = np.abs(dm1.mesh.vertices[edges, 0] - 1.0).max(axis=1) < 1e-12
        bI = np.real(assembleSurfaceRHS(dm1, flux_jump, facets=edges[onIf]))
    b += P1d @ bI

    h = np.asarray(dmSplit2.getSubMap('interface').interpolate(sol_jump).data)
    b -= P2d @ P2Dd @ (R2Dd @ A2 @ P2Id) @ h
    g1 = np.asarray(dmSplit1.getSubMap('bc').interpolate(diri_left).data)
    g2 = np.asarray(dmSplit2.getSubMap('bc').interpolate(diri_right).data)
    b -= P1d @ P1Dd @ (R1Dd @ A1 @ P1Bd) @ g1
    b -= P2d @ P2Dd @ (R2Dd @ A2 @ P2Bd) @ g2

    its = 0
    if d.solver == 'lu':
        u = np.linalg.solve(A, b)
    elif d.solver in ('alternatingSchwarz', 'RAS'):
        A1loc = R1d @ A @ P1d
        A2loc = R2d @ A @ P2d
        u = np.zeros(dm.num_dofs)
        r = b - A @ u
        r0 = np.linalg.norm(r)
        if d.solver == 'RAS':
            dg = P1d @ np.ones(dm1.num_dofs) + P2d @ np.ones(dm2.num_dofs)
            w1 = 1.0 / (R1d @ dg)
            w2 = 1.0 / (R2d @ dg)
        while its < 100 and np.linalg.norm(r) / r0 > 1e-5:
            if d.solver == 'alternatingSchwarz':
                u = u + P1d @ np.linalg.solve(A1loc, R1d @ r)
                r = b - A @ u
                u = u + P2d @ np.linalg.solve(A2loc, R2d @ r)
                r = b - A @ u
            else:
                u = u + P1d @ (w1 * np.linalg.solve(A1loc, R1d @ r)) \
                    + P2d @ (w2 * np.linalg.solve(A2loc, R2d @ r))
                r = b - A @ u
            its += 1
        print('%s: residual %.3e/%.3e after %d iterations'
              % (d.solver, np.linalg.norm(r), r0, its))
    else:
        raise NotImplementedError(d.solver)

    u1 = R1d @ u + P1Bd @ g1
    u2 = R2d @ u + P2Id @ h + P2Bd @ g2

    results = d.addOutputGroup('results', tested=True)
    results.add('iterations', its)
    M1 = np.asarray(assembleMass(dm1).toarray())
    M2 = np.asarray(assembleMass(dm2).toarray())
    if L2ex_left is not None:
        z1 = np.asarray(assembleRHS(dm1, sol_1, qOrder=5).data)
        results.add('domain1L2err',
                    float(np.sqrt(abs(u1 @ (M1 @ u1) - 2 * z1 @ u1
                                      + L2ex_left))))
        z2 = np.asarray(assembleRHS(dm2, sol_2, qOrder=5).data)
        results.add('domain2L2err',
                    float(np.sqrt(abs(u2 @ (M2 @ u2) - 2 * z2 @ u2
                                      + L2ex_right))))
    else:
        u1ex = np.asarray(dm1.interpolate(sol_1).data)
        u2ex = np.asarray(dm2.interpolate(sol_2).data)
        e1, e2 = u1 - u1ex, u2 - u2ex
        results.add('domain1L2err', float(np.sqrt(e1 @ (M1 @ e1))))
        results.add('domain2L2err', float(np.sqrt(e2 @ (M2 @ e2))))
    results.log()
    d.finish()
    return d


if __name__ == '__main__':
    main()
