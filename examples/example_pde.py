#!/usr/bin/env python3
"""Local PDE example: Poisson on the unit square with geometric multigrid
(counterpart of /root/reference/examples/example_pde.py).

  -Delta u = f in (0,1)^2,  u = 0 on the boundary,  f = 1.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.fem import (meshFactory, dofmapFactory, functionFactory,
                               assembleStiffness, assembleRHS)
from pynucleus_tpu.multilevel import multigrid, buildProlongation
from pynucleus_tpu.multilevel.gmg import buildMeshHierarchy


def main():
    mesh0 = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    meshes = buildMeshHierarchy(mesh0, 6)[2:]
    levels = []
    dmPrev = None
    for m in meshes:
        dm = dofmapFactory('P1', m)
        entry = {'A': assembleStiffness(dm), 'dm': dm}
        if dmPrev is not None:
            entry['P'] = buildProlongation(dmPrev, dm)
        levels.append(entry)
        dmPrev = dm
    dm = levels[-1]['dm']
    b = np.asarray(assembleRHS(dm, functionFactory('constant',
                                                   value=1.)).data)
    mg = multigrid(hierarchy=levels)
    mg.setup()
    mg.tolerance = 1e-10
    u = np.asarray(mg.solve(b))
    print('dofs:', dm.num_dofs, ' MG iterations:', mg.iterations)
    print('max u:', u.max(), ' (exact max ~ 0.0736)')
    assert abs(u.max() - 0.07367) < 2e-3
    return u


if __name__ == '__main__':
    main()
