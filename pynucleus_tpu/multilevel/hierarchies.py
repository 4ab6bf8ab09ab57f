"""Hierarchy construction and management.

Counterpart of /root/reference/multilevelSolver/PyNucleus_multilevelSolver/
{hierarchies.py (hierarchy:42, pCoarsenHierarchy:261, hierarchyManager:286,
paramsForMG), connectors.py (inputConnector:129, repartitionConnector:151,
pCoarsenConnector:347), levels.py (meshLevel:100, algebraicLevel:336)}.

The reference's hierarchy machinery exists to move meshes between MPI
communicators (repartition connectors, algebraic overlaps).  On a device mesh
there is a single program: levels live as replicated host metadata plus
device operator pytrees, and 'repartitioning' is a sharding change — so a
hierarchy here is a list of levels, each {'mesh', 'dm', 'A', 'P', 'R'},
built by refinement (h-hierarchy) and/or order increase (p-hierarchy)."""
import numpy as np

from .gmg import buildProlongation

__all__ = ['paramsForMG', 'algebraicLevel', 'hierarchyManager']


def paramsForMG(noRef, dim=2, element='P1', coarseSize=4500):
    """Standard multigrid schedule (ref hierarchies.py paramsForMG /
    helpers.paramsForFractionalHierarchy): how many levels to keep
    algebraic, bounded by the coarse LU size."""
    return {'noRef': noRef,
            'element': element,
            'dim': dim,
            'coarseSize': coarseSize}


class algebraicLevel:
    """One hierarchy level: mesh, DoFMap, assembled operators, transfer
    (ref levels.py:336 algebraicLevel; build stages collapsed — there are
    no overlap stages on a single program)."""

    def __init__(self, mesh, dm, A=None, P=None, R=None, M=None):
        self.mesh = mesh
        self.dm = dm
        self.A = A
        self.P = P
        self.R = R
        self.M = M

    def asDict(self):
        entry = {'mesh': self.mesh, 'dm': self.dm, 'A': self.A}
        if self.P is not None:
            entry['P'] = self.P
            entry['R'] = self.R
        if self.M is not None:
            entry['M'] = self.M
        return entry


class hierarchyManager:
    """Build and hold a mesh/operator hierarchy
    (ref hierarchies.py:286 hierarchyManager).

    :param mesh0: coarsest mesh (refined until the FE space is nonempty)
    :param params: dict from paramsForMG
    :param assembler: dm -> operator (default: local stiffness)
    :param massAssembler: optional dm -> mass operator per level
    """

    def __init__(self, mesh0, params, assembler=None, massAssembler=None,
                 dofmapArgs=None):
        self.mesh0 = mesh0
        self.params = params
        self.assembler = assembler
        self.massAssembler = massAssembler
        self.dofmapArgs = dofmapArgs or {}
        self.levels = None

    def setup(self):
        from ..fem.dofmaps import str2DoFMap
        from ..fem.assembly import assembleStiffness
        assembler = self.assembler or assembleStiffness
        DM = str2DoFMap[self.params.get('element', 'P1')]
        mesh = self.mesh0
        while DM(mesh, **self.dofmapArgs).num_dofs == 0:
            mesh = mesh.refine()
        meshes = [mesh]
        for _ in range(self.params['noRef']):
            meshes.append(meshes[-1].refine())
        dms = [DM(m, **self.dofmapArgs) for m in meshes]
        # drop coarse levels until the coarsest is below the direct-solver
        # bound (ref coarse solve on a subcommunicator; here: dense LU)
        coarseSize = self.params.get('coarseSize', 4500)
        start = 0
        while start < len(dms) - 1 and dms[start].num_dofs == 0:
            start += 1
        self.levels = []
        for lvl in range(start, len(dms)):
            lv = algebraicLevel(meshes[lvl], dms[lvl])
            lv.A = assembler(dms[lvl])
            if self.massAssembler is not None:
                lv.M = self.massAssembler(dms[lvl])
            if lvl > start:
                lv.P = buildProlongation(dms[lvl - 1], dms[lvl])
                lv.R = lv.P.T
            self.levels.append(lv)
        return self

    def getLevelList(self):
        """-> list of level dicts consumed by multigrid()
        (ref hierarchyManager.getLevelList)."""
        assert self.levels is not None, 'call setup() first'
        return [lv.asDict() for lv in self.levels]

    def __getitem__(self, lvl):
        return self.levels[lvl]

    def __len__(self):
        return len(self.levels) if self.levels else 0
