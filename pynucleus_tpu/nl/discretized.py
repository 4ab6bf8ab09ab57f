"""Discretized nonlocal problems: hierarchy assembly, solve, error reporting.

Counterpart of /root/reference/nl/PyNucleus_nl/discretizedProblems.py
(stationaryModelSolution :32-250, discretizedNonlocalProblem :359-720).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..base.utilsFem import problem, generates, classWithComputedDependencies
from ..base.solvers import solverFactory, iterative_solver
from ..base.linear_operators import Dense_LinearOperator
from ..fem.dofmaps import str2DoFMap, fe_vector
from ..fem.assembly import assembleMass, assembleRHS
from ..multilevel.gmg import buildProlongation, multigrid
from .assembly import assembleNonlocal, nonlocalBuilder
from .problems import (DIRICHLET, NEUMANN, HOMOGENEOUS_DIRICHLET,
                       HOMOGENEOUS_NEUMANN)

__all__ = ['discretizedNonlocalProblem', 'stationaryModelSolution']


class stationaryModelSolution(classWithComputedDependencies):
    """Solution + error reporting (ref discretizedProblems.py:32)."""

    def __init__(self, discretizedProblem, u, **kwargs):
        super().__init__()
        self.discretizedProblem = discretizedProblem
        self.u = u
        for key in kwargs:
            setattr(self, key, kwargs[key])

    @generates('u_interp')
    def interpolateAnalyticSolution(self, u, analyticSolution):
        if analyticSolution is not None:
            self.u_interp = u.dm.interpolate(analyticSolution)
        else:
            self.u_interp = None

    @generates('L2_error')
    def computeL2error(self, u, analyticSolution, exactL2Squared):
        if exactL2Squared is not None and analyticSolution is not None:
            M = self.discretizedProblem.massInterior \
                if u.dm == self.discretizedProblem.dmInterior else \
                assembleMass(u.dm)
            z = assembleRHS(u.dm, analyticSolution)
            val = exactL2Squared - 2 * float(jnp.vdot(z.data, u.data)) \
                + float(jnp.vdot(u.data, M @ u.data))
            self.L2_error = np.sqrt(abs(val))
        else:
            self.L2_error = None

    @generates('rel_L2_error')
    def computeRelL2error(self, L2_error, exactL2Squared):
        self.rel_L2_error = (L2_error / np.sqrt(exactL2Squared)
                             if (L2_error is not None and
                                 exactL2Squared is not None) else None)

    @generates('Hs_error')
    def computeHserror(self, uRestricted, b, exactHsSquared):
        if exactHsSquared is not None:
            self.Hs_error = np.sqrt(abs(
                float(jnp.vdot(b.data, uRestricted.data)) - exactHsSquared))
        else:
            self.Hs_error = None

    @generates('rel_Hs_error')
    def computeRelHserror(self, Hs_error, exactHsSquared):
        self.rel_Hs_error = (Hs_error / np.sqrt(exactHsSquared)
                             if (Hs_error is not None and
                                 exactHsSquared is not None) else None)

    @generates('L2_error_interp')
    def computeL2errorInterpolated(self, u, u_interp):
        if u_interp is not None:
            M = self.discretizedProblem.massInterior \
                if u.dm == self.discretizedProblem.dmInterior else \
                assembleMass(u.dm)
            d = u.data - u_interp.data
            self.L2_error_interp = float(jnp.sqrt(jnp.vdot(d, M @ d)))
        else:
            self.L2_error_interp = None

    @generates('rel_L2_error_interp')
    def computeRelL2errorInterpolated(self, u_interp, L2_error_interp):
        if L2_error_interp is not None:
            M = self.discretizedProblem.massInterior \
                if u_interp.dm == self.discretizedProblem.dmInterior else \
                assembleMass(u_interp.dm)
            nrm = float(jnp.sqrt(jnp.vdot(u_interp.data, M @ u_interp.data)))
            self.rel_L2_error_interp = L2_error_interp / nrm
        else:
            self.rel_L2_error_interp = None

    @generates('Linf_error_interp')
    def computeLinferrorInterpolated(self, u, u_interp):
        if u_interp is not None:
            self.Linf_error_interp = float(jnp.abs(u.data - u_interp.data).max())
        else:
            self.Linf_error_interp = None

    @generates('rel_Linf_error_interp')
    def computeRelLinferrorInterpolated(self, u_interp, Linf_error_interp):
        if Linf_error_interp is not None:
            self.rel_Linf_error_interp = Linf_error_interp / \
                float(jnp.abs(u_interp.data).max())
        else:
            self.rel_Linf_error_interp = None

    @generates('error')
    def buildErrorVector(self, u, u_interp):
        if u_interp is not None:
            self.error = fe_vector(jnp.abs(u.data - u_interp.data), u.dm)
        else:
            self.error = None

    def reportErrors(self, group):
        # tolerances mirror ref discretizedProblems.py:225-241
        for label, val in [('L2 error', self.L2_error),
                           ('relative L2 error', self.rel_L2_error),
                           ('L2 error interpolated', self.L2_error_interp),
                           ('relative interpolated L2 error', self.rel_L2_error_interp),
                           ('Linf error interpolated', self.Linf_error_interp),
                           ('relative interpolated Linf error', self.rel_Linf_error_interp),
                           ('Hs error', self.Hs_error),
                           ('relative Hs error', self.rel_Hs_error)]:
            if val is not None:
                group.add(label, val, rTol=3e-2, aTol=1e-8)

    def reportSolve(self, group):
        group.add('solver', self.discretizedProblem.solverType)
        group.add('iterations', self.iterations)

    def plotSolution(self):
        pass


class discretizedNonlocalProblem(problem):
    """Assembly + solve pipeline (ref discretizedProblems.py:359)."""

    def __init__(self, driver, continuumProblem):
        super().__init__(driver)
        self.__dict__['continuumProblem'] = continuumProblem

    def _resolveMissing(self, name):
        cp = self.__dict__.get('continuumProblem')
        if cp is not None:
            try:
                return getattr(cp, name)
            except AttributeError:
                pass
        return super()._resolveMissing(name)

    def setDriverArgs(self):
        p = self.driver.addGroup('solver')
        self.setDriverFlag('solverType', acceptedValues=[
            'cg-mg', 'gmres-mg', 'lu', 'chol', 'mg', 'cg-jacobi',
            'gmres-jacobi'], group=p)
        self.setDriverFlag('maxiter', 100, group=p)
        self.setDriverFlag('tol', 1e-6, group=p)
        p = self.driver.addGroup('assembly')
        self.setDriverFlag('matrixFormat', acceptedValues=['H2', 'sparse',
                                                           'dense'], group=p)

    @generates(['meshHierarchy', 'finalMesh', 'dmHierarchy', 'dmInterior',
                'dmBC', 'PHierarchy'])
    def buildMeshHierarchy(self, mesh, solverType, tag, noRef, element):
        DM = str2DoFMap[element]
        meshes = [mesh]
        for _ in range(noRef):
            meshes.append(meshes[-1].refine())
        self.meshHierarchy = meshes
        self.finalMesh = meshes[-1]
        needAllLevels = 'mg' in solverType
        dms = [DM(m, tag=tag) for m in meshes] if needAllLevels else \
            [None] * (len(meshes) - 1) + [DM(meshes[-1], tag=tag)]
        self.dmHierarchy = dms
        self.dmInterior = dms[-1]
        self.dmBC = self.dmInterior.getComplementDoFMap()
        Ps = [None]
        if needAllLevels:
            for lvl in range(1, len(meshes)):
                Ps.append(buildProlongation(dms[lvl - 1], dms[lvl]))
        self.PHierarchy = Ps

    @generates('hierarchy')
    def buildHierarchy(self, meshHierarchy, dmHierarchy, PHierarchy, kernel,
                       solverType, matrixFormat, zeroExterior,
                       boundaryCondition):
        needAllLevels = 'mg' in solverType
        hierarchy = []
        nLvl = len(dmHierarchy)
        for lvl in range(nLvl):
            entry = {}
            if needAllLevels or lvl == nLvl - 1:
                fmt = matrixFormat if lvl == nLvl - 1 else \
                    ('dense' if matrixFormat == 'dense' else matrixFormat)
                # one 'assembly' duration per level; the last is the finest
                with self.driver.timer('assembly'):
                    A = jax.block_until_ready(assembleNonlocal(
                        dmHierarchy[lvl], kernel, matrixFormat=fmt,
                        zeroExterior=zeroExterior))
                if boundaryCondition in (NEUMANN, HOMOGENEOUS_NEUMANN):
                    # rank-one shift removes the constant nullspace
                    # (ref discretizedProblems.py:571-576)
                    ones = Dense_LinearOperator(
                        jnp.ones((A.num_rows, A.num_columns)))
                    A = A + ones
                entry['A'] = A
            if 0 < lvl < len(PHierarchy) and PHierarchy[lvl] is not None:
                entry['P'] = PHierarchy[lvl]
                entry['R'] = PHierarchy[lvl].T
            hierarchy.append(entry)
        self.hierarchy = hierarchy

    @generates('A')
    def getOperators(self, hierarchy):
        self.A = hierarchy[-1]['A']

    @generates('A_BC')
    def buildBCoperator(self, dmInterior, dmBC, kernel, boundaryCondition,
                        zeroExterior, matrixFormat):
        if boundaryCondition == DIRICHLET and dmBC.num_dofs > 0:
            builder = nonlocalBuilder(dmInterior, kernel,
                                      zeroExterior=zeroExterior, dm2=dmBC)
            self.A_BC = builder.getDenseCross()
        else:
            self.A_BC = None

    @generates('mass')
    def buildMass(self, dmInterior):
        self.mass = assembleMass(dmInterior)

    @generates('massInterior')
    def buildMassInterior(self, dmInterior):
        self.massInterior = assembleMass(dmInterior)

    @generates('b')
    def buildRHS(self, rhs, A_BC, dmBC, dirichletData, boundaryCondition,
                 dmInterior):
        b = assembleRHS(dmInterior, rhs, qOrder=3)
        if A_BC is not None and dmBC.num_dofs > 0 and dirichletData is not None:
            uBC = dmBC.interpolate(dirichletData)
            b = fe_vector(b.data - (A_BC @ uBC.data), dmInterior)
        if boundaryCondition in (NEUMANN, HOMOGENEOUS_NEUMANN):
            const = jnp.ones(dmInterior.num_dofs)
            b = fe_vector(b.data - jnp.vdot(b.data, const) /
                          jnp.vdot(const, const) * const, dmInterior)
        self.b = b

    @generates('solver')
    def buildSolver(self, solverType, tol, maxiter, hierarchy):
        with self.driver.timer('solver setup'):
            solver = solverFactory.build(solverType, hierarchy=hierarchy,
                                         setup=True)
        if isinstance(solver, iterative_solver):
            solver.tolerance = tol
            solver.maxIter = maxiter
        self.solver = solver

    @generates('modelSolution')
    def solve(self, b, dmInterior, dmBC, solver, boundaryCondition,
              analyticSolution, dirichletData, rhs):
        with self.driver.timer('solve'):
            uInterior = jax.block_until_ready(solver.solve(b.data))
        its = getattr(solver, 'iterations', 1)
        resError = float(jnp.linalg.norm(b.data - solver.A @ uInterior))

        if boundaryCondition in (NEUMANN, HOMOGENEOUS_NEUMANN) and \
                analyticSolution is not None:
            uEx = dmInterior.interpolate(analyticSolution)
            const = jnp.ones(dmInterior.num_dofs)
            shift = (jnp.vdot(const, uEx.data) - jnp.vdot(const, uInterior)) \
                / jnp.vdot(const, const)
            uInterior = uInterior + shift * const

        u = fe_vector(uInterior, dmInterior)
        data = {'iterations': its,
                'uInterior': u,
                'uRestricted': u,
                'explicitResidualError': resError,
                'b': b,
                'rhs': rhs,
                'analyticSolution': analyticSolution,
                'exactL2Squared': getattr(self.continuumProblem,
                                          'exactL2Squared', None),
                'exactHsSquared': getattr(self.continuumProblem,
                                          'exactHsSquared', None),
                'dirichletData': dirichletData}
        self.modelSolution = stationaryModelSolution(self, u, **data)

    def report(self, group):
        group.add('kernel', repr(self.continuumProblem.kernel))
        group.add('problem', self.continuumProblem.problemDescription)
        group.add('h', self.finalMesh.h)
        group.add('hmin', self.finalMesh.hmin)
        group.add('dofs', self.dmInterior.num_dofs)


class transientModelSolution(classWithComputedDependencies):
    """Time-series solution + errors (ref discretizedProblems.py:252-357).
    Time quadrature uses the reference's convention fac = t_{k+1} - t_{k-1}
    (t-span of neighbors; twice the trapezoid weight)."""

    def __init__(self, discretizedProblem, u, **kwargs):
        super().__init__()
        self.discretizedProblem = discretizedProblem
        self.u = u                      # list of full-dm arrays, len nT+1
        for key in kwargs:
            setattr(self, key, kwargs[key])

    def _timeWeights(self, times):
        fac = np.zeros(len(times))
        fac[0] = times[1] - times[0]
        fac[-1] = times[-1] - times[-2]
        fac[1:-1] = times[2:] - times[:-2]
        return fac

    @generates('L2_error')
    def computeL2error(self, u, analyticSolutionT, exactL2SquaredT,
                       timesVector):
        if exactL2SquaredT is None:
            self.L2_error = None
            return
        dp = self.discretizedProblem
        M = dp.massFull
        fac = self._timeWeights(timesVector)
        integral = 0.0
        for k, t in enumerate(timesVector):
            z = assembleRHS(dp.dmFull, analyticSolutionT(t))
            integral += fac[k] * abs(
                exactL2SquaredT(t) - 2 * float(jnp.vdot(z.data, u[k]))
                + float(jnp.vdot(u[k], M @ u[k])))
        self.L2_error = np.sqrt(integral)

    @generates('final_L2_error')
    def computeFinalL2error(self, u, analyticSolutionT, exactL2SquaredT,
                            finalTime):
        if exactL2SquaredT is None:
            self.final_L2_error = None
            return
        dp = self.discretizedProblem
        M = dp.massFull
        z = assembleRHS(dp.dmFull, analyticSolutionT(finalTime))
        val = abs(exactL2SquaredT(finalTime) - 2 * float(jnp.vdot(z.data, u[-1]))
                  + float(jnp.vdot(u[-1], M @ u[-1])))
        self.final_L2_error = np.sqrt(val)

    @generates('L2_norm')
    def computeL2norm(self, u, timesVector):
        dp = self.discretizedProblem
        M = dp.massFull
        fac = self._timeWeights(timesVector)
        integral = sum(fac[k] * abs(float(jnp.vdot(u[k], M @ u[k])))
                       for k in range(len(timesVector)))
        self.L2_norm = np.sqrt(integral)

    def reportErrors(self, group):
        group.add('L^2(0,T; L^2(Omega)) norm', self.L2_norm, rTol=3e-2,
                  aTol=1e-8)
        if self.L2_error is not None:
            group.add('L^2(0,T; L^2(Omega)) error', self.L2_error, rTol=3e-2,
                      aTol=1e-8)
        if self.final_L2_error is not None:
            group.add('L^2(Omega) error at t=finalTime', self.final_L2_error,
                      rTol=3e-2, aTol=1e-8)


class discretizedTransientProblem(discretizedNonlocalProblem):
    """Transient pipeline (ref discretizedProblems.py:721-943)."""

    def setDriverArgs(self):
        super().setDriverArgs()
        self.setDriverFlag('timeStepperType', acceptedValues=['Crank-Nicolson',
                                                              'Implicit Euler'])
        self.setDriverFlag('theta', 0.5)

    @generates(['dt', 'numTimeSteps', 'timesVector'])
    def determineTimeSteps(self, finalMesh, finalTime, timeStepperType):
        h = finalMesh.h
        dt = np.sqrt(h) if timeStepperType == 'Crank-Nicolson' else h
        numTimeSteps = int(np.around(finalTime / dt))
        self.dt = finalTime / numTimeSteps
        self.numTimeSteps = numTimeSteps
        self.timesVector = np.linspace(0, finalTime, numTimeSteps + 1)

    @generates(['dmFull', 'i2f', 'massFull'])
    def buildFullSpace(self, dmInterior):
        from ..fem.dofmaps import interiorToFullMaps
        dmFull, i2f, b2f = interiorToFullMaps(dmInterior)
        self.dmFull = dmFull
        self.i2f = i2f
        self.massFull = assembleMass(dmFull)

    def residual(self, t, u, ut, residual, coeff_A=1., coeff_B=1.,
                 coeff_g=1., coeff_residual=0., forcingVector=None):
        """coeff_A*M@ut + coeff_B*A@u - coeff_g*g(t), accumulated
        (ref discretizedProblems.py:788-822)."""
        out = residual.data * coeff_residual
        if coeff_A != 0 and ut is not None:
            out = out + coeff_A * (self.massInterior @ ut.data)
        if coeff_B != 0 and u is not None:
            out = out + coeff_B * (self.A @ u.data)
        if coeff_g != 0:
            if forcingVector is None:
                force = self.continuumProblem.rhsT(t)
                g = assembleRHS(self.dmInterior, force, qOrder=3).data
            else:
                g = forcingVector.data if hasattr(forcingVector, 'data') \
                    else jnp.asarray(forcingVector)
            out = out - coeff_g * g
        residual.assign(out)

    def solverBuilder(self, t, alpha, beta):
        from ..base.linear_operators import TimeStepperLinearOperator
        needAll = 'mg' in self.solverType
        hierarchy = self.hierarchy
        newH = []
        for lvl in range(len(hierarchy)):
            entry = {}
            if 'A' in hierarchy[lvl]:
                Mh = assembleMass(self.dmHierarchy[lvl]) if needAll or \
                    lvl == len(hierarchy) - 1 else None
                entry['A'] = TimeStepperLinearOperator(
                    Mh, hierarchy[lvl]['A'], facS=beta, facM=alpha)
            for key in ('P', 'R'):
                if key in hierarchy[lvl]:
                    entry[key] = hierarchy[lvl][key]
            newH.append(entry)
        s = solverFactory.build(self.solverType, hierarchy=newH, setup=True)
        if isinstance(s, iterative_solver):
            s.tolerance = self.tol
            s.maxIter = self.maxiter
        return s

    @generates('stepper')
    def buildTimeStepper(self, timeStepperType, dt, dmInterior, theta):
        from ..base.timestepping import timestepperFactory
        kwargs = {'theta': theta} if timeStepperType == 'Crank-Nicolson' else {}
        self.stepper = timestepperFactory(
            timeStepperType, dm=dmInterior, residual=self.residual,
            solverBuilder=self.solverBuilder, dt=dt, **kwargs)

    @generates('modelSolution')
    def solve(self, numTimeSteps, dt, finalTime, timesVector, stepper,
              dmInterior, i2f, dmFull):
        initial = self.continuumProblem.initial
        uI = dmInterior.interpolate(initial)
        u = []
        full0 = jnp.zeros(dmFull.num_dofs).at[jnp.asarray(i2f)].set(uI.data)
        u.append(full0)
        t = 0.0
        for k in range(numTimeSteps):
            t = stepper(t, dt, uI)
            u.append(jnp.zeros(dmFull.num_dofs).at[jnp.asarray(i2f)].set(uI.data))
        assert abs(t - finalTime) < 1e-10, (t, finalTime)
        self.modelSolution = transientModelSolution(
            self, u, timesVector=timesVector, dt=dt, finalTime=finalTime,
            exactL2SquaredT=self.continuumProblem.exactL2SquaredT,
            analyticSolutionT=self.continuumProblem.analyticSolutionT)
