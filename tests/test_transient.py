"""Transient fractional heat regression tests (counterpart of the
reference's cache_runFractionalHeat.py--* files; expected values are DATA
from those caches)."""
import numpy as np
import pytest

from drivers.runFractionalHeat import main as runFractionalHeat


CONFIGS = [
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'constant',
      '--element', 'P1', '--solverType', 'lu', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.001373383240555988,
      'L^2(0,T; L^2(Omega)) norm': 0.9834423668513136,
      'L^2(Omega) error at t=finalTime': 0.0006827318330338746}),
    (['--domain', 'interval', '--s', 'const(0.25)', '--problem', 'constant',
      '--element', 'P1', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.03218338586612875,
      'L^2(0,T; L^2(Omega)) norm': 1.7018299503210628,
      'L^2(Omega) error at t=finalTime': 0.01455872345929613}),
]

IDS = ['s0.75-lu', 's0.25-cgmg']

# widened interval matrix: every interval kernel family
# of the reference's 41-config cache set; disc rows are pinned to our mesh
# elsewhere (no `triangle` in the image)
CONFIGS_SLOW = [
    (['--domain', 'interval', '--s', 'const(0.25)', '--problem', 'constant',
      '--element', 'P2', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.027495862469873365,
      'L^2(0,T; L^2(Omega)) norm': 1.7019259587916384,
      'L^2(Omega) error at t=finalTime': 0.012420534279834644}),
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'constant',
      '--element', 'P2', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.0009194690275845384,
      'L^2(0,T; L^2(Omega)) norm': 0.9832074391209417,
      'L^2(Omega) error at t=finalTime': 0.0004404667561743383}),
    (['--domain', 'interval', '--s', 'const(0.25)', '--problem', 'constant',
      '--element', 'P3', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.017267223086710897,
      'L^2(0,T; L^2(Omega)) norm': 1.7026331344615124,
      'L^2(Omega) error at t=finalTime': 0.007746289486904896}),
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'constant',
      '--element', 'P3', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.00045325268566045015,
      'L^2(0,T; L^2(Omega)) norm': 0.9834064913824577,
      'L^2(Omega) error at t=finalTime': 0.0003981668929333403}),
    (['--domain', 'interval', '--s', 'const(0.25)', '--problem', 'constant',
      '--element', 'P0', '--solverType', 'cg-mg', '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.0149413089985309,
      'L^2(0,T; L^2(Omega)) norm': 1.7025600858867103,
      'L^2(Omega) error at t=finalTime': 0.007567757829891671}),
    (['--domain', 'interval', '--s', 'constantNonSym(0.25)', '--problem',
      'constant', '--element', 'P1', '--solverType', 'gmres-jacobi',
      '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.032183391672112704,
      'L^2(0,T; L^2(Omega)) norm': 1.7018299532802796,
      'L^2(Omega) error at t=finalTime': 0.014558730308751077}),
    (['--domain', 'interval', '--s', 'constantNonSym(0.75)', '--problem',
      'constant', '--element', 'P1', '--solverType', 'gmres-jacobi',
      '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.0013734475606580092,
      'L^2(0,T; L^2(Omega)) norm': 0.9834424426125228,
      'L^2(Omega) error at t=finalTime': 0.0006827320291472987}),
    (['--domain', 'interval', '--s', 'twoDomainNonSym(0.25,0.75)',
      '--problem', 'knownSolution', '--element', 'P1', '--solverType', 'lu',
      '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.0022559436330307435,
      'L^2(0,T; L^2(Omega)) norm': 1.3223156438435326,
      'L^2(Omega) error at t=finalTime': 0.001064703027872593}),
    (['--domain', 'interval', '--s', 'varconst(0.75)', '--problem',
      'constant', '--element', 'P1', '--solverType', 'cg-jacobi',
      '--matrixFormat', 'dense'],
     {'L^2(0,T; L^2(Omega)) error': 0.0013733862672740762,
      'L^2(0,T; L^2(Omega)) norm': 0.9834423679199291,
      'L^2(Omega) error at t=finalTime': 0.0006827374796469401}),
]

IDS_SLOW = ['P2-s0.25', 'P2-s0.75', 'P3-s0.25', 'P3-s0.75', 'P0-s0.25',
            'nonsym0.25', 'nonsym0.75', 'twoDomain-known', 'varconst']


@pytest.mark.slow
@pytest.mark.parametrize('argv,expected', CONFIGS_SLOW, ids=IDS_SLOW)
def test_runFractionalHeat_swept(argv, expected):
    d, mS = runFractionalHeat(argv)
    got = d.outputGroups['errors'].toDict()
    for label, val in expected.items():
        assert np.isclose(got[label], val, rtol=3e-2, atol=1e-8), \
            (label, got[label], val)


@pytest.mark.parametrize('argv,expected', CONFIGS, ids=IDS)
def test_runFractionalHeat(argv, expected):
    d, mS = runFractionalHeat(argv)
    got = d.outputGroups['errors'].toDict()
    for label, val in expected.items():
        assert np.isclose(got[label], val, rtol=3e-2, atol=1e-8), \
            (label, got[label], val)


def test_steppers_ode():
    """Steppers integrate du/dt + u = 0 at the right orders."""
    import jax.numpy as jnp
    from pynucleus_tpu.base.timestepping import timestepperFactory
    from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator
    from pynucleus_tpu.base.solvers import solverFactory
    from pynucleus_tpu.fem import simpleInterval, P1_DoFMap

    m = simpleInterval(0., 1.)
    m = m.refine().refine()
    dm = P1_DoFMap(m, tag=-1234)
    n = dm.num_dofs
    I = Diagonal_LinearOperator(jnp.ones(n))

    def residual(t, u, ut, res, coeff_A=1., coeff_B=1., coeff_g=1.,
                 coeff_residual=0., forcingVector=None):
        out = res.data * coeff_residual
        if coeff_A and ut is not None:
            out = out + coeff_A * ut.data
        if coeff_B and u is not None:
            out = out + coeff_B * u.data
        res.assign(out)

    def solverBuilder(t, alpha, beta):
        return solverFactory.build(
            'lu', A=Diagonal_LinearOperator((alpha + beta) * jnp.ones(n)),
            setup=True)

    errs = {}
    for name, order in [('Crank-Nicolson', 2), ('Implicit Euler', 1)]:
        errs[name] = []
        for nT in (20, 40):
            stepper = timestepperFactory(name, dm=dm, residual=residual,
                                         solverBuilder=solverBuilder,
                                         dt=1.0 / nT)
            u = dm.ones()
            t = 0.0
            for _ in range(nT):
                t = stepper(t, 1.0 / nT, u)
            errs[name].append(abs(float(u.data[0]) - np.exp(-1.0)))
        rate = np.log2(errs[name][0] / errs[name][1])
        assert rate > order - 0.25, (name, errs[name], rate)


HEAT_H2_CONFIGS = [
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'constant',
      '--element', 'P2', '--solverType', 'cg-mg', '--matrixFormat', 'H2'],
     {'L^2(0,T; L^2(Omega)) error': 0.0009194744825301727}),
    (['--domain', 'interval', '--s', 'varconst(0.75)', '--problem', 'constant',
      '--element', 'P1', '--solverType', 'cg-jacobi', '--matrixFormat', 'H2'],
     {'L^2(0,T; L^2(Omega)) error': 0.0013735058079687849}),
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'constant',
      '--element', 'P1', '--solverType', 'lu', '--matrixFormat', 'H2'],
     {'L^2(0,T; L^2(Omega)) error': 0.001373502781639159,
      'L^2(0,T; L^2(Omega)) norm': 0.9834421000848615,
      'L^2(Omega) error at t=finalTime': 0.0006828706231417642}),
    (['--domain', 'interval', '--s', 'const(0.25)', '--problem',
      'knownSolution', '--element', 'P1', '--solverType', 'cg-jacobi',
      '--matrixFormat', 'H2'],
     {'L^2(0,T; L^2(Omega)) error': 0.0018388585398440504,
      'L^2(0,T; L^2(Omega)) norm': 1.3228634831094461}),
    # zeroFlux heat: reference cache corresponds to one extra refinement
    # (see test_drivers_fractional.SWEPT_CONFIGS)
    (['--domain', 'interval', '--s', 'const(0.75)', '--problem', 'zeroFlux',
      '--element', 'P1', '--solverType', 'cg-jacobi', '--matrixFormat', 'H2',
      '--noRef', '7'],
     {'L^2(0,T; L^2(Omega)) error': 0.024601746738185586,
      'L^2(0,T; L^2(Omega)) norm': 0.9634983119319441}),
]


@pytest.mark.slow
@pytest.mark.parametrize('argv,expected', HEAT_H2_CONFIGS,
                         ids=['P2-H2', 'varconst-H2', 'lu-H2',
                              'knownSol-H2', 'zeroFlux-H2'])
def test_runFractionalHeat_H2(argv, expected):
    d, mS = runFractionalHeat(argv)
    got = d.outputGroups['errors'].toDict()
    for label, val in expected.items():
        assert np.isclose(got[label], val, rtol=3e-2, atol=1e-8), \
            (label, got[label], val)
