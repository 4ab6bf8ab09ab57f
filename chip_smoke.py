#!/usr/bin/env python3
"""Smoke run of the fractional-Poisson main path on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: parity, main, h2_vs_dense, f32
    python chip_smoke.py --four   # four GPUs: the multi-device phases only

Phases (one process; every kernel runs as XLA compiled it for the card):

  parity       drivers/runFractional.py's entry point on the 1D dense and H2
               configs pinned in tests/test_drivers_fractional.py (reference
               values, rtol 3e-2), and on the 2D disc H2 cg-mg config at
               --noRef 3 and 4 against the float64 values pinned below from
               the CPU path (PINS_F64).
  main         the north-star deployment (disc, s=0.75, P1, H2, cg-mg, f64)
               at --noRef 6 and 7: build and solve times, iterations, errors
               and peak device memory per rung.
  h2_vs_dense  the --noRef 6 H2 operator against the dense operator.
  f32          the float32 H2 build with CG-Jacobi, the path bench.py takes
               on an accelerator.
  four         (--four) S1 sharded dense assembly + CG, S2 sharded multigrid,
               S4 distributed H2 (1D, and the --noRef 6 disc operator), each
               against its one-device run.

Times printed here are smoke times labelled with the card, not benchmark
cells.  Any failed check raises, so the script exits non-zero; the last line
of stdout is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

DISC = ['--domain', 'disc', '--s', 'const(0.75)', '--problem', 'constant',
        '--element', 'P1', '--solverType', 'cg-mg', '--matrixFormat', 'H2']

# Disc H2 cg-mg outputs of the float64 CPU path (JAX_PLATFORMS=cpu).  Both
# sides run f64 and differ only in summation order (XLA fusion, scatter-add
# atomics), which the solver tolerance bounds: rtol 1e-6 on the errors and
# +-1 on the iteration count.
PINS_F64 = {
    3: {'iterations': 6, 'errors': {
        'L2 error': 0.013039845165499496,
        'relative L2 error': 0.027790900151395733,
        'L2 error interpolated': 0.002817297473454092,
        'relative interpolated L2 error': 0.0060525645753327015,
        'Linf error interpolated': 0.003685467229733036,
        'relative interpolated Linf error': 0.00880496563224835,
        'Hs error': 0.12986380370507097,
        'relative Hs error': 0.14981309036922721}},
    4: {'iterations': 6, 'errors': {
        'L2 error': 0.005804028040508529,
        'relative L2 error': 0.012369714647872886,
        'L2 error interpolated': 0.0021989833186225128,
        'relative interpolated L2 error': 0.004695959697799606,
        'Linf error interpolated': 0.0021345750733249846,
        'relative interpolated Linf error': 0.00509972250151901,
        'Hs error': 0.0876527177550691,
        'relative Hs error': 0.10111766444151804}},
}
PIN_RTOL = 1e-6
PIN_ITERS = 1

# float32 disc H2 operator of the CPU path: F32_PROBES seeded projections
# of H @ x for a seeded x.  f32 summation order moves them by ~1e-6; TF32
# matmuls (about three digits) would move them by ~1e-3.
PINS_F32 = {
    3: [11.633394574182981, -14.82151770268481, 0.45935219396224625,
        -6.086594753804363, 6.151966688797839, 3.4775250852648454,
        0.8143079186706749, -0.8079947802830031],
    4: [-7.68043687558265, -5.844302065802258, -20.569517606687864,
        -9.15872934886402, -23.06592000717436, -3.95554416770167,
        7.6474464203388335, 3.702251344997351],
}
F32_RTOL = 1e-4
F32_PROBES = 8

# H2 against dense: the tolerance of tests/test_devicecsr_nearfield.py.
H2_DENSE_RTOL = 1e-5
# L2 convergence rate bound of tests/test_fracLapl_2d.py.
RATE_MIN = 0.8
# multigrid iterations do not depend on the mesh
MG_ITER_SPREAD = 2
# f32 solution against the f64 one, in the L2 (mass) norm: f32 rounding and
# the CG tolerance must stay below this fraction of the f64 discretization
# error.
F32_ERR_FRACTION = 0.1


# ---------------------------------------------------------------- helpers --

class _CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations (summed
    over threads, so parallel compiles can exceed the wall time)."""

    EVENTS = ('/jax/core/compile/jaxpr_trace_duration',
              '/jax/core/compile/jaxpr_to_mlir_module_duration',
              '/jax/core/compile/backend_compile_duration')

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.seconds += duration


def _card():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'],
                       capture_output=True, text=True, timeout=60, check=True)
    return '; '.join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def preflight(nDevices):
    """Refuse to run without nDevices GPUs; print the run's context."""
    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        sys.exit(f'chip_smoke: needs a GPU; JAX found {devs[0].platform!r}')
    if len(devs) < nDevices:
        sys.exit(f'chip_smoke: needs {nDevices} GPUs; JAX found {len(devs)}')
    import pynucleus_tpu  # noqa: F401  (x64, matmul precision, cache)
    from pynucleus_tpu.config import compileCacheDir
    card = _card()
    print(f'device_kind: {devs[0].device_kind}')
    print(f'device count: {len(devs)}')
    print(f'jax: {jax.__version__}')
    print(f'card: {card}')
    print(f'jax_enable_x64: {jax.config.jax_enable_x64}')
    print(f'jax_default_matmul_precision: '
          f'{jax.config.jax_default_matmul_precision}')
    print(f'compile cache: {compileCacheDir()}')
    return card


def _finite(*vals):
    import numpy as np
    for v in vals:
        assert np.all(np.isfinite(np.asarray(v, dtype=float))), vals


def _peakBytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get('peak_bytes_in_use')


def runFractional(argv):
    """drivers/runFractional.py's entry point; returns (outputs, driver,
    model solution)."""
    from drivers.runFractional import main
    d, mS = main(argv)
    out = {'dofs': d.outputGroups['results'].toDict()['dofs'],
           'iterations': d.outputGroups['results'].toDict()['iterations'],
           'errors': d.outputGroups['errors'].toDict()}
    return out, d, mS


def discProblem(noRef):
    """The disc deployment's discretized problem (mesh, dofs, kernel, rhs)
    as the driver sets it up, without assembling or solving."""
    from pynucleus_tpu.base import driver
    from pynucleus_tpu.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu.nl.discretized import discretizedNonlocalProblem
    d = driver()
    dp = discretizedNonlocalProblem(d, fractionalLaplacianProblem(d))
    d.process(argv=DISC + ['--noRef', str(noRef)], override={'adaptive': None})
    return dp


# ----------------------------------------------------------------- phases --

def checkDiscPin(noRef):
    """Disc H2 cg-mg at noRef against PINS_F64; returns the outputs."""
    import numpy as np
    out, _, _ = runFractional(DISC + ['--noRef', str(noRef)])
    pin = PINS_F64[noRef]
    print(f'  disc noRef={noRef}: dofs={out["dofs"]} '
          f'iterations={out["iterations"]} (pinned {pin["iterations"]}) '
          f'errors={out["errors"]}')
    assert abs(out['iterations'] - pin['iterations']) <= PIN_ITERS, \
        (out['iterations'], pin['iterations'])
    for label, val in pin['errors'].items():
        assert np.isclose(out['errors'][label], val, rtol=PIN_RTOL, atol=0), \
            (noRef, label, out['errors'][label], val)
    return out


def phaseParity():
    """Reference-pinned 1D configs, then the CPU-pinned disc rungs.
    Returns the disc outputs by rung."""
    import importlib.util
    import numpy as np
    # loaded by path: an installed package named `tests` would shadow the
    # repository's test directory
    spec = importlib.util.spec_from_file_location(
        '_runFractional_pins',
        os.path.join(HERE, 'tests', 'test_drivers_fractional.py'))
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    for cfg in list(pins.CONFIGS) + list(pins.H2_CONFIGS):
        argv, expected = getattr(cfg, 'values', cfg)
        out, _, _ = runFractional(list(argv))
        name = ' '.join(a for a in argv if not a.startswith('--'))
        print(f'  1D {name}: errors={out["errors"]}')
        for label, val in expected.items():
            assert np.isclose(out['errors'][label], val, rtol=3e-2,
                              atol=1e-8), (name, label, out['errors'][label],
                                           val)
    return {n: checkDiscPin(n) for n in PINS_F64}


def phaseMain(rungs, refIterations, card=''):
    """The north-star deployment at each rung.  Returns {rung: (outputs,
    model solution)}."""
    import numpy as np
    res = {}
    for n in rungs:
        out, d, mS = runFractional(DISC + ['--noRef', str(n)])
        t = d.timers.durations
        row = {'dofs': out['dofs'], 'iterations': out['iterations'],
               'fine H2 build s': t['assembly'][-1],
               'hierarchy build s': sum(t['assembly']),
               'MG setup s': t['solver setup'][0],
               'solve s': t['solve'][0],
               'peak_bytes_in_use': _peakBytes()}
        print(f'  rung noRef={n} [{card}]: {row} errors={out["errors"]}')
        _finite(*[v for v in row.values() if v is not None],
                *out['errors'].values())
        assert abs(out['iterations'] - refIterations) <= MG_ITER_SPREAD, \
            (n, out['iterations'], refIterations)
        res[n] = (out, mS)
    for lo, hi in zip(rungs[:-1], rungs[1:]):
        e0 = res[lo][0]['errors']['L2 error']
        e1 = res[hi][0]['errors']['L2 error']
        rate = np.log2(e0 / e1) / (hi - lo)
        print(f'  L2 rate noRef {lo}->{hi}: {rate:.4f} (bound > {RATE_MIN})')
        assert rate > RATE_MIN, (lo, hi, e0, e1, rate)
    return res


def phaseH2VsDense(mS):
    """H2 @ x against dense @ x (dense through getDense, the grid path on a
    GPU) for the operator of a finished driver run."""
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    dp = mS.discretizedProblem
    dm = dp.dmInterior
    D = nonlocalBuilder(dm, dp.kernel, zeroExterior=dp.zeroExterior).getDense()
    x = jnp.asarray(np.random.default_rng(0).normal(size=dm.num_dofs))
    ref = D @ x
    err = float(jnp.linalg.norm(dp.A.matvec(x) - ref) / jnp.linalg.norm(ref))
    print(f'  dofs={dm.num_dofs}: |H2 x - dense x|/|dense x| = {err:.3e} '
          f'(bound {H2_DENSE_RTOL})')
    _finite(err)
    assert err < H2_DENSE_RTOL, err
    return err


def f32Probes(dp):
    """F32_PROBES seeded projections of H32 @ x for the float32 H2 build
    of a discretized problem."""
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    dm = dp.dmInterior
    H = nonlocalBuilder(dm, dp.kernel, params={'dtype': np.float32},
                        zeroExterior=dp.zeroExterior).getH2()
    rng = np.random.default_rng(0)
    x = rng.normal(size=dm.num_dofs).astype(np.float32)
    W = rng.normal(size=(F32_PROBES, dm.num_dofs))
    y = np.asarray(H.matvec(jnp.asarray(x)), dtype=np.float64)
    return W @ y


def phaseF32(mS64, pinRung):
    """float32 H2 + CG-Jacobi: the pinned f32 probes at pinRung (TF32
    check), then the f32 solve of mS64's problem against its f64 solution."""
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.base.solvers import solverFactory
    from pynucleus_tpu.fem.dofmaps import fe_vector
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.nl.discretized import stationaryModelSolution

    probes = f32Probes(discProblem(pinRung))
    pin = np.asarray(PINS_F32[pinRung])
    dev = float(np.linalg.norm(probes - pin) / np.linalg.norm(pin))
    print(f'  noRef={pinRung}: f32 H2 probes vs CPU pin: rel {dev:.3e} '
          f'(bound {F32_RTOL})')
    assert dev < F32_RTOL, (dev, probes.tolist(), pin.tolist())

    dp = mS64.discretizedProblem
    dm = dp.dmInterior
    H = nonlocalBuilder(dm, dp.kernel, params={'dtype': np.float32},
                        zeroExterior=dp.zeroExterior).getH2()
    cg = solverFactory.build('cg-jacobi', A=H, setup=True)
    cg.tolerance = 1e-6
    cg.maxIter = 5000
    u32 = cg.solve(jnp.asarray(np.asarray(dp.b.data, dtype=np.float32)))
    u = fe_vector(jnp.asarray(np.asarray(u32, dtype=np.float64)), dm)
    mS32 = stationaryModelSolution(
        dp, u, analyticSolution=mS64.analyticSolution,
        exactL2Squared=mS64.exactL2Squared)
    d = u.data - mS64.u.data
    diff = float(jnp.sqrt(jnp.vdot(d, dp.massInterior @ d)))
    e64 = mS64.L2_error_interp
    print(f'  dofs={dm.num_dofs}: CG-Jacobi iterations={cg.iterations}, '
          f'|u32 - u64|_L2 = {diff:.3e}, interpolated L2 error f32 '
          f'{mS32.L2_error_interp:.6e} / f64 {e64:.6e} '
          f'(bound |u32 - u64| < {F32_ERR_FRACTION} x f64 error)')
    _finite(diff, mS32.L2_error_interp)
    assert diff < F32_ERR_FRACTION * e64, (diff, e64)
    return {'probeDev': dev, 'diff': diff, 'e32': mS32.L2_error_interp,
            'e64': e64}


def phaseFour(card='', discRung=6):
    """S1, S2 and S4 on four devices, each against one device."""
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.parallel import makeDeviceMesh
    from pynucleus_tpu.parallel.dist import (dryrunShardedDense,
                                             dryrunShardedGMG)
    from pynucleus_tpu.parallel.dist_h2 import (dryrunDistributedH2,
                                                DistributedH2Matrix)
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    mesh = makeDeviceMesh(4)
    for label, fn in (('S1', dryrunShardedDense), ('S2', dryrunShardedGMG),
                      ('S4', dryrunDistributedH2)):
        t0 = time.perf_counter()
        fn(mesh)
        print(f'  [{label} {time.perf_counter() - t0:.3f} s, {card}]')
    t0 = time.perf_counter()
    dp = discProblem(discRung)
    H = nonlocalBuilder(dp.dmInterior, dp.kernel,
                        zeroExterior=dp.zeroExterior).getH2()
    Ad = DistributedH2Matrix(H, mesh)
    x = jnp.asarray(np.random.default_rng(0).normal(size=H.num_rows))
    ref = H.matvec(x)
    err = float(jnp.linalg.norm(Ad.matvec(x) - ref) / jnp.linalg.norm(ref))
    print(f'  S4 disc noRef={discRung}: dofs={H.num_rows}, '
          f'|distH2 x - H2 x|/|H2 x| '
          f'= {err:.3e} [{time.perf_counter() - t0:.3f} s, {card}]')
    _finite(err)
    assert err < 1e-10, err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the multi-device phases, on four GPUs')
    args = ap.parse_args(argv)
    nDev = 4 if args.four else 1
    card = preflight(nDev)
    clock = _CompileClock()

    def phase(name, fn, *a):
        c0, t0 = clock.seconds, time.perf_counter()
        r = fn(*a)
        print(f'[{name}] ok: wall {time.perf_counter() - t0:.3f} s, '
              f'compile {clock.seconds - c0:.3f} s  ({card})', flush=True)
        return r

    if args.four:
        phase('four', phaseFour, card)
    else:
        disc = phase('parity', phaseParity)
        rungs = phase('main', phaseMain, (6, 7), disc[4]['iterations'], card)
        mS6 = rungs[6][1]
        phase('h2_vs_dense', phaseH2VsDense, mS6)
        phase('f32', phaseF32, mS6, 4)
    import jax
    dev = jax.devices()[0]
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}))


if __name__ == '__main__':
    main()
