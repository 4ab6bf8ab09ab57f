#!/usr/bin/env python3
"""Benchmark: the BASELINE.json metrics on the attached GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "extras"}.
It refuses to run without a GPU, and names the card and its power limit
(nvidia-smi) on stderr and in extras.device.

  1. 2D fractional dense assembly throughput (disc, s=0.75, P1) in
     elem-pairs/s at BENCH_NOREF (default 6, ~537M pairs).
  2. H2 build + matvec time (1D fractional at BENCH_H2_NOREF refinements,
     and 2D at BENCH_H2_2D_NOREF).
  3. assemble + CG solve wall-clock (2D fractional, H2 format, cg-jacobi)
     at BENCH_SOLVE_NOREF.

Baseline: the Cython reference cannot be built in this image (no Cython, no
mpi4py), so the measured anchor is native/ref_pair_loop.cpp — a C++
reimplementation of the reference's per-element-pair hot loop
(nonlocalAssembly_{SCALAR}.pxi:1387-1450) driven with the SAME pair lists
and quadrature tables, compiled -O3 -march=native and timed on this
container's CPU (single core).  vs_baseline = our chip throughput /
(8 x measured single-core rate), a ratio kept from an earlier north-star
(one device against 8 cores); the extrapolated 64-core comparison is in
extras.

Robustness (two layers):
  * every metric runs in its own SUBPROCESS with a per-metric timeout, so a
    wedged metric cannot take down the whole benchmark;
  * the whole run observes a single GLOBAL wall-clock budget (env
    BENCH_BUDGET, default 420 s).  Metrics run in priority order (primary
    assembly metric first); once the remaining budget is too small for the
    next metric it degrades to {'error': 'skipped: budget'} and the final
    JSON line still prints.  If the live C++ anchor is skipped, the
    committed measured rate (CPP_RATE_RECORDED, measured on this container,
    see extras.cpp_baseline.source) anchors vs_baseline instead.
"""
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

_T0 = time.monotonic()
_BUDGET = float(os.environ.get('BENCH_BUDGET', '420'))
# reserve for final JSON assembly / interpreter teardown
_RESERVE = 5.0

# Measured on this container (1 CPU core, -O3 -march=native) via
# `python bench.py --metric baseline`; used when the live anchor is skipped
# for budget.  Units: element pairs / s for the reference per-pair loop.
CPP_RATE_RECORDED = 351e3


def _remaining():
    return _BUDGET - (time.monotonic() - _T0) - _RESERVE


def _devAndDtype():
    import jax
    import numpy as np
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit(f'bench: needs a GPU; JAX found {dev.platform!r}')
    return dev, np.float32


def _requireGpu():
    """Exit unless JAX sees a GPU; returns the device description.  JAX is
    probed in a child process: this parent stays off the card, so each
    metric subprocess gets the card's memory."""
    r = subprocess.run(
        [sys.executable, '-c',
         'import jax; d = jax.devices(); '
         'print(d[0].platform, len(d), d[0].device_kind, sep="|")'],
        capture_output=True, text=True, timeout=300)
    fields = r.stdout.strip().splitlines()[-1].split('|', 2) \
        if r.returncode == 0 and r.stdout.strip() else ['none', '0', '']
    if fields[0] != 'gpu':
        sys.exit(f'bench: needs a GPU; JAX found {fields[0]!r}')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = {'platform': fields[0], 'count': int(fields[1]),
           'device_kind': fields[2], 'card': card}
    print(f'[bench] {dev}', file=sys.stderr)
    return dev


def _steadyMatvec(H, x, iters=64):
    """Steady-state matvec seconds/iter: a device-side normalized power
    iteration (one executable, `iters` applications) -- measures the
    operator apply without per-call dispatch latency, exactly how CG/GMRES
    consume it (they run device-side via lax.while_loop)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(H, x):
        def body(i, y):
            y2 = H.matvec(y)
            return y2 / (1e-30 + jnp.max(jnp.abs(y2)))
        return jax.lax.fori_loop(0, iters, body, x)

    y = loop(H, x)
    float(jnp.sum(y))                       # compile + first run + sync
    t0 = time.perf_counter()
    y = loop(H, x)
    float(jnp.sum(y))
    return (time.perf_counter() - t0) / iters


def _mesh2d(noRef):
    from pynucleus_tpu.fem import circle
    m = circle(n=8)
    for _ in range(noRef):
        m = m.refine()
    return m


def benchAssembly():
    import jax
    import numpy as np
    import pynucleus_tpu  # noqa: F401
    from pynucleus_tpu.fem import P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    dev, dtype = _devAndDtype()
    noRef = int(os.environ.get('BENCH_NOREF', '6'))
    m = _mesh2d(noRef)
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(2, 0.75)
    C = m.num_cells
    nPairs = C * (C + 1) // 2
    # warmup compiles all shapes once (persistent XLA cache across runs);
    # block_until_ready so 'cold' is a real number, not async-dispatch time
    # (r04's 17.8 s cold / hung warm was exactly that mirage: the cold
    # device work drained inside the warm measurement)
    t0 = time.perf_counter()
    A = nonlocalBuilder(dm, kernel, params={'dtype': dtype}).getDense()
    jax.block_until_ready(A.data)
    cold = time.perf_counter() - t0
    out = {'pairs_per_s': nPairs / cold, 'nPairs': nPairs,
           'ndofs': dm.num_dofs, 'assembly_s': cold,
           'cold_assembly_s': cold, 'platform': dev.platform,
           'stage': 'cold only'}
    print(json.dumps(out), flush=True)      # partial: salvaged on timeout
    t0 = time.perf_counter()
    A = nonlocalBuilder(dm, kernel, params={'dtype': dtype}).getDense()
    jax.block_until_ready(A.data)
    elapsed = time.perf_counter() - t0
    out.update(pairs_per_s=nPairs / elapsed, assembly_s=elapsed,
               stage='warm')
    print(json.dumps(out), flush=True)
    out.pop('stage')
    return out


def benchBaselineCpp():
    """Measured reference stand-in: C++ per-pair loop, single core, at the
    largest size where full pair enumeration fits; the per-pair rate is
    extrapolated one refinement by its own growth ratio (the mix shifts
    toward cheaper low-order pairs as the mesh refines)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import pynucleus_tpu  # noqa: F401
    from pynucleus_tpu.fem import P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.bench_baseline import timeReferencePairLoop
    from pynucleus_tpu.nl.panels import classifyPairsDense
    kernel = getFractionalKernel(2, 0.75)
    rates = []
    for noRef in (4, 5):
        m = _mesh2d(noRef)
        dm = P1_DoFMap(m)
        b = nonlocalBuilder(dm, kernel)
        info = b._makeRules(classifyPairsDense(dm, kernel))
        secs, nP = timeReferencePairLoop(dm, kernel, info)
        rates.append(nP / secs)
    growth = max(rates[1] / rates[0], 1.0)
    return {'cpp_rate_1core': rates[1] * growth,
            'cpp_rates_noRef45': rates}


def benchH2Matvec():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pynucleus_tpu  # noqa: F401
    from pynucleus_tpu.fem import simpleInterval, P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    dev, dtype = _devAndDtype()
    noRef = int(os.environ.get('BENCH_H2_NOREF', '16'))
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(1, 0.75)
    print(json.dumps({'h2_1d': {'dofs': dm.num_dofs,
                                'stage': 'building'}}), flush=True)
    t0 = time.perf_counter()
    H = nonlocalBuilder(dm, kernel, params={'dtype': dtype}).getH2()
    jax.block_until_ready(H.Anear.dataZ)
    build = time.perf_counter() - t0
    out = {'dofs': dm.num_dofs, 'build_s': build, 'stage': 'built'}
    print(json.dumps({'h2_1d': out}), flush=True)
    x = np.sin(np.pi * np.linspace(-1, 1, dm.num_dofs)).astype(dtype)
    xd = jnp.asarray(x)
    out['matvec_s'] = _steadyMatvec(H, xd)
    out['stage'] = 'done'
    return out


def benchH2Matvec2D(noRef=None):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pynucleus_tpu  # noqa: F401
    from pynucleus_tpu.fem import P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    dev, dtype = _devAndDtype()
    if noRef is None:
        noRef = int(os.environ.get('BENCH_H2_2D_NOREF', '6'))
    m = _mesh2d(noRef)
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(2, 0.75)
    print(json.dumps({'h2_2d': {'dofs': dm.num_dofs,
                                'stage': 'building'}}), flush=True)
    t0 = time.perf_counter()
    H = nonlocalBuilder(dm, kernel, params={'dtype': dtype}).getH2()
    jax.block_until_ready(H.Anear.dataZ)
    build = time.perf_counter() - t0
    r = {'dofs': dm.num_dofs, 'build_s': build, 'stage': 'built'}
    print(json.dumps({'h2_2d': r}), flush=True)
    # CG first: the solve metric (BASELINE.json) must land even if a slow
    # stage eats the rest of the budget
    if os.environ.get('BENCH_H2_2D_SOLVE', '1') != '0':
        r['cg'] = _cgSolve(H, dm, dtype)
        print(json.dumps({'h2_2d': r}), flush=True)
    x = np.random.default_rng(0).normal(size=dm.num_dofs).astype(dtype)
    xd = jnp.asarray(x)
    r['matvec_s'] = _steadyMatvec(H, xd)
    r['stage'] = 'done'
    print(json.dumps({'h2_2d': r}), flush=True)
    return r


def _cgSolve(H, dm, dtype):
    """CG-Jacobi solve on an already-built H2 operator (the 'CG solve'
    timer of ref drivers/testDistOp.py:386)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pynucleus_tpu.fem import assembleRHS, constant
    from pynucleus_tpu.base.solvers import _cg_core
    from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator
    b = jnp.asarray(np.asarray(assembleRHS(dm, constant(1.0)).data,
                               dtype=dtype))
    M = Diagonal_LinearOperator(1.0 / H.diagonal)
    u, iters, _ = _cg_core(H, M, b, jnp.zeros_like(b), 1e-6, 500,
                           use_prec=True)
    float(jnp.sum(u))                    # force completion
    t0 = time.perf_counter()
    u, iters, _ = _cg_core(H, M, b, jnp.zeros_like(b), 1e-6, 500,
                           use_prec=True)
    float(jnp.sum(u))
    solve = time.perf_counter() - t0
    return {'solve_s': solve, 'cg_iters': int(iters)}


def benchSolve():
    """assemble + CG solve of the 2D fractional problem in H2 format."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pynucleus_tpu  # noqa: F401
    from pynucleus_tpu.fem import P1_DoFMap, assembleRHS, constant
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.base.solvers import _cg_core
    from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator
    dev, dtype = _devAndDtype()
    noRef = int(os.environ.get('BENCH_SOLVE_NOREF', '5'))
    m = _mesh2d(noRef)
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(2, 0.75)
    t0 = time.perf_counter()
    H = nonlocalBuilder(dm, kernel, params={'dtype': dtype}).getH2()
    b = jnp.asarray(np.asarray(assembleRHS(dm, constant(1.0)).data,
                               dtype=dtype))
    M = Diagonal_LinearOperator(1.0 / H.diagonal)
    u, iters, _ = _cg_core(H, M, b, jnp.zeros_like(b), 1e-6, 500,
                           use_prec=True)
    jax.block_until_ready(u)
    total = time.perf_counter() - t0
    return {'dofs': dm.num_dofs, 'assemble_plus_solve_s': total,
            'cg_iters': int(iters)}


def benchH2Suite():
    """1D H2 + 2D H2 (+CG solve) in ONE process: shares device init and
    the in-process compile registry.  Prints a cumulative JSON line after
    every stage so a timeout salvages the completed stages."""
    out = {}
    # 2D first: it also carries the CG-solve metric (two of the three
    # BASELINE numbers), so a budget cut degrades to losing 1D only.
    # Size by the subprocess budget: a measured number at 4k dofs beats a
    # timeout at 16k (r04 lost matvec+solve to exactly that).
    sub = float(os.environ.get('BENCH_SUBBUDGET', '0')) or None
    noRef = None
    if sub is not None and sub < 150.0:
        noRef = 5
    t0 = time.monotonic()
    try:
        out['h2_2d'] = benchH2Matvec2D(noRef=noRef)
    except Exception as e:                                    # noqa: BLE001
        out['h2_2d'] = {'error': repr(e)[-300:]}
    out['h2_2d_wall_s'] = round(time.monotonic() - t0, 1)
    print(json.dumps(out), flush=True)
    t0 = time.monotonic()
    try:
        out['h2_1d'] = benchH2Matvec()
    except Exception as e:                                    # noqa: BLE001
        out['h2_1d'] = {'error': repr(e)[-300:]}
    out['h2_1d_wall_s'] = round(time.monotonic() - t0, 1)
    return out


# priority order: primary metric first, cheap anchors next
_METRICS = {
    'assembly': (benchAssembly, 240),
    'baseline': (benchBaselineCpp, 120),
    'h2': (benchH2Matvec, 180),
    'h2_2d': (benchH2Matvec2D, 180),
    'solve': (benchSolve, 180),
    'h2suite': (benchH2Suite, 420),
}


def _runMetricSubprocess(name):
    fn, tmo = _METRICS[name]
    tmo = float(os.environ.get(f'BENCH_TIMEOUT_{name.upper()}', tmo))
    rem = _remaining()
    if rem < 25.0:
        return {'error': 'skipped: budget'}
    tmo = min(tmo, rem)
    t0 = time.monotonic()
    env = dict(os.environ, BENCH_SUBBUDGET=f'{tmo:.0f}')
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--metric', name],
            capture_output=True, text=True, timeout=tmo, cwd=_HERE, env=env)
    except subprocess.TimeoutExpired as e:
        print(f'[bench] {name}: timeout after {tmo:.0f}s', file=sys.stderr)
        # metrics print partial JSON lines as stages complete -- salvage the
        # last one so a slow run degrades results instead of zeroing them
        partial = _lastJsonLine(e.stdout)
        if partial is not None:
            partial['_partial'] = f'timeout after {tmo:.0f}s'
            return partial
        return {'error': f'timeout after {tmo:.0f}s'}
    dt = time.monotonic() - t0
    if r.returncode != 0:
        print(f'[bench] {name}: rc={r.returncode} ({dt:.0f}s)',
              file=sys.stderr)
        partial = _lastJsonLine(r.stdout)
        if partial is not None:
            partial['_partial'] = f'rc={r.returncode}'
            return partial
        return {'error': r.stderr.strip()[-500:]}
    print(f'[bench] {name}: ok ({dt:.0f}s)', file=sys.stderr)
    out = _lastJsonLine(r.stdout)
    return out if out is not None else {'error': 'unparseable output'}


def _lastJsonLine(text):
    """Merge every parseable JSON-dict line (stage partials print
    cumulatively; later lines win key-wise, nested dicts shallow-merged)."""
    if not text:
        return None
    if isinstance(text, bytes):
        text = text.decode('utf-8', 'replace')
    out = None
    for line in text.strip().splitlines():
        try:
            v = json.loads(line)
        except Exception:                                    # noqa: BLE001
            continue
        if not isinstance(v, dict):
            continue
        if out is None:
            out = {}
        for k, val in v.items():
            if (isinstance(val, dict) and isinstance(out.get(k), dict)):
                out[k].update(val)
            else:
                out[k] = val
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == '--metric':
        fn, _ = _METRICS[sys.argv[2]]
        print(json.dumps(fn()))
        return

    device = _requireGpu()
    asm = _runMetricSubprocess('assembly')
    suite = _runMetricSubprocess('h2suite')
    cpp = _runMetricSubprocess('baseline')
    h2 = suite.get('h2_1d', dict(suite) if 'error' in suite else
                   {'error': 'missing'})
    h2_2d = suite.get('h2_2d', dict(suite) if 'error' in suite else
                      {'error': 'missing'})
    slv = h2_2d.pop('cg', None) or {'error': 'skipped (see h2_2d)'}
    if isinstance(slv, dict) and 'solve_s' in slv:
        slv = dict(slv, dofs=h2_2d.get('dofs'))

    pairsPerS = asm.get('pairs_per_s', 0.0)
    if 'cpp_rate_1core' in cpp:
        cppRate = cpp['cpp_rate_1core']
        cpp['source'] = 'measured live'
    else:
        cppRate = CPP_RATE_RECORDED
        cpp = {'cpp_rate_1core': cppRate,
               'source': 'recorded (live anchor skipped: '
                         + cpp.get('error', '?') + ')'}
    vs8core = pairsPerS / (8.0 * cppRate)
    vs64core = pairsPerS / (64.0 * cppRate)

    result = {
        'metric': '2D fractional dense assembly (disc, s=0.75, P1, '
                  f"{asm.get('ndofs')} dofs, {asm.get('nPairs')} elem-pairs,"
                  f" {asm.get('platform')}); "
                  'vs_baseline = chip / 8x measured C++ ref-loop cores',
        'value': round(pairsPerS, 1),
        'unit': 'elem-pairs/s',
        'vs_baseline': round(vs8core, 3),
        'extras': {
            'device': device,
            'assembly': asm,
            'cpp_baseline': {k: (round(v, 1) if isinstance(v, float) else v)
                             for k, v in cpp.items()},
            'vs_64core_fullNorthStar_perChipOf8': round(vs64core, 4),
            'h2_matvec_1d': h2,
            'h2_matvec_2d': h2_2d,
            'cg_solve': slv,
            'h2_suite_walls': {k: suite[k] for k in
                               ('h2_1d_wall_s', 'h2_2d_wall_s')
                               if k in suite},
            'budget_s': _BUDGET,
            'wall_s': round(time.monotonic() - _T0, 1),
        },
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()
