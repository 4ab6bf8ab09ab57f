#!/usr/bin/env python3
"""Measured crossover: sparse near-field vs compressed (horizonCorrected)
representation of the finite-horizon operator.

The reference compresses admissible within-horizon cluster pairs
(clusterMethodCy.pyx:4019-4033).  Our H2 delegates finite horizons to the
exact sparse format; the compressed alternative is getH2FiniteHorizon
(infinite-horizon H2 + mass shift + complement correction,
ref nonlocalAssembly.pyx:182-260).  This script measures build time, memory,
and matvec time of both at the delta/h ratios the drivers use (up to 100)
so the default is a measured decision, not a guess.

Run: python scripts/bench_finite_horizon.py [--platform cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument('--platform', default=None)
ap.add_argument('--dim', type=int, default=1)
args = ap.parse_args()
if args.platform:
    import jax
    jax.config.update('jax_platforms', args.platform)

import jax
import numpy as np
import jax.numpy as jnp

import pynucleus_tpu  # noqa: F401
from pynucleus_tpu.fem import simpleInterval, P1_DoFMap
from pynucleus_tpu.fem.mesh_zoo import uniformSquare
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def sizeOf(op):
    import numpy as _np
    seen = set()
    total = 0

    def walk(o):
        nonlocal total
        if id(o) in seen or o is None:
            return
        seen.add(id(o))
        if isinstance(o, (jax.Array, _np.ndarray)):
            total += o.size * o.dtype.itemsize
            return
        for v in getattr(o, '__dict__', {}).values():
            if isinstance(v, (list, tuple)):
                for w in v:
                    walk(w)
            else:
                walk(v)
    walk(op)
    return total


def bench(dim, ratio, noRef):
    if dim == 1:
        m = simpleInterval(-1.0, 1.0)
        for _ in range(noRef):
            m = m.refine()
    else:
        m = uniformSquare(2 ** noRef + 1)
    dm = P1_DoFMap(m)
    delta = ratio * m.h
    kernel = getFractionalKernel(dim, 0.25, horizon=delta)
    x = jnp.asarray(np.sin(np.linspace(0, 3, dm.num_dofs)))

    out = {'dofs': dm.num_dofs, 'ratio': ratio}
    t0 = time.perf_counter()
    As = nonlocalBuilder(dm, kernel).getSparse()
    out['sparse_build_s'] = time.perf_counter() - t0
    out['sparse_MB'] = sizeOf(As) / 1e6
    jax.block_until_ready(As.matvec(x))
    t0 = time.perf_counter()
    for _ in range(5):
        jax.block_until_ready(As.matvec(x))
    out['sparse_matvec_ms'] = (time.perf_counter() - t0) / 5 * 1e3

    t0 = time.perf_counter()
    Ac = nonlocalBuilder(dm, kernel).getH2FiniteHorizon()
    Ac.setKernel(kernel)
    out['corrected_build_s'] = time.perf_counter() - t0
    out['corrected_MB'] = sizeOf(Ac) / 1e6
    jax.block_until_ready(Ac.matvec(x))
    t0 = time.perf_counter()
    for _ in range(5):
        jax.block_until_ready(Ac.matvec(x))
    out['corrected_matvec_ms'] = (time.perf_counter() - t0) / 5 * 1e3
    err = float(jnp.linalg.norm(As.matvec(x) - Ac.matvec(x))
                / jnp.linalg.norm(As.matvec(x)))
    out['rel_matvec_diff'] = err
    return out


if __name__ == '__main__':
    for ratio, noRef in ((25, 11), (50, 12), (100, 13)) \
            if args.dim == 1 else ((10, 5), (25, 6)):
        r = bench(args.dim, ratio, noRef)
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in r.items()}, flush=True)
