#!/usr/bin/env python3
"""Solve fractional Poisson problems (infinite horizon) in dense/sparse/H2
formats with direct or multigrid-preconditioned Krylov solvers.

Counterpart of the reference's drivers/runFractional.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pynucleus_tpu.base import driver
from pynucleus_tpu.nl.problems import fractionalLaplacianProblem
from pynucleus_tpu.nl.discretized import discretizedNonlocalProblem


def main(argv=None):
    d = driver()
    p = fractionalLaplacianProblem(d)
    discrProblem = discretizedNonlocalProblem(d, p)

    d.process(argv=argv, override={'adaptive': None})

    mS = discrProblem.modelSolution

    results = d.addOutputGroup('results')
    discrProblem.report(results)
    mS.reportSolve(results)
    results.log()

    errors = d.addOutputGroup('errors', tested=True)
    mS.reportErrors(errors)
    errors.log()

    d.finish()
    return d, mS


if __name__ == '__main__':
    main()
