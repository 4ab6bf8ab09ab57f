#!/usr/bin/env python3
"""Transient fractional heat equation via theta-scheme time stepping.

Counterpart of the reference's drivers/runFractionalHeat.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pynucleus_tpu.base import driver
from pynucleus_tpu.nl.problems import transientFractionalProblem
from pynucleus_tpu.nl.discretized import discretizedTransientProblem


def main(argv=None):
    d = driver()
    p = transientFractionalProblem(d)
    discrProblem = discretizedTransientProblem(d, p)
    d.process(argv=argv, override={'adaptive': None})

    mS = discrProblem.modelSolution

    results = d.addOutputGroup('results')
    discrProblem.report(results)
    results.add('dt', discrProblem.dt)
    results.add('numTimeSteps', discrProblem.numTimeSteps)
    results.log()

    errors = d.addOutputGroup('errors', tested=True)
    mS.reportErrors(errors)
    errors.log()

    d.finish()
    return d, mS


if __name__ == '__main__':
    main()
