"""Convergence criteria for iterative solvers.

Counterpart of /root/reference/base/PyNucleus_base/convergence.{pxd,pyx}
(convergenceCriterion:19, noOpConvergenceCriterion:37, plus the
master/client machinery for asynchronous distributed updates).  On a device
mesh there is a single program and norms are computed with jnp reductions
(XLA inserts the psum on sharded arrays), so the criteria reduce to
residual monitors with the same API.
"""
import numpy as np

__all__ = ['convergenceMaster', 'convergenceClient', 'convergenceCriterion',
           'noOpConvergenceCriterion']


class convergenceCriterion:
    """Track residual norms and decide convergence
    (ref convergence.pxd:19-35)."""

    def __init__(self, tol, maxiter=-1):
        self.tol = tol
        self.maxiter = maxiter
        self.residuals = []

    def begin(self, r0):
        self.residuals = [float(r0)]
        return self

    def update(self, rnorm):
        self.residuals.append(float(rnorm))

    def converged(self):
        if not self.residuals:
            return False
        if self.residuals[-1] <= self.tol:
            return True
        if self.maxiter > 0 and len(self.residuals) - 1 >= self.maxiter:
            return True
        return False

    def getIterationCount(self):
        return max(len(self.residuals) - 1, 0)

    def rate(self):
        """Geometric-mean convergence rate over the recorded history."""
        if len(self.residuals) < 2 or self.residuals[0] == 0:
            return np.nan
        k = len(self.residuals) - 1
        return (self.residuals[-1] / self.residuals[0]) ** (1.0 / k)


class noOpConvergenceCriterion(convergenceCriterion):
    """Never reports convergence before maxiter (ref convergence.pxd:37)."""

    def __init__(self, maxiter=-1):
        super().__init__(tol=-1.0, maxiter=maxiter)

    def converged(self):
        return self.maxiter > 0 and len(self.residuals) - 1 >= self.maxiter


class convergenceMaster:
    """API-parity stand-in for the reference's master rank object
    (ref convergence.pyx masterConvergenceCriterion): in a single program
    it simply owns a criterion."""

    def __init__(self, criterion):
        self.criterion = criterion

    def getCriterion(self):
        return self.criterion


class convergenceClient(convergenceMaster):
    """Clients share the master's criterion (no communication needed)."""
