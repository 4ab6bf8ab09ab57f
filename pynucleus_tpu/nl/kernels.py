"""Nonlocal kernels, fractional orders, normalizations, interaction domains.

Counterpart of /root/reference/nl/PyNucleus_nl/{kernelsCy.pyx, kernels.py,
fractionalOrders.pyx, kernelNormalization.pyx, interactionDomains.pyx,
twoPointFunctions.pyx}.  Kernels here are declarative dataclasses whose
``jaxEval(x, y)`` builds a pure-JAX expression (vectorized over leading axes),
so a kernel can be baked into a batched quadrature kernel; all classification
logic (horizon screening, admissibility) happens host-side in numpy.

Kernel convention (ref kernelsCy.pyx:159-245): the evaluated gamma includes
the 1/2 of the symmetrized bilinear form in its scaling constant, e.g. the
infinite-horizon fractional kernel is
    gamma(x,y) = C(d,s)/2 * |x-y|^{-d-2s},
    C(d,s) = 2^{2s} s Gamma(s+d/2) / (pi^{d/2} Gamma(1-s))
(ref kernelNormalization.pyx:70-105).
"""
from __future__ import annotations

import numpy as np
from scipy.special import gamma as Gamma

import jax
import jax.numpy as jnp

from ..base.factory import factory
from ..fem.functions import constant as constFunction, function

__all__ = ['interfaceTwoPoint', 'Kernel', 'FractionalKernel', 'getFractionalKernel',
           'getIntegrableKernel', 'getKernel', 'kernelFactory',
           'ComplexKernel', 'getComplexKernel', 'GREENS_2D', 'GREENS_3D',
           'constFractionalOrder', 'variableConstFractionalOrder',
           'fractionalOrderFactory', 'interactionFactory',
           'fullSpace', 'ball2', 'ballInf',
           'constantFractionalLaplacianScaling', 'constantIntegrableScaling',
           'FRACTIONAL', 'INDICATOR', 'PERIDYNAMIC', 'GAUSSIAN', 'EXPONENTIAL',
           'LOGINVERSEDISTANCE', 'MONOMIAL', 'POLYNOMIAL',
           'horizonFunction', 'variableHorizonFractionalKernel',
           'DerivativeFractionalKernel', 'MANIFOLD_FRACTIONAL']

# kernel types (ref kernelsCy.pyx:50-73)
FRACTIONAL = 'fractional'
MANIFOLD_FRACTIONAL = 'manifold_fractional'
INDICATOR = 'indicator'
PERIDYNAMIC = 'peridynamic'
GAUSSIAN = 'gaussian'
EXPONENTIAL = 'exponential'
POLYNOMIAL = 'polynomial'
LOGINVERSEDISTANCE = 'logInverseDistance'
MONOMIAL = 'monomial'
GREENS_2D = 'greens2D'
GREENS_3D = 'greens3D'


# --------------------------------------------------- Bessel J0/Y0 (device)

def _bessel_j0y0(x):
    """J0(x), Y0(x) for x > 0 as one traced expression (device).

    Abramowitz & Stegun 9.4.1-9.4.3 rational approximations (abs err
    <~5e-8): power series in (x/3)^2 below 3, modulus/phase form above.
    Used by the Greens-function kernels (ref kernelsCy.pyx:43-44
    hankel10complex = i*H0^(1) = i*J0 - Y0, via scipy.special.hankel1)."""
    xs = jnp.where(x > 1e-30, x, 1e-30)
    # small branch: t = (x/3)^2
    t = (xs / 3.0) ** 2
    j0s = (1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
          + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100))))))
    y0s = (2.0 / np.pi) * jnp.log(0.5 * xs) * j0s \
        + (0.36746691 + t * (0.60559366 + t * (-0.74350384 + t * (0.25300117
           + t * (-0.04261214 + t * (0.00427916 - t * 0.00024846))))))
    # large branch: u = 3/x, J0 = f cos(th)/sqrt(x), Y0 = f sin(th)/sqrt(x)
    u = 3.0 / jnp.maximum(xs, 3.0)
    f = (0.79788456 + u * (-0.00000077 + u * (-0.00552740 + u * (-0.00009512
         + u * (0.00137237 + u * (-0.00072805 + u * 0.00014476))))))
    th = xs - 0.78539816 + u * (-0.04166397 + u * (-0.00003954
         + u * (0.00262573 + u * (-0.00054125 + u * (-0.00029333
         + u * 0.00013558)))))
    rsqrt = 1.0 / jnp.sqrt(xs)
    j0l = f * jnp.cos(th) * rsqrt
    y0l = f * jnp.sin(th) * rsqrt
    small = xs <= 3.0
    return jnp.where(small, j0s, j0l), jnp.where(small, y0s, y0l)


# ------------------------------------------------------------ fractional orders

class fractionalOrderBase:
    """s(x, y); ref fractionalOrders.pyx:45.

    ``numParameters`` / ``evalGradJax`` expose the parametrization of the
    order (ref fractionalOrders.pxd:21 numParameters, evalGrad :59):
    derivative kernels are vector-valued with one component per parameter,
    component q carrying ds/dp_q(x, y)."""
    symmetric = True
    numParameters = 1

    def __call__(self, X, Y):
        raise NotImplementedError()

    def evalGradJax(self, x, y):
        """ds/dparams at (x, y) -> [..., numParameters] (device).  The
        default single-parameter order is s itself: gradient 1."""
        shape = jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1])
        return jnp.ones(shape + (1,))

    @property
    def min(self):
        return self.smin

    @property
    def max(self):
        return self.smax


class constFractionalOrder(fractionalOrderBase):
    def __init__(self, s):
        self.value = float(s)
        self.smin = self.smax = self.value

    def __call__(self, X, Y):
        return np.full(np.asarray(X).shape[:-1], self.value)

    def jaxEval(self, x, y):
        return jnp.full(jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1]),
                        self.value)

    def _key(self):
        return (type(self).__name__, self.value)

    def __repr__(self):
        return f'const({self.value})'


class variableConstFractionalOrder(constFractionalOrder):
    """Constant value but treated as variable (exercises the variable-order
    code paths; ref fractionalOrders.pyx variableConstFractionalOrder)."""

    def __repr__(self):
        return f'varconst({self.value})'


class constantNonSymFractionalOrder(constFractionalOrder):
    """Constant value, unsymmetric code path (ref constantNonSymFractionalOrder)."""
    symmetric = False

    def __repr__(self):
        return f'constantNonSym({self.value})'


class leftRightFractionalOrder(fractionalOrderBase):
    """s = sll if x,y < interface else srr; slr/srl across
    (ref fractionalOrders.pyx:305)."""
    symmetric = False

    def __init__(self, sll, srr, slr=None, srl=None, interface=0.0):
        self.sll, self.srr = sll, srr
        # tied cross-values (slr=sll, srl=srr) leave TWO free parameters;
        # explicit cross-values make FOUR (ref numParameters semantics)
        self._tied = slr is None and srl is None
        self.numParameters = 2 if self._tied else 4
        self.slr = slr if slr is not None else sll
        self.srl = srl if srl is not None else srr
        self.interface = interface
        self.smin = min(sll, srr, self.slr, self.srl)
        self.smax = max(sll, srr, self.slr, self.srl)

    def __call__(self, X, Y):
        X = np.atleast_2d(X)
        Y = np.atleast_2d(Y)
        xl = X[..., 0] < self.interface
        yl = Y[..., 0] < self.interface
        return np.where(xl & yl, self.sll,
                        np.where(~xl & ~yl, self.srr,
                                 np.where(xl, self.slr, self.srl)))

    def jaxEval(self, x, y):
        xl = x[..., 0] < self.interface
        yl = y[..., 0] < self.interface
        return jnp.where(xl & yl, self.sll,
                         jnp.where(~xl & ~yl, self.srr,
                                   jnp.where(xl, self.slr, self.srl)))

    def evalGradJax(self, x, y):
        xl = x[..., 0] < self.interface
        yl = y[..., 0] < self.interface
        ll = (xl & yl).astype(x.dtype)
        rr = (~xl & ~yl).astype(x.dtype)
        lr = (xl & ~yl).astype(x.dtype)
        rl = (~xl & yl).astype(x.dtype)
        if self._tied:
            # slr follows sll, srl follows srr
            return jnp.stack([ll + lr, rr + rl], axis=-1)
        return jnp.stack([ll, rr, lr, rl], axis=-1)

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.slr, self.srl,
                self.interface, self._tied)

    def __repr__(self):
        if self.slr != self.sll or self.srl != self.srr:
            return (f'twoDomain({self.sll},{self.srr},'
                    f'{self.slr},{self.srl})')
        return f'twoDomain({self.sll},{self.srr})'


class innerOuterFractionalOrder(fractionalOrderBase):
    """s depends on whether x, y lie inside the ball of radius r around
    `center`: sii inside-inside, soo outside-outside, sio/soi across
    (ref fractionalOrders.pyx:673-722 innerOuterFractionalOrder)."""

    def __init__(self, dim, sii, soo, r, center=None, sio=np.nan, soi=np.nan):
        if not np.isfinite(sio):
            sio = 0.5 * (sii + soo)
        if not np.isfinite(soi):
            soi = 0.5 * (sii + soo)
        self.dim = dim
        self.sii, self.soo, self.sio, self.soi = sii, soo, sio, soi
        self.r = float(r)
        self.center = (np.zeros(dim) if center is None
                       else np.asarray(center, dtype=np.float64))
        self.smin = min(sii, soo, sio, soi)
        self.smax = max(sii, soo, sio, soi)
        self.symmetric = (sio == soi)

    def _inside(self, X, xp):
        X = xp.asarray(X)
        c = xp.asarray(self.center)
        return xp.sum((X - c) ** 2, axis=-1) < self.r ** 2

    def __call__(self, X, Y):
        xi = self._inside(np.atleast_2d(X), np)
        yi = self._inside(np.atleast_2d(Y), np)
        return np.where(xi & yi, self.sii,
                        np.where(~xi & ~yi, self.soo,
                                 np.where(xi, self.sio, self.soi)))

    def jaxEval(self, x, y):
        xi = self._inside(x, jnp)
        yi = self._inside(y, jnp)
        return jnp.where(xi & yi, self.sii,
                         jnp.where(~xi & ~yi, self.soo,
                                   jnp.where(xi, self.sio, self.soi)))

    def _key(self):
        return (type(self).__name__, self.sii, self.soo, self.sio, self.soi,
                self.r, tuple(self.center))

    def __repr__(self):
        return f'innerOuter({self.sii},{self.soo},r={self.r})'


def _smoothstep01(t, xp):
    t = xp.clip(t, 0.0, 1.0)
    return 3.0 * t ** 2 - 2.0 * t ** 3


class smoothedLeftRightFractionalOrder(fractionalOrderBase):
    """s(x) only (unsymmetric single-variable order): smoothstep transition
    from sl to sr over [interface-r, interface+r]
    (ref fractionalOrders.pyx:390-430,641-645)."""
    symmetric = False

    def __init__(self, sll, srr, r=0.1, slope=200.0, interface=0.0):
        self.sll, self.srr = sll, srr
        self.r = float(r)
        self.interface = float(interface)
        self.smin = min(sll, srr)
        self.smax = max(sll, srr)

    def _eval1(self, X, xp):
        t = (xp.asarray(X)[..., 0] - self.interface) * (0.5 / self.r) + 0.5
        return self.sll + (self.srr - self.sll) * _smoothstep01(t, xp)

    def __call__(self, X, Y):
        # single-variable: s(x, y) = s(x)
        return self._eval1(np.atleast_2d(X), np)

    def jaxEval(self, x, y):
        return jnp.broadcast_to(self._eval1(x, jnp),
                                jnp.broadcast_shapes(x.shape[:-1],
                                                     y.shape[:-1]))

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.r,
                self.interface)

    def __repr__(self):
        return f'smoothedLeftRight({self.sll},{self.srr},r={self.r})'


class linearLeftRightFractionalOrder(fractionalOrderBase):
    """s(x) only: linear transition from sll to srr over
    [interface-r, interface+r] (ref fractionalOrders.pyx:447-471,648)."""
    symmetric = False

    def __init__(self, sll, srr, r=0.1, interface=0.0):
        self.sll, self.srr = sll, srr
        self.r = float(r)
        self.interface = float(interface)
        self.smin = min(sll, srr)
        self.smax = max(sll, srr)

    def _eval1(self, X, xp):
        t = xp.clip((xp.asarray(X)[..., 0] - self.interface + self.r)
                    / (2 * self.r), 0.0, 1.0)
        return self.sll + (self.srr - self.sll) * t

    def __call__(self, X, Y):
        return self._eval1(np.atleast_2d(X), np)

    def jaxEval(self, x, y):
        return jnp.broadcast_to(self._eval1(x, jnp),
                                jnp.broadcast_shapes(x.shape[:-1],
                                                     y.shape[:-1]))

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.r,
                self.interface)

    def __repr__(self):
        return f'linearLeftRight({self.sll},{self.srr},r={self.r})'


class smoothedInnerOuterFractionalOrder(fractionalOrderBase):
    """s(x) only: radial smoothstep from sl (inside radius) to sr
    (ref fractionalOrders.pyx:500-538,654)."""
    symmetric = False

    def __init__(self, sl, sr, r=0.1, slope=200.0, radius=0.5):
        self.sl, self.sr = sl, sr
        self.r = float(r)
        self.radius = float(radius)
        self.smin = min(sl, sr)
        self.smax = max(sl, sr)

    def _eval1(self, X, xp):
        rr = xp.sqrt(xp.sum(xp.asarray(X) ** 2, axis=-1))
        t = (rr - self.radius) * (0.5 / self.r) + 0.5
        return self.sl + (self.sr - self.sl) * _smoothstep01(t, xp)

    def __call__(self, X, Y):
        return self._eval1(np.atleast_2d(X), np)

    def jaxEval(self, x, y):
        return jnp.broadcast_to(self._eval1(x, jnp),
                                jnp.broadcast_shapes(x.shape[:-1],
                                                     y.shape[:-1]))

    def _key(self):
        return (type(self).__name__, self.sl, self.sr, self.r, self.radius)

    def __repr__(self):
        return f'smoothedInnerOuter({self.sl},{self.sr})'


class islandsFractionalOrder(fractionalOrderBase):
    """s depends on membership in the 'islands' r <= |x_i| <= r2 per
    coordinate (ref fractionalOrders.pyx:755-824)."""

    def __init__(self, sii, soo, r=0.1, r2=0.6, sio=np.nan, soi=np.nan):
        if not np.isfinite(sio):
            sio = 0.5 * (sii + soo)
        if not np.isfinite(soi):
            soi = 0.5 * (sii + soo)
        self.sii, self.soo, self.sio, self.soi = sii, soo, sio, soi
        self.r, self.r2 = float(r), float(r2)
        self.smin = min(sii, soo, sio, soi)
        self.smax = max(sii, soo, sio, soi)
        self.symmetric = (sio == soi)

    def _inIsland(self, X, xp):
        p = xp.abs(xp.asarray(X))
        return xp.all((p >= self.r) & (p <= self.r2), axis=-1)

    def __call__(self, X, Y):
        xi = self._inIsland(np.atleast_2d(X), np)
        yi = self._inIsland(np.atleast_2d(Y), np)
        return np.where(xi & yi, self.sii,
                        np.where(~xi & ~yi, self.soo,
                                 np.where(xi, self.sio, self.soi)))

    def jaxEval(self, x, y):
        xi = self._inIsland(x, jnp)
        yi = self._inIsland(y, jnp)
        return jnp.where(xi & yi, self.sii,
                         jnp.where(~xi & ~yi, self.soo,
                                   jnp.where(xi, self.sio, self.soi)))

    def _key(self):
        return (type(self).__name__, self.sii, self.soo, self.sio, self.soi,
                self.r, self.r2)

    def __repr__(self):
        return f'islands({self.sii},{self.soo})'


class layersFractionalOrder(fractionalOrderBase):
    """Layered order: the LAST coordinate selects the layer of x and y;
    s = layerOrders[I, J] (ref fractionalOrders.pyx:826-896)."""

    def __init__(self, dim, layerBoundaries, layerOrders):
        self.dim = dim
        self.layerBoundaries = np.asarray(layerBoundaries, dtype=np.float64)
        self.layerOrders = np.asarray(layerOrders, dtype=np.float64)
        self.smin = float(self.layerOrders.min())
        self.smax = float(self.layerOrders.max())
        self.symmetric = bool(np.allclose(self.layerOrders,
                                          self.layerOrders.T))

    def _layer(self, X, xp):
        c = xp.asarray(X)[..., -1]
        nL = self.layerOrders.shape[0]
        edges = xp.asarray(self.layerBoundaries[1:-1])
        idx = xp.searchsorted(edges, c, side='right') \
            if xp is np else jnp.searchsorted(edges, c, side='right')
        return xp.clip(idx, 0, nL - 1)

    def __call__(self, X, Y):
        I = self._layer(np.atleast_2d(X), np)
        J = self._layer(np.atleast_2d(Y), np)
        return self.layerOrders[I, J]

    def jaxEval(self, x, y):
        I = self._layer(x, jnp)
        J = self._layer(y, jnp)
        return jnp.asarray(self.layerOrders)[I, J]

    def _key(self):
        return (type(self).__name__, tuple(self.layerBoundaries),
                tuple(self.layerOrders.ravel()))

    def __repr__(self):
        return f'layers({self.layerOrders.shape[0]})'


class feFractionalOrder(fractionalOrderBase):
    """s(x) discretized as an FE vector (single-variable, unsymmetric;
    ref fractionalOrders.pyx:660 feFractionalOrder).

    Host evaluation uses exact FE point lookup; the jittable device path
    rasterizes s onto a regular background grid (multilinear interpolation)
    -- the reference freezes s at cell-pair centers anyway
    (kernelsCy.pyx piecewise=True evalParams), so grid accuracy at the mesh
    resolution is equivalent."""
    symmetric = False

    def __init__(self, vec, smin=None, smax=None, gridN=256):
        from ..fem.lookup import lookupFunction
        self.vec = vec
        self.dm = vec.dm
        arr = np.asarray(vec.data)
        self.smin = float(smin if smin is not None else arr.min())
        self.smax = float(smax if smax is not None else arr.max())
        self._lookup = lookupFunction(vec.dm.mesh, vec.dm, vec,
                                      fallback=0.5 * (self.smin + self.smax))
        mesh = vec.dm.mesh
        self._lo = mesh.vertices.min(axis=0)
        self._hi = mesh.vertices.max(axis=0)
        dim = mesh.dim
        n = gridN if dim == 1 else min(gridN, 192)
        axes = [np.linspace(self._lo[d], self._hi[d], n)
                for d in range(dim)]
        G = np.meshgrid(*axes, indexing='ij')
        pts = np.stack([g.ravel() for g in G], axis=1)
        vals = np.clip(self._lookup(pts), self.smin, self.smax)
        self._gridN = n
        self._grid = jnp.asarray(vals.reshape((n,) * dim))

    def __call__(self, X, Y):
        vals = np.clip(self._lookup(np.atleast_2d(X)), self.smin, self.smax)
        return np.broadcast_to(
            vals, np.broadcast_shapes(np.atleast_2d(X).shape[:-1],
                                      np.atleast_2d(Y).shape[:-1])).copy()

    def jaxEval(self, x, y):
        lo = jnp.asarray(self._lo)
        hi = jnp.asarray(self._hi)
        n = self._gridN
        t = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0) * (n - 1)
        i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
        f = t - i0
        dim = x.shape[-1]
        if dim == 1:
            g = self._grid
            v = (1 - f[..., 0]) * g[i0[..., 0]] \
                + f[..., 0] * g[i0[..., 0] + 1]
        else:
            g = self._grid
            i, j = i0[..., 0], i0[..., 1]
            fx, fy = f[..., 0], f[..., 1]
            v = ((1 - fx) * (1 - fy) * g[i, j]
                 + fx * (1 - fy) * g[i + 1, j]
                 + (1 - fx) * fy * g[i, j + 1]
                 + fx * fy * g[i + 1, j + 1])
        return jnp.broadcast_to(v, jnp.broadcast_shapes(x.shape[:-1],
                                                        y.shape[:-1]))

    @property
    def numParameters(self):
        """One parameter per dof of the order's FE vector (ref
        fractionalOrders.pyx:667 numParameters=vec.dm.num_dofs)."""
        return self.dm.num_dofs

    def _gridWeights(self):
        """W [nGrid, num_dofs]: P1 basis values of the order space at the
        background grid points; the grid rasterization is linear in the dof
        values, so ds/ds_q(x) = sum_c w_c(x) W[c, q]."""
        if getattr(self, '_W', None) is None:
            from ..fem.lookup import cellFinder
            assert self.dm.polynomialOrder == 1, \
                'feFractionalOrder gradients need a P1 order space'
            mesh = self.dm.mesh
            dim = mesh.dim
            n = self._gridN
            axes = [np.linspace(self._lo[d], self._hi[d], n)
                    for d in range(dim)]
            G = np.meshgrid(*axes, indexing='ij')
            pts = np.stack([g.ravel() for g in G], axis=1)
            fnd = cellFinder(mesh)
            W = np.zeros((pts.shape[0], self.dm.num_dofs))
            dofs = np.asarray(self.dm.dofs)
            for p in range(pts.shape[0]):
                c, lam = fnd.find(pts[p], tol=1e-8)
                if c < 0:
                    continue
                for loc in range(dofs.shape[1]):
                    q = dofs[c, loc]
                    if q >= 0:
                        W[p, q] = lam[loc]
            self._W = jnp.asarray(W)
        return self._W

    def evalGradJax(self, x, y):
        W = self._gridWeights()
        lo = jnp.asarray(self._lo)
        hi = jnp.asarray(self._hi)
        n = self._gridN
        t = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0) * (n - 1)
        i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
        f = t - i0
        dim = x.shape[-1]
        if dim == 1:
            i = i0[..., 0]
            g = (1 - f[..., 0])[..., None] * W[i] \
                + f[..., 0][..., None] * W[i + 1]
        else:
            i, j = i0[..., 0], i0[..., 1]
            fx, fy = f[..., 0][..., None], f[..., 1][..., None]
            flat = i * n + j
            g = ((1 - fx) * (1 - fy) * W[flat]
                 + fx * (1 - fy) * W[flat + n]
                 + (1 - fx) * fy * W[flat + 1]
                 + fx * fy * W[flat + n + 1])
        shape = jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1])
        return jnp.broadcast_to(g, shape + (self.dm.num_dofs,))

    def _key(self):
        return (type(self).__name__, id(self.vec), self.smin, self.smax)

    def __repr__(self):
        return f'fe({self.smin},{self.smax})'


fractionalOrderFactory = factory()
fractionalOrderFactory.register('const', constFractionalOrder)
fractionalOrderFactory.register('varconst', variableConstFractionalOrder)
fractionalOrderFactory.register('constantNonSym', constantNonSymFractionalOrder)
fractionalOrderFactory.register('twoDomain', leftRightFractionalOrder,
                                aliases=['twoDomainNonSym', 'leftRight'])
fractionalOrderFactory.register('innerOuter', innerOuterFractionalOrder)
fractionalOrderFactory.register('smoothedLeftRight',
                                smoothedLeftRightFractionalOrder,
                                aliases=['smoothedTwoDomain'])
fractionalOrderFactory.register('linearLeftRightNonSym',
                                linearLeftRightFractionalOrder)
fractionalOrderFactory.register('innerOuterNonSym',
                                smoothedInnerOuterFractionalOrder)
fractionalOrderFactory.register('islands', islandsFractionalOrder)
fractionalOrderFactory.register('layers', layersFractionalOrder)
fractionalOrderFactory.register('fe', feFractionalOrder)


# -------------------------------------------------------- two-point weights

class twoPointFunction:
    """phi(x, y) weights multiplying the kernel
    (ref twoPointFunctions.pxd:19-52).  `smooth` selects per-quadrature-point
    device evaluation (jaxEval); piecewise-constant weights use evalPairs at
    cell centers."""
    symmetric = True
    smooth = False

    def evalPairs(self, x, y):
        raise NotImplementedError()

    def jaxEval(self, x, y):
        raise NotImplementedError()


class constantTwoPoint(twoPointFunction):
    """phi = const (ref twoPointFunctions.pyx constantTwoPoint)."""

    def __init__(self, value=1.0):
        self.value = float(value)

    def evalPairs(self, x, y):
        return np.full(np.atleast_2d(x).shape[0], self.value)

    def jaxEval(self, x, y):
        return jnp.full(jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1]),
                        self.value)

    def _key(self):
        return ('constantTwoPoint', self.value)


class temperedTwoPoint(twoPointFunction):
    """phi = exp(-lambda |x-y|) (ref twoPointFunctions.pyx:245
    temperedTwoPoint)."""
    smooth = True

    def __init__(self, lambdaCoeff, dim=None):
        self.lambdaCoeff = float(lambdaCoeff)
        self.dim = dim

    def evalPairs(self, x, y):
        r = np.linalg.norm(np.atleast_2d(x) - np.atleast_2d(y), axis=-1)
        return np.exp(-self.lambdaCoeff * r)

    def jaxEval(self, x, y):
        r = jnp.sqrt(jnp.sum((x - y) ** 2, axis=-1))
        return jnp.exp(-self.lambdaCoeff * r)

    def _key(self):
        return ('temperedTwoPoint', self.lambdaCoeff)


class leftRightTwoPoint(twoPointFunction):
    """phi = vll/vrr on same-side pairs, vlr/vrl across the interface
    (ref twoPointFunctions.pyx leftRightTwoPoint)."""

    def __init__(self, vll, vrr, vlr=None, vrl=None, interface=0.0):
        self.vll, self.vrr = vll, vrr
        self.vlr = vlr if vlr is not None else 0.5 * (vll + vrr)
        self.vrl = vrl if vrl is not None else 0.5 * (vll + vrr)
        self.interface = interface
        self.symmetric = (self.vlr == self.vrl)

    def evalPairs(self, x, y):
        x0 = np.atleast_2d(x)[:, 0]
        y0 = np.atleast_2d(y)[:, 0]
        xl = x0 <= self.interface
        yl = y0 <= self.interface
        return np.where(xl & yl, self.vll,
                        np.where(~xl & ~yl, self.vrr,
                                 np.where(xl, self.vlr, self.vrl)))

    def jaxEval(self, x, y):
        xl = x[..., 0] <= self.interface
        yl = y[..., 0] <= self.interface
        return jnp.where(xl & yl, self.vll,
                         jnp.where(~xl & ~yl, self.vrr,
                                   jnp.where(xl, self.vlr, self.vrl)))

    def _key(self):
        return ('leftRightTwoPoint', self.vll, self.vrr, self.vlr, self.vrl,
                self.interface)


class lambdaTwoPoint(twoPointFunction):
    """phi from a python callable fun(x, y) (ref twoPointFunctions.pyx
    lambdaTwoPoint); host evaluation at cell centers."""

    def __init__(self, fun, symmetric=True):
        self.fun = fun
        self.symmetric = symmetric

    def evalPairs(self, x, y):
        x = np.atleast_2d(x)
        y = np.atleast_2d(y)
        return np.array([self.fun(x[k], y[k]) for k in range(x.shape[0])])

    def _key(self):
        return ('lambdaTwoPoint', id(self.fun))


class lookupTwoPoint(twoPointFunction):
    """phi(x, y) = (w(x)+w(y))/2 with w an FE vector
    (ref twoPointFunctions.pyx lookupTwoPoint)."""

    def __init__(self, vec):
        from ..fem.lookup import lookupFunction
        self.vec = vec
        self._lookup = lookupFunction(vec.dm.mesh, vec.dm, vec)

    def evalPairs(self, x, y):
        return 0.5 * (self._lookup(np.atleast_2d(x))
                      + self._lookup(np.atleast_2d(y)))

    def _key(self):
        return ('lookupTwoPoint', id(self.vec))


twoPointFunctionFactory = factory()
twoPointFunctionFactory.register('constant', constantTwoPoint,
                                 aliases=['const', 'constantTwoPoint'])
twoPointFunctionFactory.register('tempered', temperedTwoPoint,
                                 aliases=['temperedTwoPoint'])
twoPointFunctionFactory.register('leftRight', leftRightTwoPoint,
                                 aliases=['leftRightTwoPoint'])
twoPointFunctionFactory.register('lambda', lambdaTwoPoint)
twoPointFunctionFactory.register('lookup', lookupTwoPoint)


# ------------------------------------------------------------- interactions

class interactionDomain:
    """chi_{N(x)}(y); ref interactionDomains.pyx:25.  complement=True flips.

    innerRadius2/outerRadius2 give Euclidean radii with
    ball2(inner) <= interaction <= ball2(outer) for horizon-screening with
    non-Euclidean balls (ref getRelativePosition INTERACT/CUT/REMOTE)."""
    complement = False

    def innerRadius2(self, hv, dim):
        return hv

    def outerRadius2(self, hv, dim):
        return hv
    symmetric = True

    def dist2(self, DX):
        """Squared 'interaction norm' of x-y, vectorized [..., dim] -> [...]."""
        raise NotImplementedError()

    def jaxIndicator(self, x, y, horizon2):
        """Smoothless device indicator for barycenter-mode cut cells."""
        raise NotImplementedError()

    def jaxDirNorm(self, d):
        """Interaction norm of a direction [..., dim] -> [...] on device.

        All interaction regions are norm balls {z: ||z|| < horizon}, so the
        exact radial clip of a ray x + r*d is r < horizon / ||d|| — this is
        what makes one polar cut-cell kernel exact for every domain
        (ref interactionDomains.pyx retriangulation modes
        ball2:1069 / ballInf:1210 / ball1:1632 / ellipse:1579)."""
        return jnp.sqrt(jnp.sum(d ** 2, axis=-1))


class fullSpace(interactionDomain):
    def dist2(self, DX):
        return np.zeros(np.asarray(DX).shape[:-1])

    def jaxIndicator(self, x, y, horizon2):
        return jnp.ones(jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1]))

    def __repr__(self):
        return 'fullSpace'


class ball2(interactionDomain):
    """Euclidean ball |x-y|_2 < horizon (ref interactionDomains.pyx
    ball2_barycenter:982 / ball2_retriangulation:1069; cut cells use exact
    1D interval clipping and exact 2D polar clipping, see
    assembly._bucket_cut2d_polar)."""

    def dist2(self, DX):
        DX = np.asarray(DX)
        return np.sum(DX ** 2, axis=-1)

    def jaxIndicator(self, x, y, horizon2):
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        return (r2 < horizon2).astype(x.dtype)

    def __repr__(self):
        return 'ball2'


class ballInf(interactionDomain):
    def dist2(self, DX):
        DX = np.asarray(DX)
        return np.max(np.abs(DX), axis=-1) ** 2

    def jaxIndicator(self, x, y, horizon2):
        r = jnp.max(jnp.abs(x - y), axis=-1)
        return (r * r < horizon2).astype(x.dtype)

    def outerRadius2(self, hv, dim):
        return hv * np.sqrt(dim)

    def jaxDirNorm(self, d):
        return jnp.max(jnp.abs(d), axis=-1)

    def __repr__(self):
        return 'ballInf'


class ball1(interactionDomain):
    """L1 (diamond) ball |x-y|_1 < horizon
    (ref interactionDomains.pyx:1632 ball1_retriangulation /
    :1681 ball1_barycenter)."""

    def dist2(self, DX):
        DX = np.asarray(DX)
        return np.sum(np.abs(DX), axis=-1) ** 2

    def jaxIndicator(self, x, y, horizon2):
        r = jnp.sum(jnp.abs(x - y), axis=-1)
        return (r * r < horizon2).astype(x.dtype)

    def innerRadius2(self, hv, dim):
        return hv / np.sqrt(dim)

    def jaxDirNorm(self, d):
        return jnp.sum(jnp.abs(d), axis=-1)

    def __repr__(self):
        return 'ball1'


class ellipse(interactionDomain):
    """Elliptic interaction |T (x-y)|_2 < horizon with
    T = diag(1/a, 1/b) . rot(theta) (constant axes/rotation;
    ref interactionDomains.pyx:1579 ellipse_retriangulation /
    :1606 ellipse_barycenter via linearTransformInteraction:1393)."""

    def __init__(self, aFac=1.0, bFac=0.5, theta=0.0):
        aFac = getattr(aFac, 'value', aFac)
        bFac = getattr(bFac, 'value', bFac)
        theta = getattr(theta, 'value', theta)
        assert aFac == 1.0 or bFac == 1.0, \
            'one of the two axes must be equal to 1'
        self.aFac, self.bFac, self.theta = float(aFac), float(bFac), \
            float(theta)
        c, s = np.cos(self.theta), np.sin(self.theta)
        self.T = np.array([[c / self.aFac, -s / self.aFac],
                           [s / self.bFac, c / self.bFac]])

    def dist2(self, DX):
        DX = np.asarray(DX)
        TD = np.einsum('ij,...j->...i', self.T, DX)
        return np.sum(TD ** 2, axis=-1)

    def jaxIndicator(self, x, y, horizon2):
        TD = jnp.einsum('ij,...j->...i', jnp.asarray(self.T), x - y)
        r2 = jnp.sum(TD ** 2, axis=-1)
        return (r2 < horizon2).astype(x.dtype)

    def innerRadius2(self, hv, dim):
        return hv * min(self.aFac, self.bFac)

    def outerRadius2(self, hv, dim):
        return hv * max(self.aFac, self.bFac)

    def jaxDirNorm(self, d):
        TD = jnp.einsum('ij,...j->...i', jnp.asarray(self.T), d)
        return jnp.sqrt(jnp.sum(TD ** 2, axis=-1))

    def __repr__(self):
        return f'ellipse({self.aFac},{self.bFac},{self.theta})'


class ball2Complement(interactionDomain):
    complement = True

    def dist2(self, DX):
        DX = np.asarray(DX)
        return np.sum(DX ** 2, axis=-1)

    def jaxIndicator(self, x, y, horizon2):
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        return (r2 >= horizon2).astype(x.dtype)

    def __repr__(self):
        return 'ball2Complement'


interactionFactory = factory()
interactionFactory.register('fullSpace', fullSpace, aliases=['full'])
# barycenter/retriangulation aliases: cut cells use EXACT clipping for both
# reference modes (1D interval clipping; 2D kink-split polar rays clipped
# at horizon/||d|| — exact for every norm ball, see jaxDirNorm)
interactionFactory.register('ball2', ball2,
                            aliases=['ball', 'ball2_retriangulation',
                                     'ball2_barycenter', '2'])
interactionFactory.register('ballInf', ballInf,
                            aliases=['ballInf_retriangulation',
                                     'ballInf_barycenter', 'inf'])
interactionFactory.register('ball1', ball1,
                            aliases=['ball1_retriangulation',
                                     'ball1_barycenter', '1'])
interactionFactory.register('ellipse', ellipse,
                            aliases=['ellipse_retriangulation',
                                     'ellipse_barycenter'])
interactionFactory.register('ball2Complement', ball2Complement)


# --------------------------------------------------------------- scalings

def constantFractionalLaplacianScaling(dim, s, horizon, tempered=0.0):
    """Normalization so the operator converges to -Laplacian
    (ref kernelNormalization.pyx:70-105; includes the bilinear-form 1/2)."""
    if 1.0 < s < 2.0:
        s = s - 1.0
    if horizon <= 0 or s <= 0 or s >= 1:
        return np.nan
    if horizon < np.inf:
        return (2.0 - 2 * s) * horizon ** (2 * s - 2.0) * dim \
            * Gamma(0.5 * dim) / np.pi ** (0.5 * dim) * 0.5
    if tempered == 0.0 or s == 0.5:
        return 2.0 ** (2.0 * s) * s * Gamma(s + 0.5 * dim) \
            / np.pi ** (0.5 * dim) / Gamma(1.0 - s) * 0.5
    return Gamma(0.5 * dim) / abs(Gamma(-2 * s)) / np.pi ** (0.5 * dim) * 0.25


def constantIntegrableScaling(kType, interaction, dim, horizon,
                              gaussian_variance=1.0, exponentialRate=1.0):
    """Second-moment normalizations for integrable kernels
    (ref kernelNormalization.pyx:225-290)."""
    from scipy.special import erf
    if horizon <= 0:
        return np.nan
    if kType == INDICATOR:
        if dim == 1:
            return 3.0 / horizon ** 3 / 2.0
        if dim == 2:
            if isinstance(interaction, ball2):
                return 8.0 / np.pi / horizon ** 4 / 2.0
            if isinstance(interaction, ballInf):
                return 3.0 / 4.0 / horizon ** 4 / 2.0
            if isinstance(interaction, ball1):
                # second moment of the diamond |z|_1 < delta is 2 delta^4/3
                return 3.0 / horizon ** 4 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == PERIDYNAMIC:
        if dim == 1:
            return 2.0 / horizon ** 2 / 2.0
        if dim == 2 and isinstance(interaction, ball2):
            return 6.0 / np.pi / horizon ** 3 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == GAUSSIAN:
        if dim == 1:
            if horizon < np.inf:
                return 4.0 / np.sqrt(np.pi) / (erf(3.0) - 6.0 * np.exp(-9.0) / np.sqrt(np.pi)) \
                    / (horizon / 3.0) ** 3 / 2.0
            return 1.0 / np.sqrt(2.0 * np.pi * gaussian_variance) / 2.0
        if dim == 2:
            if isinstance(interaction, ball2) and horizon < np.inf:
                return 4.0 / np.pi / (1.0 - 10.0 * np.exp(-9.0)) / (horizon / 3.0) ** 4 / 2.0
            if isinstance(interaction, fullSpace):
                return 1.0 / (2.0 * np.pi * gaussian_variance) / 2.0
        raise NotImplementedError((kType, dim))
    if kType == EXPONENTIAL:
        if dim == 1:
            if horizon < np.inf:
                return exponentialRate ** 3 / (2.0 - np.exp(-exponentialRate * horizon) *
                                               (2.0 + 2.0 * exponentialRate * horizon +
                                                (exponentialRate * horizon) ** 2)) / 2.0
            return exponentialRate ** 3 / 2.0 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == POLYNOMIAL:
        return 0.5
    if kType == LOGINVERSEDISTANCE:
        return 1.0
    raise NotImplementedError(kType)


# ----------------------------------------------------------------- kernels

class interfaceTwoPoint:
    """Interface weight phi(x, y) for two-domain kernels: 1 within the own
    subdomain, 0 within the other, 1/2 on pairs straddling the interface
    that BOTH kernels can reach (ref twoPointFunctions.pyx:152-230).
    Piecewise constant with breakpoints at interface and interface -/+
    horizon2/horizon1, which the doubleIntervalWithInteractions mesh aligns
    cells to, so evaluation at cell centers is exact per cell pair."""

    def __init__(self, horizon1, horizon2, left, interface=0.0,
                 stripLo=0.0, stripHi=1.0):
        self.horizon1 = horizon1
        self.horizon2 = horizon2
        self.left = left
        self.interface = interface
        # in 2D the physical domains occupy the strip stripLo < y < stripHi;
        # points outside it are exterior collar (ref twoPointFunctions.pyx
        # dim==2 branch hardcodes (0, 1))
        self.stripLo = stripLo
        self.stripHi = stripHi
        self.symmetric = True

    def _key(self):
        return ('interfaceTwoPoint', self.horizon1, self.horizon2,
                self.left, self.interface, self.stripLo, self.stripHi)

    def evalPairs(self, x, y):
        """x, y [P, dim] -> weights [P]."""
        c = self.interface
        x = np.atleast_2d(np.asarray(x))
        y = np.atleast_2d(np.asarray(y))
        x0, y0 = x[:, 0], y[:, 0]
        if self.left:
            w = np.full(len(x0), 0.5)
            w = np.where((x0 <= c) & (y0 <= c), 1.0, w)
            w = np.where((x0 > c) & (y0 > c), 0.0, w)
            w = np.where((x0 <= c - self.horizon2) & (y0 > c), 1.0, w)
            w = np.where((x0 > c) & (y0 <= c - self.horizon2), 1.0, w)
        else:
            w = np.full(len(x0), 0.5)
            w = np.where((x0 >= c) & (y0 >= c), 1.0, w)
            w = np.where((x0 < c) & (y0 < c), 0.0, w)
            w = np.where((x0 >= c + self.horizon1) & (y0 < c), 1.0, w)
            w = np.where((x0 < c) & (y0 >= c + self.horizon1), 1.0, w)
        if x.shape[1] >= 2:
            # strip-exterior points belong to the partner's kernel: weight 1
            # iff the in-strip partner lies on this kernel's side
            # (ref twoPointFunctions.pyx:193-242)
            xin = (x[:, 1] > self.stripLo) & (x[:, 1] < self.stripHi)
            yin = (y[:, 1] > self.stripLo) & (y[:, 1] < self.stripHi)
            own = (lambda p0: p0 <= c) if self.left else (lambda p0: p0 >= c)
            w = np.where(xin & ~yin, np.where(own(x0), 1.0, 0.0), w)
            w = np.where(~xin & yin, np.where(own(y0), 1.0, 0.0), w)
            w = np.where(~xin & ~yin, 0.0, w)
        return w


twoPointFunctionFactory.register('interface', interfaceTwoPoint,
                                 aliases=['interfaceTwoPoint'])


class Kernel:
    """Declarative nonlocal kernel gamma(x, y).

    Attributes mirror the reference Kernel (kernelsCy.pxd:21-43): dim,
    kernelType, horizon (value; variable horizons later), interaction,
    scalingValue, singularityValue, boundary flag, symmetric, complement.
    """
    variableOrder = False
    isComplex = False

    def __init__(self, dim, kernelType, horizon, interaction, scalingValue,
                 singularityValue, boundary=False, symmetric=True,
                 phiJax=None, temperedLambda=0.0, exponentParam=0.0,
                 monomialPower=0.0, variance=1.0):
        self.dim = dim
        self.kernelType = kernelType
        self.horizonValue = float(horizon)
        self.interaction = interaction if interaction is not None else fullSpace()
        self.scalingValue = float(scalingValue)
        self.singularityValue = float(singularityValue)
        self.min_singularity = self.singularityValue
        self.max_singularity = self.singularityValue
        self.boundary = boundary
        self.symmetric = symmetric
        self.phiJax = phiJax
        self.phi = None   # host two-point weight, applied per cell pair
        self.temperedLambda = temperedLambda
        self.exponentParam = exponentParam
        self.monomialPower = monomialPower
        self.variance = variance
        self.complement = self.interaction.complement
        self.variable = False
        self.variableHorizon = False
        self.valueSize = 1

    @property
    def finiteHorizon(self):
        """Bounded interaction support: complement kernels have a finite
        horizon VALUE but unbounded support |x-y| > horizon."""
        return self.horizonValue != np.inf and not self.complement

    def getSingularityValue(self):
        return self.singularityValue

    def getHorizonValue(self):
        return self.horizonValue

    def getHorizonValue2(self):
        return self.horizonValue ** 2

    # --- device evaluation ------------------------------------------------
    def evalXY(self, x, y, r2):
        """gamma from positions and squared distance (device).  Constant
        kernels ignore (x, y); variable-order fractional kernels evaluate
        s(x, y) and the pointwise normalization
        (ref kernelNormalization.pyx variableFractionalLaplacianScaling)."""
        return self._radialJax(r2)

    def _radialJax(self, r2):
        """Radial profile g(r2) WITHOUT the interaction-domain indicator."""
        C = self.scalingValue
        t = self.kernelType
        if t in (FRACTIONAL, MANIFOLD_FRACTIONAL):
            val = C * r2 ** (0.5 * self.singularityValue)
            if self.temperedLambda != 0.0:
                val = val * jnp.exp(-self.temperedLambda * jnp.sqrt(r2))
            return val
        if t == INDICATOR:
            return jnp.full_like(r2, C)
        if t == PERIDYNAMIC:
            return C * r2 ** -0.5
        if t == GAUSSIAN:
            return C * jnp.exp(-self.exponentParam * r2)
        if t == EXPONENTIAL:
            return C * jnp.exp(-self.exponentParam * jnp.sqrt(r2))
        if t == 'gaussianBoundary':
            # Gamma_b(r) = r^{1-d} int_r^inf gamma(t) t^{d-1} dt for
            # gamma = C exp(-a t^2): 1D erfc tail, 2D closed exp form
            a = self.exponentParam
            r = jnp.sqrt(r2)
            if self.dim == 1:
                from jax.scipy.special import erfc
                return C * 0.5 * jnp.sqrt(jnp.pi / a) \
                    * erfc(jnp.sqrt(a) * r)
            return C * jnp.exp(-a * r2) / (2.0 * a * r)
        if t == 'exponentialBoundary':
            lam = self.exponentParam
            r = jnp.sqrt(r2)
            if self.dim == 1:
                return C / lam * jnp.exp(-lam * r)
            return C * jnp.exp(-lam * r) * (r / lam + 1.0 / lam ** 2) / r
        if t == LOGINVERSEDISTANCE:
            return C * jnp.log(1.0 / jnp.sqrt(r2))
        if t == MONOMIAL:
            return C * r2 ** (0.5 * self.monomialPower)
        if t == POLYNOMIAL:
            a = self.exponentParam
            return C * (1.0 - r2 / a ** 2) ** 2
        raise NotImplementedError(t)

    def jaxEval(self, x, y, applyIndicator=True):
        """gamma(x, y) for x, y [..., dim] jnp arrays (device, traceable)."""
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        val = self.evalXY(x, y, r2)
        if self.phiJax is not None:
            val = val * self.phiJax(x, y)
        if applyIndicator and self.finiteHorizon:
            val = val * self.interaction.jaxIndicator(x, y, self.horizonValue ** 2)
        elif self.complement:
            val = val * self.interaction.jaxIndicator(x, y, self.horizonValue ** 2)
        return val

    def evalNumpy(self, x, y):
        import jax
        return np.asarray(self.jaxEval(jnp.asarray(x), jnp.asarray(y)))

    def __call__(self, x, y):
        """Pointwise host evaluation gamma(x, y) including the interaction
        indicator and the interface weight phi (ref Kernel.__call__).
        Pure numpy -- hot inside scipy.integrate.quad loops."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r2 = float(((x - y) ** 2).sum())
        C = self.scalingValue
        t = self.kernelType
        if t in (FRACTIONAL, MANIFOLD_FRACTIONAL):
            if r2 == 0.0:
                # integrable-singularity limit: the (u(x)-u(y)) factor in
                # every flux integrand vanishes faster for s < 1/2
                return 0.0
            val = C * r2 ** (0.5 * self.singularityValue)
            if self.temperedLambda != 0.0:
                val *= np.exp(-self.temperedLambda * np.sqrt(r2))
        elif t == INDICATOR:
            val = C
        elif t == PERIDYNAMIC:
            val = C * r2 ** -0.5
        else:
            val = float(np.asarray(self.evalNumpy(x, y)).ravel()[0])
            if self.phi is not None:
                val = val * float(self.phi.evalPairs(x, y)[0])
            return val
        if self.finiteHorizon and r2 > self.horizonValue ** 2:
            val = 0.0
        if self.complement and r2 < self.horizonValue ** 2:
            val = 0.0
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return float(val)

    # --- derived kernels ----------------------------------------------------
    def getBoundaryKernel(self):
        """Kernel for the Gauss-theorem elimination of the exterior
        (ref kernelsCy.pyx:1194,1982).  The boundary potential Gamma_b(r) =
        r^{1-d} int_r^inf gamma(t) t^{d-1} dt satisfies div(Gamma_b rhat) =
        -gamma outside the ball, so the exterior diagonal mass becomes a
        surface integral.  Closed forms exist for the smooth integrable
        kernels (gaussian/exponential); fractional kernels override."""
        if self.kernelType in (GAUSSIAN, EXPONENTIAL):
            # factor 2: the stored scaling includes the 1/2 symmetrization,
            # but the exterior diagonal mass int u v int_ext gamma_FULL needs
            # the full kernel (the fractional boundary kernel folds the same
            # factor into C/s = 2 C_half/(2s))
            k = Kernel(self.dim, self.kernelType + 'Boundary',
                       self.horizonValue, self.interaction,
                       2.0 * self.scalingValue, 0.0, boundary=True,
                       exponentParam=self.exponentParam,
                       variance=self.variance)
            return k
        raise NotImplementedError(
            'boundary kernel not defined for ' + str(self.kernelType))

    def getModifiedKernel(self, horizon=None, interaction=None):
        import copy
        k = copy.copy(self)
        if horizon is not None:
            hv = horizon.value if hasattr(horizon, 'value') else float(horizon)
            k.horizonValue = hv
            if hv == np.inf:
                k.interaction = fullSpace()
        if interaction is not None:
            k.interaction = interaction
            k.complement = interaction.complement
        return k

    def getComplementKernel(self):
        k = self.getModifiedKernel(interaction=ball2Complement())
        return k

    def _key(self):
        """Value identity: kernels with equal parameters hash equal, so jitted
        assembly kernels (which close over the kernel as a static argument)
        are compiled once per kernel VALUE, not per python object."""
        return (type(self).__name__, self.dim, self.kernelType,
                self.horizonValue, self.scalingValue, self.singularityValue,
                self.boundary, self.symmetric, self.temperedLambda,
                self.exponentParam, self.monomialPower, self.variance,
                type(self.interaction).__name__, self.complement,
                self.phi._key() if self.phi is not None else None,
                # smooth weights enter the traced eval -> part of identity
                self.phiJax.__self__._key()
                if (self.phiJax is not None
                    and hasattr(getattr(self.phiJax, '__self__', None),
                                '_key')) else id(self.phiJax)
                if self.phiJax is not None else None)

    def __eq__(self, other):
        return isinstance(other, Kernel) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f'kernel({self.kernelType}, d={self.dim}, '
                f'horizon={self.horizonValue}, C={self.scalingValue:.6g}, '
                f'sing={self.singularityValue})')


class FractionalKernel(Kernel):
    """gamma(x,y) = scaling * |x-y|^{-d-2s} (ref kernelsCy.pyx:1564).

    ``manifold=True`` gives the MANIFOLD_FRACTIONAL type (ref
    kernelsCy.pyx:50-73,1594): the fractional kernel of a (dim-1)-manifold
    embedded in R^dim, using the chordal distance |x-y| with the effective
    dimension dim-1 in singularity and normalization.  (The reference
    declares this type but every eval branch raises NotImplementedError and
    its scaling constant is undefined; here it actually assembles on
    manifold meshes, e.g. surface meshes from get_surface_mesh.)"""

    def __init__(self, dim, s, horizon=np.inf, interaction=None, scaling=None,
                 normalized=True, boundary=False, temperedLambda=0.0,
                 manifold=False):
        self.s = s
        self.manifold = manifold
        dEff = dim - 1 if manifold else dim
        self.variableOrder = not type(s) is constFractionalOrder
        sval = s.value if hasattr(s, 'value') else \
            (0.5 * (s.min + s.max) if not np.isscalar(s) else float(s))
        if scaling is None:
            if normalized:
                scaling = constantFractionalLaplacianScaling(
                    dEff, sval, float(horizon), temperedLambda)
            else:
                scaling = 0.5
        singularity = (1 if boundary else 0) - dEff - 2 * sval
        symmetric = getattr(s, 'symmetric', True)
        super().__init__(dim, MANIFOLD_FRACTIONAL if manifold else FRACTIONAL,
                         horizon, interaction, scaling,
                         singularity, boundary=boundary, symmetric=symmetric,
                         temperedLambda=temperedLambda)
        self.variable = self.variableOrder and not isinstance(
            s, variableConstFractionalOrder)
        self.min_singularity = (1 if boundary else 0) - dEff - 2 * s.max
        self.max_singularity = (1 if boundary else 0) - dEff - 2 * s.min

    @property
    def sValue(self):
        return self.s.value

    def evalXY(self, x, y, r2):
        if not self.variable:
            return self._radialJax(r2)
        from jax.scipy.special import gammaln
        sv = self.s.jaxEval(x, y)
        d = self.dim
        # C(d,s)/2 = 2^{2s} s Gamma(s+d/2) / (pi^{d/2} Gamma(1-s)) / 2
        # (ref kernelNormalization.pyx:355-360; infinite horizon)
        if self.horizonValue == np.inf:
            C = (2.0 ** (2 * sv) * sv / np.pi ** (0.5 * d) * 0.5 *
                 jnp.exp(gammaln(sv + 0.5 * d) - gammaln(1.0 - sv)))
        else:
            C = (2.0 - 2 * sv) * self.horizonValue ** (2 * sv - 2.0) * d \
                * np.exp(float(jax.scipy.special.gammaln(0.5 * d))) \
                / np.pi ** (0.5 * d) * 0.5
        if self.boundary:
            # boundary kernel: C/s * r^{1-d-2s}
            return (C / sv) * r2 ** (0.5 * (1.0 - d) - sv)
        return C * r2 ** (-0.5 * d - sv)

    def _key(self):
        base = super()._key()
        skey = self.s._key() if hasattr(self.s, '_key') else \
            ('s', getattr(self.s, 'value', None))
        return base + (self.variableOrder, self.variable) + skey

    def getBoundaryKernel(self):
        # scaling <- scaling / s ; boundary singularity = 1 - d - 2s
        # (variable-order boundary kernels evaluate C(s)/s pointwise in
        # evalXY, so the constant scaling below is only used when not
        # variable)
        scal = (self.scalingValue / self.s.value
                if hasattr(self.s, 'value') else 1.0)
        k = FractionalKernel(self.dim, self.s, horizon=self.horizonValue,
                             interaction=None, boundary=True,
                             scaling=scal,
                             temperedLambda=self.temperedLambda)
        return k

    def getModifiedKernel(self, horizon=None, interaction=None):
        if horizon is not None:
            hv = horizon.value if hasattr(horizon, 'value') else float(horizon)
            if hv == self.horizonValue:
                # unchanged horizon: keep the kernel's scaling (it may be a
                # custom constant, e.g. the unscaled S_inf of horizonCorrected)
                return super().getModifiedKernel(None, interaction)
            inter = interaction
            if hv == np.inf:
                inter = fullSpace()
            k = FractionalKernel(self.dim, self.s, horizon=hv, interaction=inter,
                                 boundary=self.boundary,
                                 temperedLambda=self.temperedLambda)
            if self.boundary:
                k.scalingValue = constantFractionalLaplacianScaling(
                    self.dim, self.s.value, hv, self.temperedLambda) / self.s.value
            return k
        return super().getModifiedKernel(horizon, interaction)


class variableHorizonFractionalKernel(FractionalKernel):
    """Fractional kernel with a position-dependent horizon delta(x)
    (ref kernelsCy.pxd:21-43 — horizon is a ``function`` — and
    kernelNormalization.pyx:656 variableFractionalLaplacianScalingWith
    DifferentHorizon: the normalization is evaluated pointwise at
    delta(x)).

    gamma(x, y) = C(d, s, delta(x)) |x-y|^{-d-2s} 1_{|x-y| <= delta(x)}.
    The x-dependent indicator makes the kernel nonsymmetric; assembly goes
    through the existing nonsymmetric panel machinery with pointwise
    evaluation (evalXY), and the horizon screen brackets pairs with
    [min delta, max delta]."""

    def __init__(self, dim, s, horizonFun, normalized=True,
                 horizonBounds=None):
        if horizonBounds is None:
            horizonBounds = (float(horizonFun.min), float(horizonFun.max))
        self.horizonFun = horizonFun
        self.horizonMin = float(horizonBounds[0])
        super().__init__(dim, s, horizon=float(horizonBounds[1]),
                         interaction=ball2(), normalized=normalized)
        assert not self.variable, \
            'variable horizon with variable order is not supported yet'
        self.variableHorizon = True
        self.symmetric = False
        self.normalized = normalized
        # pointwise normalization happens in evalXY; keep a representative
        # constant for reporting only
        if normalized:
            self.scalingValue = constantFractionalLaplacianScaling(
                dim, self.sValue, self.horizonValue)

    def jaxHorizon(self, x):
        return self.horizonFun.jaxEval(x)

    def evalXY(self, x, y, r2):
        sv = self.sValue
        d = self.dim
        delta = self.horizonFun.jaxEval(x)
        if self.normalized:
            # finite-horizon normalization at delta(x)
            # (ref kernelNormalization variableFractionalLaplacianScaling
            # WithDifferentHorizon; Gamma(d/2) constant folded on host)
            from scipy.special import gamma as _G
            C = ((2.0 - 2.0 * sv) * delta ** (2.0 * sv - 2.0) * d
                 * float(_G(0.5 * d)) / np.pi ** (0.5 * d) * 0.5)
        else:
            C = 0.5
        val = C * r2 ** (-0.5 * d - sv)
        return jnp.where(r2 <= delta * delta, val, 0.0)

    def __call__(self, x, y):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r2 = float(((x - y) ** 2).sum())
        if r2 == 0.0:
            return 0.0
        return float(np.asarray(self.evalXY(
            jnp.asarray(x[0]), jnp.asarray(y[0]), jnp.asarray(r2))))

    def _key(self):
        return super()._key() + ('variableHorizon',
                                 getattr(self.horizonFun, '_key',
                                         lambda: id(self.horizonFun))(),
                                 self.horizonMin, self.normalized)


class horizonFunction:
    """Position-dependent horizon delta(x) with host and device eval and
    explicit bounds (the screening brackets; ref kernelsCy horizon is a
    ``function`` with max_horizon)."""

    def __init__(self, fn, lo, hi, name='horizon'):
        self._fn = fn
        self.min = float(lo)
        self.max = float(hi)
        self._name = name

    def __call__(self, x):
        return np.clip(np.asarray(self._fn(np.asarray(x))),
                       self.min, self.max)

    def jaxEval(self, x):
        return jnp.clip(self._fn(x), self.min, self.max)

    def _key(self):
        return ('horizonFunction', self._name, self.min, self.max)


class DerivativeFractionalKernel(FractionalKernel):
    """d^k/ds^k of the constant-order fractional kernel (ref kernelsCy.pyx
    FractionalKernel derivative=1/2 :1576-1598,1911-1944 with
    constantFractionalLaplacianScalingDerivative).

    Instead of hand-derived digamma formulas, the derivative is
    jax-autodiffed from the closed-form normalized radial profile
    g(s, r^2) = C(d, s, delta) * r^{2*(singularity/2)}, so value and any
    derivative order share one code path.  valueSize = 1 (constant s has one
    parameter; ref valueSize = s.numParameters)."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None,
                 normalized=True, boundary=False, temperedLambda=0.0,
                 derivative=1):
        super().__init__(dim, s, horizon=horizon, interaction=interaction,
                         normalized=normalized, boundary=boundary,
                         temperedLambda=temperedLambda)
        assert not self.variable, \
            'derivative kernels need constant fractional order'
        self.derivative = int(derivative)
        self.normalized = normalized
        self.valueSize = 1

    def _gOfS(self, sv, r2):
        """Closed-form normalized profile as a differentiable function of
        s (mirrors constantFractionalLaplacianScaling; jax ops only)."""
        from jax.scipy.special import gammaln
        d = self.dim
        hv = self.horizonValue
        if self.normalized:
            if hv == np.inf:
                C = (2.0 ** (2.0 * sv) * sv / np.pi ** (0.5 * d) * 0.5
                     * jnp.exp(gammaln(sv + 0.5 * d) - gammaln(1.0 - sv)))
            else:
                C = ((2.0 - 2.0 * sv) * hv ** (2.0 * sv - 2.0) * d
                     * np.exp(float(_gammalnHost(0.5 * d)))
                     / np.pi ** (0.5 * d) * 0.5)
        else:
            C = 0.5 * jnp.ones_like(sv) if hasattr(sv, 'shape') else 0.5
        if self.boundary:
            return (C / sv) * r2 ** (0.5 * (1.0 - self.dim) - sv)
        val = C * r2 ** (-0.5 * self.dim - sv)
        if self.temperedLambda != 0.0:
            val = val * jnp.exp(-self.temperedLambda * jnp.sqrt(r2))
        return val

    def _radialJax(self, r2):
        sv = jnp.asarray(float(self.sValue), dtype=r2.dtype)
        f = lambda s_: self._gOfS(s_, r2)           # noqa: E731
        for _ in range(self.derivative):
            f = (lambda g: lambda s_: jax.jvp(g, (s_,),
                                              (jnp.ones_like(s_),))[1])(f)
        return f(sv)

    def __call__(self, x, y):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r2 = float(((x - y) ** 2).sum())
        if r2 == 0.0:
            return 0.0
        if self.finiteHorizon and r2 > self.horizonValue ** 2:
            return 0.0
        if self.complement and r2 < self.horizonValue ** 2:
            return 0.0
        val = float(np.asarray(self._radialJax(jnp.asarray([r2])))[0])
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return val

    def getBoundaryKernel(self):
        """d/ds of the boundary (Gauss-theorem) kernel: the s-derivative is
        taken of C(s)/s * r^{1-d-2s} as a whole."""
        return DerivativeFractionalKernel(
            self.dim, self.s, horizon=self.horizonValue,
            normalized=self.normalized, boundary=True,
            temperedLambda=self.temperedLambda, derivative=self.derivative)

    def _key(self):
        return super()._key() + ('derivative', self.derivative,
                                 self.normalized)


class VectorFractionalKernel(FractionalKernel):
    """Vector-valued derivative kernel for a MULTI-PARAMETER fractional
    order (ref kernelsCy.pyx:1580-1584: derivative=1 -> valueSize =
    s.numParameters, derivative=2 -> numParameters**2; eval :1911-1944
    multiplies d^k gamma/ds^k with s.evalGrad/outer product).

    Component q is  d^k gamma/ds^k (x,y; s(x,y)) * ds/dp_q(x,y)
    — ALL components come from ONE scalar kernel evaluation per quadrature
    point (jvp-autodiffed through the closed-form normalized profile) times
    the order's parameter gradient, so vector assembly is a single pass, not
    valueSize scalar re-assemblies."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None,
                 normalized=True, boundary=False, temperedLambda=0.0,
                 derivative=1):
        super().__init__(dim, s, horizon=horizon, interaction=interaction,
                         normalized=normalized, boundary=boundary,
                         temperedLambda=temperedLambda)
        self.derivative = int(derivative)
        self.normalized = normalized
        P = int(s.numParameters)
        self.valueSize = P if self.derivative == 1 else P * P
        # gradient factors are generally unsymmetric in (x, y)
        self.symmetric = False
        self.variable = True

    def _prefactor(self, sv):
        """C(s) (or C(s)/s for the boundary kernel) as a differentiable
        function of the order value."""
        from jax.scipy.special import gammaln
        d = self.dim
        if self.normalized:
            if self.horizonValue == np.inf:
                C = (2.0 ** (2 * sv) * sv / np.pi ** (0.5 * d) * 0.5 *
                     jnp.exp(gammaln(sv + 0.5 * d) - gammaln(1.0 - sv)))
            else:
                C = ((2.0 - 2.0 * sv)
                     * self.horizonValue ** (2 * sv - 2.0) * d
                     * np.exp(float(_gammalnHost(0.5 * d)))
                     / np.pi ** (0.5 * d) * 0.5)
        else:
            C = 0.5 * jnp.ones_like(sv)
        return C / sv if self.boundary else C

    def _rpower(self, sv, r2):
        d = self.dim
        if self.boundary:
            return r2 ** (0.5 * (1.0 - d) - sv)
        return r2 ** (-0.5 * d - sv)

    def _tempered(self, r2):
        if self.temperedLambda != 0.0:
            return jnp.exp(-self.temperedLambda * jnp.sqrt(r2))
        return 1.0

    def _profile(self, sv, r2):
        """Closed-form normalized gamma as a differentiable function of the
        order value (same expression as FractionalKernel.evalXY)."""
        return self._prefactor(sv) * self._rpower(sv, r2) \
            * self._tempered(r2)

    def evalComponentsJax(self, x, y, r2):
        """All valueSize components at once -> [..., valueSize]."""
        sv = self.s.jaxEval(x, y).astype(r2.dtype)
        sv = jnp.broadcast_to(sv, r2.shape)
        ones = jnp.ones_like(sv)
        f = lambda s_: self._profile(s_, r2)          # noqa: E731
        grad = self.s.evalGradJax(x, y).astype(r2.dtype)
        grad = jnp.broadcast_to(grad, r2.shape + grad.shape[-1:])
        if self.derivative == 1:
            d1 = jax.jvp(f, (sv,), (ones,))[1]
            return d1[..., None] * grad
        d2 = jax.jvp(lambda s_: jax.jvp(f, (s_,), (ones,))[1],
                     (sv,), (ones,))[1]
        outer = grad[..., :, None] * grad[..., None, :]
        return (d2[..., None, None] * outer).reshape(
            r2.shape + (self.valueSize,))

    def evalLogCoeffsJax(self, x, y, r2):
        """(b, c) [..., valueSize]: coefficients of ln|x-y| and ln^2|x-y| in
        the derivative integrand (gamma = C(s) r^{alpha(s)}, alpha' = -2:
        d1 -> b = -2 gamma_plain, c = 0;
        d2 -> b = -4 C'(s) r^alpha, c = 4 gamma_plain).
        The singular rules integrate these factors exactly through their
        log-correction weights (quad_singular.PanelRule.cw1/cw2)."""
        sv = self.s.jaxEval(x, y).astype(r2.dtype)
        sv = jnp.broadcast_to(sv, r2.shape)
        grad = self.s.evalGradJax(x, y).astype(r2.dtype)
        grad = jnp.broadcast_to(grad, r2.shape + grad.shape[-1:])
        rad = self._rpower(sv, r2) * self._tempered(r2)
        plain = self._prefactor(sv) * rad
        if self.derivative == 1:
            b = -2.0 * plain[..., None] * grad
            return b, jnp.zeros_like(b)
        dC = jax.jvp(self._prefactor, (sv,), (jnp.ones_like(sv),))[1]
        outer = (grad[..., :, None] * grad[..., None, :]).reshape(
            r2.shape + (self.valueSize,))
        b = (-4.0 * dC * rad)[..., None] * outer
        c = (4.0 * plain)[..., None] * outer
        return b, c

    def evalXY(self, x, y, r2):
        raise TypeError('vector-valued kernel: use evalComponentsJax '
                        '(scalar assembly paths must not see valueSize>1)')

    def componentKernels(self):
        """Scalar kernels for each component (ref: per-component views of
        the vector operator); used by component-wise H2 and parity tests."""
        return [_ComponentFractionalKernel(self, q)
                for q in range(self.valueSize)]

    def getBoundaryKernel(self):
        return VectorFractionalKernel(
            self.dim, self.s, horizon=self.horizonValue,
            normalized=self.normalized, boundary=True,
            temperedLambda=self.temperedLambda, derivative=self.derivative)

    def _key(self):
        return super()._key() + ('vectorDerivative', self.derivative,
                                 self.normalized)


class _ComponentFractionalKernel(FractionalKernel):
    """Scalar view of one component of a VectorFractionalKernel (goes
    through the ordinary scalar panel engine)."""

    def __init__(self, parent, q):
        super().__init__(parent.dim, parent.s, horizon=parent.horizonValue,
                         normalized=parent.normalized,
                         boundary=parent.boundary,
                         temperedLambda=parent.temperedLambda)
        self.parent = parent
        self.q = int(q)
        self.symmetric = False
        self.variable = True
        # same quadrature-order bump as the vector kernel (the assembly
        # engine raises the rule order for the log factor of s-derivatives)
        self.derivative = parent.derivative

    def evalXY(self, x, y, r2):
        return self.parent.evalComponentsJax(x, y, r2)[..., self.q]

    def evalLogCoeffsJax(self, x, y, r2):
        b, c = self.parent.evalLogCoeffsJax(x, y, r2)
        return b[..., self.q], c[..., self.q]

    def getBoundaryKernel(self):
        return _ComponentFractionalKernel(self.parent.getBoundaryKernel(),
                                          self.q)

    def _key(self):
        return super()._key() + ('component', self.q,
                                 self.parent.derivative,
                                 self.parent.normalized)


def _gammalnHost(x):
    from scipy.special import gammaln as _g
    return _g(x)


def getFractionalKernel(dim, s, horizon=np.inf, interaction=None, scaling=None,
                        normalized=True, piecewise=True, phi=None,
                        boundary=False, derivative=0, manifold=False,
                        **kwargs):
    from .operator_interpolation import admissibleSet, RangedFractionalKernel
    if isinstance(s, admissibleSet):
        return RangedFractionalKernel(dim, s, horizon=horizon,
                                      normalized=normalized, **kwargs)
    if not isinstance(s, fractionalOrderBase):
        s = constFractionalOrder(s)
    if isinstance(horizon, horizonFunction) or (
            not np.isscalar(horizon) and not hasattr(horizon, 'value')
            and callable(horizon)):
        # variable (function-valued) horizon (ref kernelsCy.pxd horizon is
        # a function); kernelNormalization "withDifferentHorizon" scaling
        return variableHorizonFractionalKernel(dim, s, horizon,
                                               normalized=normalized)
    hv = horizon.value if hasattr(horizon, 'value') else float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if derivative:
        if getattr(s, 'numParameters', 1) > 1:
            # multi-parameter order -> vector-valued kernel
            # (ref kernelsCy.pyx:1583 valueSize = s.numParameters)
            return VectorFractionalKernel(
                dim, s, hv, interaction, normalized=normalized,
                boundary=boundary, derivative=derivative)
        k = DerivativeFractionalKernel(
            dim, s, hv, interaction, normalized=normalized,
            boundary=boundary, derivative=derivative)
        if phi is not None:
            if getattr(phi, 'smooth', False):
                k.phiJax = phi.jaxEval
            else:
                k.phi = phi
        return k
    k = FractionalKernel(dim, s, hv, interaction, scaling,
                         normalized=normalized, boundary=boundary,
                         manifold=manifold)
    if phi is not None:
        if getattr(phi, 'smooth', False):
            k.phiJax = phi.jaxEval
        else:
            k.phi = phi
    return k


def getIntegrableKernel(dim, kernel, horizon, interaction=None, scaling=None,
                        normalized=True, phi=None, boundary=False,
                        gaussian_variance=1.0, exponentialRate=1.0, **kwargs):
    hv = horizon.value if hasattr(horizon, 'value') else float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if scaling is None:
        if normalized:
            scaling = constantIntegrableScaling(
                kernel, interaction, dim, hv,
                gaussian_variance=gaussian_variance,
                exponentialRate=exponentialRate)
        else:
            scaling = 0.5
    sing = {INDICATOR: 0.0, PERIDYNAMIC: -1.0, GAUSSIAN: 0.0,
            EXPONENTIAL: 0.0, POLYNOMIAL: 0.0, LOGINVERSEDISTANCE: 0.0}[kernel]
    exponentParam = 0.0
    if kernel == GAUSSIAN:
        exponentParam = (1.0 / (hv / 3.0) ** 2 if hv < np.inf
                         else 0.5 / gaussian_variance ** dim)
    elif kernel == EXPONENTIAL:
        exponentParam = exponentialRate
    k = Kernel(dim, kernel, hv, interaction, scaling, sing,
               boundary=boundary, exponentParam=exponentParam,
               variance=gaussian_variance)
    if phi is not None:
        if getattr(phi, 'smooth', False):
            k.phiJax = phi.jaxEval
        else:
            k.phi = phi
    return k


class ComplexKernel(Kernel):
    """Complex-valued Greens-function kernels (ref kernelsCy.pyx:1224-1322).

    greens2D: gamma(x,y) = C * i*H0^(1)(lam*|x-y|)  with lam =
        -Im(greensLambda) (ref kernelsCy.pyx:1246-1250,519-526); declared
        singularity 0 (log-integrable), matching the reference.
    greens3D: gamma(x,y) = C * exp(-greensLambda*|x-y|) / |x-y| with complex
        greensLambda (ref kernelsCy.pyx:1251-1256,529-537); singularity -1.

    Assembled through the same double-difference panel machinery as the real
    kernels (the reference templates nonlocalAssembly over {SCALAR}); the
    builder allocates complex accumulators when ``kernel.isComplex``.
    """
    isComplex = True

    def __init__(self, dim, kernelType, horizon=np.inf, interaction=None,
                 scaling=1.0, greensLambda=1.0j, phi=None):
        if kernelType == GREENS_2D:
            assert dim == 2, 'greens2D kernel needs dim=2'
            sing = 0.0
        elif kernelType == GREENS_3D:
            assert dim == 3, 'greens3D kernel needs dim=3'
            sing = -1.0
        else:
            raise NotImplementedError(kernelType)
        hv = horizon.value if hasattr(horizon, 'value') else float(horizon)
        if interaction is None:
            interaction = fullSpace() if hv == np.inf else ball2()
        sv = scaling.value if hasattr(scaling, 'value') else float(scaling)
        super().__init__(dim, kernelType, hv, interaction, sv, sing,
                         symmetric=True)
        self.greensLambda = complex(greensLambda)
        if phi is not None:
            if getattr(phi, 'smooth', False):
                self.phiJax = phi.jaxEval
            else:
                self.phi = phi

    def _radialJax(self, r2):
        C = self.scalingValue
        r = jnp.sqrt(r2)
        if self.kernelType == GREENS_2D:
            # i*H0^(1)(lam r) = i*J0(lam r) - Y0(lam r)
            lam = -self.greensLambda.imag
            j0, y0 = _bessel_j0y0(lam * r)
            return C * (-y0 + 1j * j0)
        lam = self.greensLambda
        return C * jnp.exp(-lam.real * r) \
            * (jnp.cos(lam.imag * r) - 1j * jnp.sin(lam.imag * r)) / r

    def __call__(self, x, y):
        """Host evaluation with scipy's exact Bessel functions."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r = float(np.sqrt(((x - y) ** 2).sum()))
        C = self.scalingValue
        if self.finiteHorizon and r > self.horizonValue:
            return 0.0j
        if self.kernelType == GREENS_2D:
            from scipy.special import hankel1
            val = C * 1j * hankel1(0.0, -self.greensLambda.imag * r)
        else:
            val = C * np.exp(-self.greensLambda * r) / r
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return complex(val)

    def getBoundaryKernel(self):
        raise NotImplementedError(
            'boundary kernel not defined for complex kernels '
            '(ref kernelsCy.pyx:1307,1321 raises too)')

    def _key(self):
        return super()._key() + (self.greensLambda,)


def getComplexKernel(dim, kernel=GREENS_2D, greensLambda=1.0j, horizon=np.inf,
                     interaction=None, scaling=1.0, phi=None, **kwargs):
    """Factory for the complex Greens kernels (the reference constructs
    ComplexKernel directly; DoFMaps.pyx:836-880 dispatches on its type)."""
    return ComplexKernel(dim, kernel, horizon=horizon, interaction=interaction,
                         scaling=scaling, greensLambda=greensLambda, phi=phi)


def getKernel(dim, kernel=FRACTIONAL, **kwargs):
    if kernel == FRACTIONAL:
        return getFractionalKernel(dim, **kwargs)
    if kernel in (GREENS_2D, GREENS_3D):
        return getComplexKernel(dim, kernel=kernel, **kwargs)
    return getIntegrableKernel(dim, kernel=kernel, **kwargs)


kernelFactory = factory()
kernelFactory.register('fractional', getFractionalKernel)
kernelFactory.register('greens2D', lambda dim, **kw: getComplexKernel(dim, kernel=GREENS_2D, **kw))
kernelFactory.register('greens3D', lambda dim, **kw: getComplexKernel(dim, kernel=GREENS_3D, **kw))
for _kt in (INDICATOR, PERIDYNAMIC, GAUSSIAN, EXPONENTIAL, POLYNOMIAL,
            LOGINVERSEDISTANCE):
    kernelFactory.register(
        _kt, (lambda kt: lambda dim, **kw: getIntegrableKernel(dim, kernel=kt, **kw))(_kt),
        aliases=['inverseDistance'] if _kt == PERIDYNAMIC else
                ['constant'] if _kt == INDICATOR else None)
