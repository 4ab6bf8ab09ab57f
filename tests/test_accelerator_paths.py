"""The assembly branches a GPU takes (_onAccelerator: device grid for dense,
device dense and CSR accumulators, the harvest compile pass) in f64 on the
CPU, against the host path."""
import numpy as np
import jax.numpy as jnp
import pytest

import pynucleus_tpu.nl.assembly as assembly
from pynucleus_tpu.fem import circle, simpleInterval, P1_DoFMap
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.kernels import temperedTwoPoint
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def _dm(dim, noRef):
    m = simpleInterval(-1, 1) if dim == 1 else circle(n=8)
    for _ in range(noRef):
        m = m.refine()
    return P1_DoFMap(m)


def _dense(dm, kernel, accelerator, monkeypatch, params=None,
           zeroExterior=True):
    monkeypatch.setattr(assembly, '_onAccelerator', lambda: accelerator)
    A = nonlocalBuilder(dm, kernel, params=params,
                        zeroExterior=zeroExterior).getDense()
    return np.asarray(A.toarray())


@pytest.mark.parametrize('dim,noRef', [(1, 5), (2, 2)], ids=['1d', '2d'])
def test_dense_grid_matches_host(dim, noRef, monkeypatch):
    """Infinite horizon: the device grid (denseGrid=True on the CPU) agrees
    with the per-pair host path to quadrature accuracy."""
    dm = _dm(dim, noRef)
    k = getFractionalKernel(dim, 0.75)
    host = _dense(dm, k, False, monkeypatch)
    dev = _dense(dm, k, True, monkeypatch)
    grid = _dense(dm, k, False, monkeypatch, params={'denseGrid': True})
    assert np.array_equal(dev, grid)
    err = np.linalg.norm(dev - host) / np.linalg.norm(host)
    assert err < 1e-5, err


def _finiteHorizon(dim):
    return getFractionalKernel(dim, 0.75, horizon=0.3)


def _tempered(dim):
    return getFractionalKernel(dim, 0.4, phi=temperedTwoPoint(2.0, dim=dim))


@pytest.mark.parametrize('kernel,dim,noRef', [
    (_finiteHorizon, 1, 5), (_finiteHorizon, 2, 2), (_tempered, 1, 4)],
    ids=['horizon-1d', 'horizon-2d', 'tempered-1d'])
def test_device_dense_accumulator_matches_host(kernel, dim, noRef,
                                               monkeypatch):
    """Kernels the grid does not take (finite horizon: host-computed
    cut-pair contributions; per-quadrature-point two-point weights): the
    device dense accumulator equals the host one.  (No zeroExterior term:
    on the device it comes from the boundary grid, whose quadrature
    differs from the host's.)"""
    dm = _dm(dim, noRef)
    k = kernel(dim)
    host = _dense(dm, k, False, monkeypatch, zeroExterior=False)
    dev = _dense(dm, k, True, monkeypatch, zeroExterior=False)
    err = np.linalg.norm(dev - host) / np.linalg.norm(host)
    assert err < 1e-12, err


@pytest.mark.parametrize('dim,noRef', [(1, 6), (2, 2)], ids=['1d', '2d'])
def test_device_h2_matches_host(dim, noRef, monkeypatch):
    """H2 with the device CSR near field and the harvest compile pass."""
    dm = _dm(dim, noRef)
    k = getFractionalKernel(dim, 0.75)
    Hhost = nonlocalBuilder(dm, k).getH2()
    monkeypatch.setattr(assembly, '_onAccelerator', lambda: True)
    monkeypatch.setattr(assembly, '_HARVESTED', set())
    assert assembly._parallelCompileWorthIt()
    H = nonlocalBuilder(dm, k).getH2()
    x = jnp.asarray(np.random.default_rng(0).normal(size=dm.num_dofs))
    ref = Hhost.matvec(x)
    e = float(jnp.linalg.norm(H.matvec(x) - ref) / jnp.linalg.norm(ref))
    assert e < 1e-10, e
