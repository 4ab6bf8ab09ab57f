"""Distributed H2 (S4) and distributed CSR: sharded-vs-serial parity on the
virtual 8-device mesh (the reference's own validation strategy for its
distributed operators, drivers/testDistOp.py), plus a scale test where
densification is impossible (>=100k dofs, per-device memory
O(N/nd log N))."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pynucleus_tpu.fem import simpleInterval, P1_DoFMap, assembleRHS, constant
from pynucleus_tpu.fem.mesh_zoo import uniformSquare
from pynucleus_tpu.nl import getFractionalKernel, getIntegrableKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder
from pynucleus_tpu.parallel import (makeDeviceMesh, DistributedH2Matrix,
                                    DistributedCSROperator)
from pynucleus_tpu.base.solvers import _cg_core
from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator


def _interval(noRef):
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    return P1_DoFMap(m)


def _probe(n):
    return jnp.asarray(np.sin(np.pi * np.linspace(-1.0, 1.0, n)))


def test_dist_h2_matvec_parity_1d():
    dm = _interval(8)
    kernel = getFractionalKernel(1, 0.5)
    H = nonlocalBuilder(dm, kernel).getH2()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedH2Matrix(H, mesh)
    x = _probe(dm.num_dofs)
    err = float(jnp.linalg.norm(H.matvec(x) - Ad.matvec(x)))
    assert err < 1e-11, err
    # diagonal agrees with the H2 (= near-field) diagonal
    derr = float(jnp.linalg.norm(Ad.diagonal - H.diagonal))
    assert derr < 1e-12, derr


def test_dist_h2_bcast_mode():
    dm = _interval(7)
    kernel = getFractionalKernel(1, 0.75)
    H = nonlocalBuilder(dm, kernel).getH2()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedH2Matrix(H, mesh, bcast=True)
    x = _probe(dm.num_dofs)
    err = float(jnp.linalg.norm(H.matvec(x) - Ad.matvec(x)))
    assert err < 1e-11, err


def test_dist_h2_matvec_parity_2d():
    m = uniformSquare(9)
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(2, 0.5)
    H = nonlocalBuilder(dm, kernel).getH2()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedH2Matrix(H, mesh)
    x = jnp.asarray(np.sin(
        np.pi * np.asarray(dm.getDoFCoordinates())[:, 0]))
    ref = H.matvec(x)
    err = float(jnp.linalg.norm(ref - Ad.matvec(x)))
    assert err < 1e-10 * max(float(jnp.linalg.norm(ref)), 1.0), err


def test_dist_csr_finite_horizon():
    dm = _interval(8)
    kernel = getIntegrableKernel(1, 'indicator', 0.2)
    A = nonlocalBuilder(dm, kernel).getSparse()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedCSROperator(A, mesh)
    x = _probe(dm.num_dofs)
    err = float(jnp.linalg.norm(A.matvec(x) - Ad.matvec(x)))
    assert err < 1e-12, err
    derr = float(jnp.linalg.norm(Ad.diagonal - A.diagonal))
    assert derr < 1e-12, derr


def test_dist_h2_cg_solve():
    dm = _interval(8)
    kernel = getFractionalKernel(1, 0.75)
    H = nonlocalBuilder(dm, kernel).getH2()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedH2Matrix(H, mesh)
    b = jnp.asarray(assembleRHS(dm, constant(1.0)).data)
    M = Diagonal_LinearOperator(1.0 / Ad.diagonal)
    u, iters, _ = _cg_core(Ad, M, b, jnp.zeros_like(b), 1e-10, 300,
                           use_prec=True)
    uS, itS, _ = _cg_core(H, Diagonal_LinearOperator(1.0 / H.diagonal),
                          b, jnp.zeros_like(b), 1e-10, 300, use_prec=True)
    # sharded and serial CG agree (solution and iteration counts)
    assert int(iters) == int(itS)
    assert float(jnp.linalg.norm(u - uS)) < 1e-8


@pytest.mark.slow
def test_dist_h2_large_scale():
    """>=100k dofs: dense is impossible (137 GB); the distributed H2 keeps
    per-device memory O(N/nd log N) and matches the serial H2 matvec."""
    dm = _interval(17)
    N = dm.num_dofs
    assert N >= 100_000
    kernel = getFractionalKernel(1, 0.75)
    H = nonlocalBuilder(dm, kernel).getH2()
    mesh = makeDeviceMesh(min(8, len(jax.devices())))
    Ad = DistributedH2Matrix(H, mesh)
    x = _probe(N)
    ref = H.matvec(x)
    err = float(jnp.linalg.norm(ref - Ad.matvec(x)))
    assert err < 1e-10 * float(jnp.linalg.norm(ref)), err
    # per-device memory bound: far below anything dense-like
    nd = mesh.devices.size
    totalBytes = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                     for v in Ad._sh.values())
    perDevice = totalBytes / nd
    assert perDevice < 100e6, perDevice          # ~49 MB measured
    assert perDevice < 8 * N * np.log2(N) * 16   # O(N/nd log N) with slack
