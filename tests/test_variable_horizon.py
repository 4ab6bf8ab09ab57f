"""Variable (function-valued) horizons (ref kernelsCy.pxd:21-43 horizon is a
``function``; kernelNormalization.pyx:656 pointwise delta(x) scaling)."""
import numpy as np
import jax.numpy as jnp

from pynucleus_tpu.fem import simpleInterval, P1_DoFMap, assembleStiffness
from pynucleus_tpu.nl import getFractionalKernel
from pynucleus_tpu.nl.kernels import horizonFunction
from pynucleus_tpu.nl.assembly import nonlocalBuilder


def _dm(noRef=6):
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    return P1_DoFMap(m)


def test_constant_horizon_via_function():
    """delta(x) = const through the variable-horizon path agrees with the
    constant-horizon kernel (the cut band uses pointwise-indicator
    quadrature instead of exact 1D clipping, hence the tolerance)."""
    dm = _dm(6)
    delta = 0.2
    kConst = getFractionalKernel(1, 0.25, horizon=delta)
    hf = horizonFunction(lambda x: delta + 0.0 * x[..., 0], delta, delta)
    kVar = getFractionalKernel(1, 0.25, horizon=hf)
    assert kVar.variableHorizon and not kVar.symmetric
    A1 = np.asarray(nonlocalBuilder(dm, kConst).getSparse().toarray())
    A2 = np.asarray(nonlocalBuilder(dm, kVar).getSparse().toarray())
    rel = np.abs(A1 - A2).max() / np.abs(A1).max()
    assert rel < 2e-2, rel
    # matvec-level agreement is tighter (cut-pair errors average out)
    x = np.sin(np.pi * np.linspace(-1, 1, dm.num_dofs))
    mv = np.linalg.norm((A1 - A2) @ x) / np.linalg.norm(A1 @ x)
    assert mv < 5e-3, mv


def test_variable_horizon_patch():
    """Normalized variable-horizon kernel behaves like the Laplacian on a
    smooth function in the interior (the normalization is pointwise in
    delta(x), so the local limit holds despite the varying horizon)."""
    dm = _dm(7)
    hf = horizonFunction(lambda x: 0.1 + 0.05 * (x[..., 0] + 1.0),
                         0.1, 0.2)
    kVar = getFractionalKernel(1, 0.25, horizon=hf)
    A = nonlocalBuilder(dm, kVar).getSparse()
    K = assembleStiffness(dm)
    xs = np.asarray(dm.getDoFCoordinates())[:, 0]
    u = jnp.asarray(xs ** 2)
    yA = np.asarray(A @ u)
    yK = np.asarray(K @ u)
    # compare away from the boundary layer of width max(delta)
    sel = np.abs(xs) < 0.7
    rel = np.abs(yA[sel] - yK[sel]).max() / np.abs(yK[sel]).max()
    assert rel < 0.1, rel


def test_variable_horizon_dense_matches_sparse():
    dm = _dm(5)
    hf = horizonFunction(lambda x: 0.15 + 0.1 * (x[..., 0] + 1.0),
                         0.15, 0.35)
    kVar = getFractionalKernel(1, 0.4, horizon=hf)
    Ad = np.asarray(nonlocalBuilder(dm, kVar).getDense().toarray())
    As = np.asarray(nonlocalBuilder(dm, kVar).getSparse().toarray())
    rel = np.abs(Ad - As).max() / np.abs(Ad).max()
    assert rel < 1e-12, rel
