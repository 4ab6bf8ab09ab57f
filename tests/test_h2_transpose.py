"""H2 transpose matvec for nonsymmetric kernels (ref clusterMethodCy
transpose matvec variants :2269-2348)."""
import numpy as np
import jax.numpy as jnp

from pynucleus_tpu.fem import simpleInterval, P1_DoFMap
from pynucleus_tpu.nl import kernels
from pynucleus_tpu.nl.assembly import nonlocalBuilder
from pynucleus_tpu.nl.problems import fractionalOrderFactory


def test_h2_transpose_nonsym():
    m = simpleInterval(-1.0, 1.0)
    for _ in range(6):
        m = m.refine()
    dm = P1_DoFMap(m)
    s = fractionalOrderFactory('leftRight', 0.25, 0.75)
    k = kernels.getFractionalKernel(1, s)
    assert not k.symmetric
    H = nonlocalBuilder(dm, k).getH2()
    A = nonlocalBuilder(dm, k).getDense()
    x = jnp.asarray(np.sin(np.linspace(-1.0, 1.0, dm.num_dofs)))
    eFwd = float(jnp.linalg.norm(H.matvec(x) - A.matvec(x)))
    AT = jnp.asarray(np.asarray(A.data).T)
    eT = float(jnp.linalg.norm(H.T.matvec(x) - AT @ x))
    # the transpose carries the same H2 approximation error as the forward
    assert eT < max(1e-5, 3.0 * eFwd), (eFwd, eT)
    # double transpose returns the original operator
    assert H.T.T is H
