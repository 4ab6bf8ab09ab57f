"""Multi-chip distribution over a jax.sharding.Mesh.

Counterpart of the reference's MPI strategies (SURVEY.md section
2.9):
  S1 row-sliced dense assembly  -> shard_map over the cell-pair grid + psum
     (ref nonlocalAssembly_{SCALAR}.pxi:1280-1285,1449: per-rank outer-cell
     slice + Allreduce)
  S3 distributed operator, global vectors -> row-sharded operator matvec;
     XLA inserts the all-gather/psum that replace Bcast/Allreduce
     (ref clusterMethodCy.pyx:3127-3155 DistributedH2Matrix_globalData)
  distributed Krylov inner products -> jnp.vdot on sharded arrays == the
     ip_distributed_nonoverlapping Allreduce (ref base/ip_norm.pxd:48)
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ..config import REAL, INDEX, toDevice as _jd

__all__ = ['makeDeviceMesh', 'shardedDenseAssembly', 'rowShardedOperator',
           'distributedSolveStep', 'DistributedRowBlockOperator',
           'DistributedHaloOperator', 'dryrunShardedDense',
           'dryrunShardedGMG']


def makeDeviceMesh(n_devices=None, axis='d'):
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis,))


def shardedDenseAssembly(dm, kernel, mesh, axis='d'):
    """S1: shard the distant-pair grid over devices, each assembles a partial
    dense matrix, psum combines (the device analogue of the reference's
    row-sliced assembly + MPI Allreduce).

    The singular (touching) panels are cheap and assembled host-side once;
    only the O(C^2) distant work is sharded."""
    from ..nl.assembly import (nonlocalBuilder, DenseAccumulator,
                               _psi_prod, _radial_eval)
    from ..nl.panels import classifyPairsDense
    from ..nl.quad_singular import distantRule

    nd = mesh.devices.size
    builder = nonlocalBuilder(dm, kernel)
    meshM = dm.mesh
    N = dm.num_dofs
    info = builder._makeRules(classifyPairsDense(dm, kernel))

    # near/singular part on host (small)
    acc = DenseAccumulator(N)
    infoNear = dict(info)
    infoNear['distant'] = (np.zeros(0, dtype=np.int64),
                           np.zeros(0, dtype=np.int64),
                           np.zeros(0, dtype=np.int64))
    builder._runPairBuckets(acc, infoNear)
    if builder.zeroExterior:
        builder._addZeroExterior(acc)
    Anear = acc.A[:N, :N]

    # sharded distant part: one representative order bucket machinery per
    # order, pairs split over the device mesh
    di, dj, orders = info['distant']
    vertices = jnp.asarray(meshM.vertices)
    cellsArr = _jd(meshM.cells, INDEX)
    dofsArr = _jd(dm.dofs, INDEX)
    volsArr = jnp.asarray(meshM.simplexVolumes())

    A = jnp.zeros((N + 1, N + 1), dtype=REAL)

    for order in np.unique(orders):
        sel = orders == order
        ii, jj = di[sel], dj[sel]
        rule = distantRule(int(order), meshM.manifold_dim)
        PSI = rule.buildPSI(dm, nSharedVertices=0)
        PSIP = jnp.asarray(_psi_prod(PSI))
        bary_x = jnp.asarray(rule.bary_x)
        bary_y = jnp.asarray(rule.bary_y)
        w = jnp.asarray(rule.w)
        nPSI = PSI.shape[0]
        # pad pairs to a multiple of the device count
        Ptot = len(ii)
        per = -(-Ptot // nd)
        pad = per * nd - Ptot
        iiP = np.concatenate([ii, np.zeros(pad, dtype=np.int64)])
        jjP = np.concatenate([jj, np.zeros(pad, dtype=np.int64)])
        fac = np.concatenate([np.full(Ptot, 2.0), np.zeros(pad)])

        def assembleShard(iiL, jjL, facL):
            v1 = vertices[cellsArr[iiL]]
            v2 = vertices[cellsArr[jjL]]
            x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
            y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
            r2 = jnp.sum((x - y) ** 2, axis=-1)
            g = _radial_eval(kernel, r2)
            if kernel.finiteHorizon:
                g = g * kernel.interaction.jaxIndicator(
                    x, y, kernel.horizonValue ** 2)
            vols = volsArr[iiL] * volsArr[jjL] * facL
            t = (g * w[None, :]) * vols[:, None]
            M = t @ PSIP
            dr = jnp.concatenate([dofsArr[iiL], dofsArr[jjL]], axis=1)
            rows = jnp.where(dr >= 0, dr, N)
            Pl = rows.shape[0]
            rb = jnp.broadcast_to(rows[:, :, None], (Pl, nPSI, nPSI)).reshape(-1)
            cb = jnp.broadcast_to(rows[:, None, :], (Pl, nPSI, nPSI)).reshape(-1)
            Apart = jnp.zeros((N + 1, N + 1), dtype=REAL)
            Apart = Apart.at[rb, cb].add(M.reshape(-1))
            return jax.lax.psum(Apart, axis)

        shardFn = jax.shard_map(
            assembleShard, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P())
        A = A + jax.jit(shardFn)(_jd(iiP, INDEX),
                                 _jd(jjP, INDEX),
                                 jnp.asarray(fac))

    from ..base.linear_operators import Dense_LinearOperator
    total = A[:N, :N] + jnp.asarray(Anear)
    return Dense_LinearOperator(total)


def rowShardedOperator(A, mesh, axis='d'):
    """Place a dense operator row-sharded on the device mesh (S3 layout:
    each device owns a row block; matvec leaves y sharded, inner products
    trigger psum)."""
    from ..base.linear_operators import Dense_LinearOperator
    data = A.data if hasattr(A, 'data') else jnp.asarray(A)
    N = data.shape[0]
    nd = mesh.devices.size
    pad = (-N) % nd
    if pad:
        # pad to a square multiple of the device count; identity on the pad
        # block keeps the operator invertible
        data = jnp.pad(data, ((0, pad), (0, pad)))
        data = data.at[jnp.arange(N, N + pad), jnp.arange(N, N + pad)].set(1.0)
    sharding = NamedSharding(mesh, P(axis, None))
    dataSharded = jax.device_put(data, sharding)
    return Dense_LinearOperator(dataSharded), pad


def distributedSolveStep(mesh, A_sharded, b, pad, axis='d', tol=1e-8,
                         maxiter=50):
    """One MG-free distributed solve step: Jacobi-preconditioned CG on the
    row-sharded operator.  jnp inner products on sharded arrays ARE the
    distributed inner products (XLA inserts the collectives; ref ip_norm
    ip_distributed_nonoverlapping)."""
    from ..base.solvers import _cg_core
    from ..base.linear_operators import Diagonal_LinearOperator

    N = b.shape[0]
    bP = jnp.pad(b, (0, pad)) if pad else b

    diag = jnp.diagonal(A_sharded.data)
    diag = jnp.where(diag != 0, diag, 1.0)
    M = Diagonal_LinearOperator(1.0 / diag)
    x, iters, res = _cg_core(A_sharded, M, bP, jnp.zeros_like(bP),
                             tol, maxiter, use_prec=True)
    return x[:N], iters


# --------------------------------------------------------------------------
# Distributed operators (device analogues of the reference's testDistOp modes,
# ref clusterMethodCy.pyx DistributedH2Matrix_globalData:3127 (bcast) and
# DistributedH2Matrix_localData (halo)).


class DistributedRowBlockOperator:
    """S3 'bcast' mode: each device owns a contiguous dense row block; the
    input vector is replicated (the XLA analogue of MPI Bcast), the result
    comes back row-sharded and is psum-free.

    Works for any operator that can materialize rows (dense, CSR, H2 --
    the row blocks are densified on device; the H2 rank structure is used
    during assembly, the distributed apply trades its memory savings for
    matmul-friendly blocked matvecs)."""

    def __init__(self, A, mesh, axis='d'):
        from ..base.linear_operators import LinearOperator
        self.mesh = mesh
        self.axis = axis
        data = jnp.asarray(A.data) if (hasattr(A, 'data')
                                       and np.ndim(A.data) == 2) \
            else jnp.asarray(A.toarray())
        N = data.shape[0]
        nd = mesh.devices.size
        self.N = N
        self.pad = (-N) % nd
        if self.pad:
            data = jnp.pad(data, ((0, self.pad), (0, self.pad)))
        self.num_rows = self.num_columns = N
        sharding = NamedSharding(mesh, P(axis, None))
        self.blocks = jax.device_put(data, sharding)

        def apply(Ablk, x):
            return Ablk @ x

        self._apply = jax.jit(jax.shard_map(
            apply, mesh=mesh, in_specs=(P(axis, None), P()),
            out_specs=P(axis)))

    def matvec(self, x):
        xP = jnp.pad(x, (0, self.pad)) if self.pad else x
        y = self._apply(self.blocks, xP)
        return y[:self.N]

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        return jnp.diagonal(self.blocks)[:self.N]


class DistributedHaloOperator:
    """S4 'halo' mode for banded operators (finite horizon): rows AND the
    input vector are sharded; each device fetches only the halo strips of x
    it needs from its neighbours via lax.ppermute (the XLA analogue of the
    reference's MPI halo exchange, DistributedH2Matrix_localData /
    CSR_DistributedLinearOperator).

    The local block is stored dense over the halo window
    [r0 - halo, r1 + halo) -- banded structure keeps the window small."""

    def __init__(self, A, mesh, axis='d', halo=None):
        self.mesh = mesh
        self.axis = axis
        data = np.asarray(A.toarray())
        N = data.shape[0]
        nd = mesh.devices.size
        self.N = N
        self.pad = (-N) % nd
        NP = N + self.pad
        per = NP // nd
        self.per = per
        if self.pad:
            data = np.pad(data, ((0, self.pad), (0, self.pad)))
        if halo is None:
            # bandwidth from the sparsity pattern
            rr, cc = np.nonzero(data)
            halo = int(np.abs(rr - cc).max()) if len(rr) else 0
        # a single ppermute step each way reaches one neighbouring block;
        # wider interaction (e.g. infinite horizon) keeps x sharded but
        # gathers it with all_gather (the device collective the reference's
        # tree-structured localData exchange amounts to)
        self.fullGather = halo > per
        self.halo = 0 if self.fullGather else max(halo, 0)
        H = self.halo
        # local windows [r0-H, r1+H) with zero padding outside
        if self.fullGather:
            blocks = data.reshape(nd, per, NP)
        else:
            blocks = np.zeros((nd, per, per + 2 * H))
            for k in range(nd):
                r0, r1 = k * per, (k + 1) * per
                lo, hi = r0 - H, r1 + H
                slo, shi = max(lo, 0), min(hi, NP)
                blocks[k, :, slo - lo:(slo - lo) + (shi - slo)] = \
                    data[r0:r1, slo:shi]
        self.num_rows = self.num_columns = N
        sharding = NamedSharding(mesh, P(axis, None, None))
        self.blocks = jax.device_put(jnp.asarray(blocks), sharding)
        nd_ = nd

        if self.fullGather:
            def apply(Ablk, xblk):
                xw = jax.lax.all_gather(xblk, axis).reshape(-1)
                return Ablk[0] @ xw
        else:
            def apply(Ablk, xblk):
                # Ablk [1, per, per+2H], xblk [per]
                left = jax.lax.ppermute(xblk[-H:] if H else xblk[:0],
                                        axis, [(i, (i + 1) % nd_)
                                               for i in range(nd_)])
                right = jax.lax.ppermute(xblk[:H] if H else xblk[:0],
                                         axis, [(i, (i - 1) % nd_)
                                                for i in range(nd_)])
                idx = jax.lax.axis_index(axis)
                left = jnp.where(idx == 0, 0.0, left)
                right = jnp.where(idx == nd_ - 1, 0.0, right)
                xw = jnp.concatenate([left, xblk, right])
                return Ablk[0] @ xw

        self._apply = jax.jit(jax.shard_map(
            apply, mesh=mesh, in_specs=(P(axis, None, None), P(axis)),
            out_specs=P(axis)))

    def matvec(self, x):
        xP = jnp.pad(x, (0, self.pad)) if self.pad else x
        y = self._apply(self.blocks, xP)
        return y[:self.N]

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        off = (lambda k: k * self.per) if self.fullGather \
            else (lambda k: self.halo)
        return jnp.concatenate(
            [jnp.diagonal(self.blocks[k, :,
                          off(k):off(k) + self.per])
             for k in range(self.mesh.devices.size)])[:self.N]


def _flattenRowBlock(op):
    return (op.blocks,), (op.mesh, op.axis, op.N, op.pad, op._apply)


def _unflattenRowBlock(aux, children):
    op = object.__new__(DistributedRowBlockOperator)
    op.mesh, op.axis, op.N, op.pad, op._apply = aux
    op.blocks, = children
    op.num_rows = op.num_columns = op.N
    return op


jax.tree_util.register_pytree_node(
    DistributedRowBlockOperator, _flattenRowBlock, _unflattenRowBlock)


def _flattenHalo(op):
    return (op.blocks,), (op.mesh, op.axis, op.N, op.pad, op.per, op.halo,
                          op.fullGather, op._apply)


def _unflattenHalo(aux, children):
    op = object.__new__(DistributedHaloOperator)
    (op.mesh, op.axis, op.N, op.pad, op.per, op.halo, op.fullGather,
     op._apply) = aux
    op.blocks, = children
    op.num_rows = op.num_columns = op.N
    return op


jax.tree_util.register_pytree_node(
    DistributedHaloOperator, _flattenHalo, _unflattenHalo)


def _relDiff(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def dryrunShardedDense(mesh, noRef=11, s=0.25):
    """S1 smoke: sharded dense assembly and the distributed Jacobi-CG solve
    of the 1D fractional problem (4095 dofs by default) on `mesh`, each
    compared with its run on one device.

    s=0.25 keeps kappa ~ h^{-2s} small enough that Jacobi-CG converges at
    this size, so the residual check is real."""
    from ..fem import simpleInterval, P1_DoFMap, assembleRHS, constant
    from ..nl import getFractionalKernel

    m = simpleInterval(-1.0, 1.0).refine()
    for _ in range(noRef):
        m = m.refine()
    dm = P1_DoFMap(m)
    kernel = getFractionalKernel(1, s)
    b = assembleRHS(dm, constant(1.0)).data
    runs = {}
    for label, msh in (('one', makeDeviceMesh(1)), ('mesh', mesh)):
        A = shardedDenseAssembly(dm, kernel, msh)
        Ash, pad = rowShardedOperator(A, msh)
        x, iters = distributedSolveStep(msh, Ash, b, pad, tol=1e-6,
                                        maxiter=1000)
        runs[label] = (A, x, int(iters))
    (A1, x1, it1), (An, xn, itn) = runs['one'], runs['mesh']
    errA = _relDiff(An.data, A1.data)
    errX = _relDiff(xn, x1)
    res = float(jnp.linalg.norm(b - An @ xn) / jnp.linalg.norm(b))
    print(f'S1 sharded dense assembly + CG ({mesh.devices.size} devices): '
          f'dofs={dm.num_dofs}, |A - A_1dev|/|A_1dev| = {errA:.2e}, '
          f'CG iters={itn} (1 device {it1}), |x - x_1dev|/|x_1dev| = '
          f'{errX:.2e}, rel residual={res:.2e}')
    assert errA < 1e-12, errA
    assert itn == it1, (itn, it1)
    assert errX < 1e-8, errX
    assert res < 1e-5, res
    return {'dofs': dm.num_dofs, 'errA': errA, 'iters': itn, 'errX': errX,
            'residual': res}


def dryrunShardedGMG(mesh, noRef=6):
    """S2 smoke: PCG with a sharded V-cycle preconditioner on the square
    Poisson problem; the sharded run must match the serial (one-device)
    iteration count and solution (ref runParallelGMG.py scope)."""
    from ..fem import (uniformSquare, P1_DoFMap, assembleRHS,
                       assembleStiffness, constant)
    from ..multilevel.gmg import multigrid, buildProlongation

    meshes = [uniformSquare(N=2, ax=0, ay=0, bx=1, by=1)]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    dms = [P1_DoFMap(mm) for mm in meshes]
    hierarchy = []
    for lvl, dmL in enumerate(dms):
        entry = {'A': assembleStiffness(dmL)}
        if lvl > 0:
            P_ = buildProlongation(dms[lvl - 1], dmL)
            entry['P'] = P_
            entry['R'] = P_.T
        hierarchy.append(entry)
    b = assembleRHS(dms[-1], constant(1.0)).data
    smoother = ('jacobi', {'presmoothingSteps': 2, 'postsmoothingSteps': 2,
                           'omega': 2.0 / 3.0})
    runs = {}
    for label, dmesh in (('serial', None), ('sharded', mesh)):
        ml = multigrid(hierarchy=hierarchy, smoother=smoother,
                       deviceMesh=dmesh)
        ml.tolerance = 1e-8
        ml.maxIter = 50
        ml.setup()
        x = ml.solve(b)
        runs[label] = (int(ml.iterations), x, float(jnp.linalg.norm(
            b - hierarchy[-1]['A'].matvec(x))))
    (itS, xS, resS), (itP, xP, resP) = runs['serial'], runs['sharded']
    errX = _relDiff(xP, xS)
    print(f'S2 sharded GMG ({mesh.devices.size} devices): '
          f'dofs={dms[-1].num_dofs}, iters={itP} (serial {itS}), '
          f'|x - x_serial|/|x_serial| = {errX:.2e}, residual={resP:.2e} '
          f'(serial {resS:.2e})')
    assert itS == itP, (itS, itP)
    assert errX < 1e-8, errX
    return {'dofs': dms[-1].num_dofs, 'iters': itP, 'errX': errX,
            'residual': resP}
