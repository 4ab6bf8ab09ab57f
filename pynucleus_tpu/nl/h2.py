"""Hierarchical (H2) matrices.

Counterpart of /root/reference/nl/PyNucleus_nl/clusterMethodCy.pyx (tree_node,
transferMatrixBuilder, assembleFarFieldInteractions, H2Matrix) and the tree /
admissibility drivers in nonlocalAssembly_{SCALAR}.pxi:2541-3221.

Design (SURVEY.md section 7): the ragged cluster tree is flattened into
LEVEL-MAJOR PADDED ARRAYS so the whole matvec is a fixed sequence of batched
einsums + segment-sums — one jit, no per-node dispatch:

  upward    : c_leaf = PhiT x_leaf                      [leaves, M]
              c_parent = sum_child T_child c_child      (batched matmul)
  far field : y_c[i] += K_pair @ x_c[j]  per level      (batched matmul)
  downward  : transpose of upward
  near field: CSR matvec (exact singular quadrature, same panel engine as
              the dense path, scattered into CSR slots)

Interpolation: tensor Chebyshev (first kind) per box, order m from the
reference's model (nonlocalAssembly pxi:2995-3000); admissibility
eta*dist >= max(diam) with eta=3 plus horizon screening
(clusterMethodCy.pyx:4008-4045).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

import scipy.sparse as sp

from ..config import REAL, INDEX
from ..base.linear_operators import LinearOperator, CSR_LinearOperator

__all__ = ['H2Matrix', 'buildClusterTree', 'treeNode', 'buildH2',
           'chebyshevPoints', 'chebyshevLagrangeEval']


# ------------------------------------------------------------- Chebyshev ---

def chebyshevPoints(m, a=0.0, b=1.0):
    """First-kind Chebyshev points mapped to [a, b]
    (ref clusterMethodCy assembleFarFieldInteractions:2178)."""
    eta = np.cos((2.0 * np.arange(m, 0, -1) - 1.0) / (2.0 * m) * np.pi)
    return (b - a) * 0.5 * (eta + 1.0) + a


def chebyshevLagrangeEval(m, a, b, x):
    """L_k(x) for the Chebyshev-Lagrange basis on [a,b]; x [n] -> [m, n].
    Uses the stable barycentric formula."""
    nodes = chebyshevPoints(m, a, b)
    k = np.arange(m)
    wbar = (-1.0) ** k * np.sin((2 * k + 1) * np.pi / (2 * m))
    x = np.asarray(x)
    diff = x[None, :] - nodes[:, None]              # [m, n]
    exact = np.abs(diff) < 1e-14
    diff = np.where(exact, 1.0, diff)
    terms = wbar[:, None] / diff
    denom = terms.sum(axis=0)
    L = terms / denom[None, :]
    # exact hits
    hit = exact.any(axis=0)
    if hit.any():
        L[:, hit] = exact[:, hit].astype(np.float64)
    return L


def tensorLagrangeEval(m, box, X):
    """Tensor-product basis evaluation: box [dim, 2], X [n, dim] -> [M, n]
    with M = m^dim, index ordering axis0-major (matching tensor grids)."""
    dim = X.shape[1]
    Ls = [chebyshevLagrangeEval(m, box[d, 0], box[d, 1], X[:, d])
          for d in range(dim)]
    out = Ls[0]
    for d in range(1, dim):
        out = (out[:, None, :] * Ls[d][None, :, :]).reshape(-1, X.shape[0])
    return out


def tensorChebyshevGrid(m, box):
    """[M, dim] tensor grid over the box."""
    dim = box.shape[0]
    axes = [chebyshevPoints(m, box[d, 0], box[d, 1]) for d in range(dim)]
    grids = np.meshgrid(*axes, indexing='ij')
    return np.stack([g.ravel() for g in grids], axis=1)


def _tensorDigits(m, dim):
    """[M, dim] digit table: index k of the axis0-major tensor grid has
    digit I[k, d] along axis d."""
    M = m ** dim
    k = np.arange(M)
    I = np.zeros((M, dim), dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        I[:, d] = k % m
        k = k // m
    return I


def batchedChebyshevGrids(m, boxes):
    """boxes [B, dim, 2] -> [B, M, dim] tensor grids: vectorized
    tensorChebyshevGrid (the per-node python loop is O(#tree nodes) and
    dominates host time at >100k dofs)."""
    boxes = np.asarray(boxes)
    B, dim, _ = boxes.shape
    eta = chebyshevPoints(m)                         # [m] on [0, 1]
    I = _tensorDigits(m, dim)                        # [M, dim]
    lo = boxes[:, :, 0]                              # [B, dim]
    wid = boxes[:, :, 1] - boxes[:, :, 0]
    # grid[b, k, d] = lo[b,d] + wid[b,d] * eta[I[k,d]]
    return lo[:, None, :] + wid[:, None, :] * eta[I][None, :, :]


def _chebLagrange01(m, t):
    """Standard Chebyshev-Lagrange basis on [0,1] at t [...]-> [..., m]
    (barycentric; exact at nodes)."""
    nodes = chebyshevPoints(m)
    k = np.arange(m)
    wbar = (-1.0) ** k * np.sin((2 * k + 1) * np.pi / (2 * m))
    diff = t[..., None] - nodes                      # [..., m]
    exact = np.abs(diff) < 1e-14
    diff = np.where(exact, 1.0, diff)
    terms = wbar / diff
    L = terms / terms.sum(axis=-1, keepdims=True)
    hit = exact.any(axis=-1)
    if hit.any():
        L[hit] = exact[hit].astype(np.float64)
    return L


def batchedLagrangeEval(m, boxes, X):
    """Vectorized tensorLagrangeEval: boxes [B, dim, 2], X [B, n, dim] ->
    [B, M, n] (basis axis0-major, matching tensorLagrangeEval)."""
    boxes = np.asarray(boxes)
    X = np.asarray(X)
    B, n, dim = X.shape
    lo = boxes[:, None, :, 0]
    wid = boxes[:, None, :, 1] - boxes[:, None, :, 0]
    t = (X - lo) / wid                               # [B, n, dim]
    out = None
    for d in range(dim):
        Ld = _chebLagrange01(m, t[:, :, d]).transpose(0, 2, 1)  # [B, m, n]
        out = Ld if out is None else \
            (out[:, :, None, :] * Ld[:, None, :, :]).reshape(B, -1, n)
    return out


# ------------------------------------------------------------------ tree ---

@dataclass
class treeNode:
    id: int
    level: int
    dofs: np.ndarray          # global dof indices owned by this node
    box: np.ndarray           # [dim, 2]
    parent: int = -1
    children: list = field(default_factory=list)
    # mixed: dofs whose support straddles a kernel-order jump interface;
    # such nodes are never far-field admissible (ref nonlocalAssembly
    # pxi:2623-2645 mixed_node)
    mixed: bool = False

    @property
    def isLeaf(self):
        return len(self.children) == 0


def _diam(box):
    return float(np.linalg.norm(box[:, 1] - box[:, 0]))


def _dist(box1, box2):
    d = np.maximum(box1[:, 0] - box2[:, 1], box2[:, 0] - box1[:, 1])
    return float(np.linalg.norm(np.maximum(d, 0.0)))


def _maxDist(box1, box2):
    d = np.maximum(np.abs(box1[:, 1] - box2[:, 0]),
                   np.abs(box2[:, 1] - box1[:, 0]))
    return float(np.linalg.norm(d))


def dofSupportBoxes(dm):
    """Bounding box of each dof's support (ref clusterMethodCy
    getDoFBoxesAndCells:3922)."""
    mesh = dm.mesh
    N = dm.num_dofs
    lo = np.full((N, mesh.dim), np.inf)
    hi = np.full((N, mesh.dim), -np.inf)
    V = mesh.vertices[mesh.cells]        # [C, m+1, dim]
    cl = V.min(axis=1)
    ch = V.max(axis=1)
    d = dm.dofs
    for l in range(d.shape[1]):
        ii = d[:, l]
        mask = ii >= 0
        np.minimum.at(lo, ii[mask], cl[mask])
        np.maximum.at(hi, ii[mask], ch[mask])
    return lo, hi


def buildClusterTree(dm, minSize, maxLevels=200):
    """MEDIAN-split binary tree over dofs (ref tree_node.refine,
    clusterMethodCy.pyx:354; MEDIAN refinementType is the reference default,
    nonlocalAssembly pxi:3034)."""
    lo, hi = dofSupportBoxes(dm)
    centers = 0.5 * (lo + hi)
    nodes = []

    def makeBox(idx):
        return np.stack([lo[idx].min(axis=0), hi[idx].max(axis=0)], axis=1)

    def rec(idx, level, parent):
        nid = len(nodes)
        node = treeNode(nid, level, np.sort(idx), makeBox(idx), parent)
        nodes.append(node)
        if len(idx) > minSize and level < maxLevels:
            c = centers[idx]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            med = np.median(c[:, axis])
            maskL = c[:, axis] <= med
            # guard degenerate splits
            if maskL.all() or not maskL.any():
                order = np.argsort(c[:, axis])
                half = len(idx) // 2
                maskL = np.zeros(len(idx), dtype=bool)
                maskL[order[:half]] = True
            left = idx[maskL]
            right = idx[~maskL]
            if len(left) and len(right):
                node.children = [rec(left, level + 1, nid),
                                 rec(right, level + 1, nid)]
        return nid

    rec(np.arange(dm.num_dofs), 0, -1)
    return nodes


def splitLeavesByKernelBlocks(nodes, dm, kernel):
    """For spatially-varying kernel orders, split each leaf into sub-leaves
    of constant order so far-field boxes never straddle an order jump; dofs
    whose support spans the jump form 'mixed' interface nodes that stay in
    the near field (ref nonlocalAssembly pxi:2623-2645, blocks from
    getKernelBlocksAndJumps pxi:2320-2350)."""
    mesh = dm.mesh
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    sDiag = np.round(np.asarray(kernel.s(centers, centers)).reshape(-1), 12)
    if np.unique(sDiag).shape[0] <= 1:
        return nodes
    N = dm.num_dofs
    INTERFACE = np.nan
    dofOrder = np.full(N, np.inf)
    isInterface = np.zeros(N, dtype=bool)
    d = dm.dofs
    for c in range(mesh.num_cells):
        for l in range(d.shape[1]):
            i = d[c, l]
            if i < 0:
                continue
            if dofOrder[i] == np.inf:
                dofOrder[i] = sDiag[c]
            elif dofOrder[i] != sDiag[c]:
                isInterface[i] = True
    lo, hi = dofSupportBoxes(dm)

    def makeBox(idx):
        return np.stack([lo[idx].min(axis=0), hi[idx].max(axis=0)], axis=1)

    # an s-IMPURE box (dofs from several order blocks, or interface dofs)
    # makes the kernel discontinuous on its Chebyshev grid -> never
    # far-field admissible, at ANY level (ref: canBeAssembled stays False
    # above the block-pure nodes)
    for nd in nodes:
        dKeys = np.where(isInterface[nd.dofs], INTERFACE, dofOrder[nd.dofs])
        nd.mixed = bool(isInterface[nd.dofs].any()
                        or np.unique(dKeys[~np.isnan(dKeys)]).shape[0] > 1)

    for nid in range(len(nodes)):
        nd = nodes[nid]
        if not nd.isLeaf:
            continue
        keys = np.where(isInterface[nd.dofs], INTERFACE, dofOrder[nd.dofs])
        uniqKeys = sorted(set(keys.tolist()), key=lambda v: (np.isnan(v), v))
        if len(uniqKeys) <= 1:
            nd.mixed = bool(isInterface[nd.dofs].any())
            continue
        children = []
        for key in uniqKeys:
            sel = np.isnan(keys) if np.isnan(key) else (keys == key)
            sub = nd.dofs[sel]
            child = treeNode(len(nodes), nd.level + 1, sub, makeBox(sub),
                             nd.id, mixed=bool(np.isnan(key)))
            nodes.append(child)
            children.append(child.id)
        nd.children = children
    return nodes


def admissibleClusters(kernel, nodes, eta, interpolation_order, dim,
                       minFarFieldBlockSize=None):
    """Dual-tree traversal -> (Pfar per level, Pnear leaf pairs)
    (ref getAdmissibleClusters clusterMethodCy.pyx:4046, queryAdmissibility
    :4008).

    minFarFieldBlockSize gates admissibility on the dof-pair count
    (ref getH2RefinementParams minFarFieldBlockSize): the default (m^dim)^2
    keeps far blocks no larger than the dense block they replace; passing
    m^dim trades far-field memory for assembly speed (the extra leaf-level
    far pairs are batched Chebyshev einsums instead of singular quadrature),
    at the cost of borderline-pair interpolation error near the
    singularity."""
    M = interpolation_order ** dim
    ffSize = minFarFieldBlockSize if minFarFieldBlockSize is not None \
        else M * M

    # node arrays (the former pair recursion did per-pair numpy box math --
    # minutes of host time at 1M dofs; this BFS classifies whole waves)
    nN = len(nodes)
    lo = np.stack([nd.box[:, 0] for nd in nodes])
    hi = np.stack([nd.box[:, 1] for nd in nodes])
    diam = np.linalg.norm(hi - lo, axis=1)
    nDofs = np.fromiter((len(nd.dofs) for nd in nodes), np.int64, nN)
    isLeaf = np.fromiter((nd.isLeaf for nd in nodes), bool, nN)
    mixed = np.fromiter((nd.mixed for nd in nodes), bool, nN)
    level = np.fromiter((nd.level for nd in nodes), np.int64, nN)
    cnt = np.fromiter((len(nd.children) for nd in nodes), np.int64, nN)
    childArr = np.concatenate(
        [np.asarray(nd.children, dtype=np.int64) for nd in nodes
         if nd.children] or [np.empty(0, dtype=np.int64)])
    childOff = np.zeros(nN + 1, dtype=np.int64)
    childOff[1:] = np.cumsum(cnt)

    def _aranges(reps):
        total = int(reps.sum())
        starts = np.repeat(np.cumsum(reps) - reps, reps)
        return np.arange(total) - starts

    def childrenOf(v):
        """Flattened children of each node in v (ragged, v-major order)."""
        reps = cnt[v]
        idx = np.repeat(childOff[v], reps) + _aranges(reps)
        return childArr[idx]

    farI, farJ = [], []
    nearI, nearJ = [], []
    ii = np.array([0], dtype=np.int64)
    jj = np.array([0], dtype=np.int64)
    while len(ii):
        dvec = np.maximum(np.maximum(lo[ii] - hi[jj], lo[jj] - hi[ii]), 0.0)
        dist = np.linalg.norm(dvec, axis=1)
        keep = np.ones(len(ii), dtype=bool)
        onHorizon = np.zeros(len(ii), dtype=bool)
        if kernel.finiteHorizon:
            hv = kernel.horizonValue
            dmax = np.maximum(np.abs(hi[ii] - lo[jj]),
                              np.abs(hi[jj] - lo[ii]))
            maxDist = np.linalg.norm(dmax, axis=1)
            if not kernel.complement:
                keep = dist <= hv
            else:
                keep = maxDist > hv
            onHorizon = (dist <= hv) & (hv <= maxDist)
        sizeProd = nDofs[ii] * nDofs[jj]
        # pairs below the (m^dim)^2 block size need strong separation: near
        # the singularity the kernel magnitude amplifies the Chebyshev
        # interpolation error of borderline-separated tiny pairs
        etaEff = np.where(sizeProd >= M * M, eta, 0.5)
        # equal levels required so the level-batched far matvec can index
        # src/dst coefficients within one level (unequal-level admissible
        # pairs -- possible only through leaf/block asymmetry -- refine on
        # to exact near pairs instead)
        admissible = keep & (etaEff * dist >= np.maximum(diam[ii], diam[jj])) \
            & ~onHorizon & (ffSize <= sizeProd) \
            & ~mixed[ii] & ~mixed[jj] & (level[ii] == level[jj])
        farI.append(ii[admissible])
        farJ.append(jj[admissible])
        bothLeaf = isLeaf[ii] & isLeaf[jj]
        near = keep & ~admissible & bothLeaf
        nearI.append(ii[near])
        nearJ.append(jj[near])
        ref = keep & ~admissible & ~bothLeaf
        iR, jR = ii[ref], jj[ref]
        # split non-leaves: i leaf -> (i, ch(j)); j leaf -> (ch(i), j);
        # neither -> ch(i) x ch(j)
        A = isLeaf[iR]
        B = isLeaf[jR] & ~A
        Cm = ~isLeaf[iR] & ~isLeaf[jR]
        nxtI = [np.repeat(iR[A], cnt[jR[A]]), childrenOf(iR[B])]
        nxtJ = [childrenOf(jR[A]), np.repeat(jR[B], cnt[iR[B]])]
        iC, jC = iR[Cm], jR[Cm]
        if len(iC):
            ciFlat = childrenOf(iC)                       # i-child, i-major
            repsJ = cnt[np.repeat(jC, cnt[iC])]           # per i-child
            nxtI.append(np.repeat(ciFlat, repsJ))
            nxtJ.append(childrenOf(np.repeat(jC, cnt[iC])))
        ii = np.concatenate(nxtI)
        jj = np.concatenate(nxtJ)

    farI = np.concatenate(farI)
    farJ = np.concatenate(farJ)
    Pfar = {}
    for ell in np.unique(level[farI]):
        sel = level[farI] == ell
        Pfar[int(ell)] = list(zip(farI[sel].tolist(), farJ[sel].tolist()))
    Pnear = list(zip(np.concatenate(nearI).tolist(),
                     np.concatenate(nearJ).tolist()))
    return Pfar, Pnear


# ---------------------------------------------------- block near field ----

def _pow2(v, lo=1):
    p = lo
    while p < v:
        p *= 2
    return p


def _nf_aranges(reps):
    """Concatenated [0..r) ranges for each r in reps (ragged arange)."""
    reps = np.asarray(reps)
    total = int(reps.sum())
    starts = np.repeat(np.cumsum(reps) - reps, reps)
    return np.arange(total) - starts


class _TreeNearMeta:
    """Host-side structure of the tree-ordered near field.  Identity-hashed
    (default object hash) so it can sit in a pytree aux without pulling
    nnz-scale arrays into jit cache keys."""

    __slots__ = ('indptrT', 'tmplAll', 'tmplStart', 'tStartRow', 'tLen',
                 'rowLen', 'perm', 'N', 'partners')

    def __init__(self, indptrT, tmplAll, tmplStart, tStartRow, tLen,
                 rowLen, perm, N, partners=None):
        self.indptrT = indptrT        # [Nt+1] row pointer (tree order)
        self.tmplAll = tmplAll        # concatenated per-node col templates
        self.tmplStart = tmplStart    # [nNear] template start per node
        self.tStartRow = tStartRow    # [nNear+1] tree row start per node
        self.tLen = tLen              # [nNear] rows per node
        self.rowLen = rowLen          # [nNear] cols per node
        self.perm = perm              # [Nt] tree position -> global dof
        self.N = N
        # (partnerNodes, grpStart): per row-node r the partner node rows
        # are partnerNodes[grpStart[r]:grpStart[r+1]], sorted by tree start
        # (the template order)
        self.partners = partners


class TreeNearOperator(LinearOperator):
    """Near field of the H2 operator as batched block-dense GEMMs.

    The tree-ordered near-field pattern (nonlocalBuilder._assembleNearField)
    is a concatenation of per-node dense blocks: every row of near node r
    shares one column template (its partners' tree ranges), so block r is
    dataT[indptrT[tStart[r]]:...].reshape(n_r, L_r).  Grouping nodes into
    (padded n, padded L) buckets turns the matvec into a handful of batched
    [B,n,L]x[B,L] contractions instead of a gather/segment-sum CSR
    matvec (ref near-field CSR/SSS matvec, clusterMethodCy.pyx:2269-2348 --
    the block layout is the batched-matmul equivalent).  Which form is
    faster on the H100 is not yet measured.

    Block index arrays are built ON DEVICE from O(#nodes) metadata (affine
    index arithmetic), so construction ships kilobytes, not nnz.
    A global-dof-ordered CSR view is materialized lazily for interop
    (distributed splitting, HDF5, scipy round trips).
    """

    def __init__(self, dataT, meta, dtype=None, _defer=False):
        self.meta = meta
        N = meta.N
        self.num_rows = self.num_columns = N
        self.outDtype = dtype
        if _defer:
            return
        dataT = jnp.asarray(dataT)
        self.dataZ = jnp.concatenate(
            [dataT, jnp.zeros(1, dataT.dtype)])       # [nnz+1], zero pad slot
        nnz = dataT.shape[0]
        tLen = np.asarray(meta.tLen)
        rowLen = np.asarray(meta.rowLen)
        nNear = len(tLen)
        partnerNodes, grpStart = meta.partners
        nPart = np.diff(grpStart)                     # partners per node
        # uniform padded leaf layout: node r's rows/cols live in row r of an
        # [nNear, nbar] matrix, so the x fetch per (node, partner) becomes a
        # ROW gather (slice size nbar) instead of per-element gathers (the
        # faster form on the previous accelerator; on the H100 it awaits
        # measurement)
        nbar = max(int(tLen.max()) if nNear else 1, 1)
        self.nbar = nbar
        live = (tLen > 0) & (rowLen > 0)
        buckets = {}
        for r in range(nNear):
            if live[r]:
                buckets.setdefault(int(_pow2(max(nPart[r], 1), 2)),
                                   []).append(r)
        permPad = np.full(nNear * nbar, N, dtype=np.int64)
        for_r = np.repeat(np.arange(nNear), tLen)
        in_r = _nf_aranges(tLen)
        permPad[for_r * nbar + in_r] = meta.perm
        self.permPad = jnp.asarray(permPad, dtype=INDEX)
        indptrD = jnp.asarray(np.asarray(meta.indptrT), dtype=jnp.int64)
        # partner template offsets within each node's rows (exclusive
        # prefix of partner lengths, template order)
        pLenAll = tLen[partnerNodes]
        pOffAll = np.zeros(len(partnerNodes) + 1, dtype=np.int64)
        pOffAll[1:] = np.cumsum(pLenAll)
        pOffAll = pOffAll[:-1] - np.repeat(pOffAll[grpStart[:-1]], nPart)
        self.blocks = []
        self.bucketShapes = []
        for PP, rs in sorted(buckets.items()):
            rs = np.asarray(rs)
            B = len(rs)
            pIdx = np.full((B, PP), nNear, dtype=np.int64)     # pad: zero row
            pOff = np.zeros((B, PP), dtype=np.int64)
            pLen = np.zeros((B, PP), dtype=np.int64)
            for q, r in enumerate(rs):
                s, e = grpStart[r], grpStart[r + 1]
                pIdx[q, :e - s] = partnerNodes[s:e]
                pOff[q, :e - s] = pOffAll[s:e]
                pLen[q, :e - s] = pLenAll[s:e]
            startD = jnp.asarray(meta.indptrT[meta.tStartRow[rs]],
                                 dtype=jnp.int64)              # [B]
            LD = jnp.asarray(rowLen[rs], dtype=jnp.int64)
            nD = jnp.asarray(tLen[rs], dtype=jnp.int64)
            pOffD = jnp.asarray(pOff, dtype=jnp.int64)
            pLenD = jnp.asarray(pLen, dtype=jnp.int64)
            ii = jnp.arange(nbar, dtype=jnp.int64)
            cc = jnp.arange(nbar, dtype=jnp.int64)
            # idx[b, i, p, c] = rowStart(b, i) + pOff[b, p] + c
            rowStart = startD[:, None] + ii[None, :] * LD[:, None]  # [B, nbar]
            idx = (rowStart[:, :, None, None] + pOffD[:, None, :, None]
                   + cc[None, None, None, :])
            ok = ((ii[None, :, None, None] < nD[:, None, None, None])
                  & (cc[None, None, None, :] < pLenD[:, None, :, None]))
            idx = jnp.where(ok, idx, nnz)
            bd = self.dataZ[idx].reshape(B, nbar, PP * nbar)
            self.blocks.append((bd, jnp.asarray(pIdx, dtype=INDEX),
                                jnp.asarray(rs, dtype=INDEX)))
            self.bucketShapes.append((B, nbar, PP))
        self._nNear = nNear
        self._diag = None
        self._gcsr = None

    # ------------------------------------------------------------- matvec
    def _x2(self, x):
        xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        xt = xp[self.permPad].reshape(self._nNear, self.nbar)
        return jnp.concatenate(
            [xt, jnp.zeros((1, self.nbar), x.dtype)])   # pad row nNear

    def _matvec_tree(self, x2):
        """Near matvec in the padded tree layout: x2, result [nNear+1, nbar]
        (callers fuse the global<->tree exchange with the far field)."""
        y2 = jnp.zeros((self._nNear + 1, self.nbar), x2.dtype)
        for bd, pIdx, nodeIdx in self.blocks:
            xw = x2[pIdx]                               # [B, PP, nbar] rows
            yb = jnp.einsum('bic,bc->bi', bd,
                            xw.reshape(xw.shape[0], -1))
            y2 = y2.at[nodeIdx].add(yb)                 # row scatter
        return y2

    def _scatter_tree(self, y2):
        yt = y2[:self._nNear].reshape(-1)
        return jax.ops.segment_sum(yt, self.permPad,
                                   num_segments=self.num_rows + 1)[:-1]

    def matvec(self, x):
        return self._scatter_tree(self._matvec_tree(self._x2(x)))

    def rmatvec(self, x):
        N = self.num_rows
        x2 = self._x2(x)
        y2 = jnp.zeros((self._nNear + 1, self.nbar), x.dtype)
        for bd, pIdx, nodeIdx in self.blocks:
            xr = x2[nodeIdx]                            # [B, nbar]
            cb = jnp.einsum('bic,bi->bc', bd, xr)       # [B, PP*nbar]
            y2 = y2.at[pIdx].add(
                cb.reshape(cb.shape[0], -1, self.nbar))
        yt = y2[:self._nNear].reshape(-1)
        return jax.ops.segment_sum(yt, self.permPad,
                                   num_segments=N + 1)[:N]

    def matvec_no_overwrite(self, x, y):
        return y + self.matvec(x)

    def isSparse(self):
        return True

    @property
    def nnz(self):
        return int(self.meta.indptrT[-1])

    # ----------------------------------------------------------- diagonal
    @property
    def diagonal(self):
        if self._diag is None:
            m = self.meta
            N = m.N
            nnz = int(m.indptrT[-1])
            slots = np.full(N, nnz, dtype=np.int64)
            nNear = len(m.tLen)
            for r in range(nNear):
                n = int(m.tLen[r])
                L = int(m.rowLen[r])
                if n == 0 or L == 0:
                    continue
                tmpl = m.tmplAll[m.tmplStart[r]:m.tmplStart[r] + L]
                t0 = int(m.tStartRow[r])
                tsel = np.arange(t0, t0 + n)
                pos = np.searchsorted(tmpl, tsel)
                ok = (pos < L)
                okp = np.where(ok, pos, 0)
                ok &= tmpl[okp] == tsel
                slots[m.perm[tsel[ok]]] = m.indptrT[tsel[ok]] + pos[ok]
            self._diagSlots = jnp.asarray(slots, dtype=jnp.int64)
            self._diag = self.dataZ[self._diagSlots]
        return self._diag

    # --------------------------------------------- lazy global CSR interop
    def _globalCSR(self):
        if self._gcsr is None:
            self._gcsr = _treeCSRToGlobalData(
                np.asarray(self.dataZ[:-1]), self.meta, self.outDtype)
        return self._gcsr

    @property
    def data(self):
        return self._globalCSR().data

    @property
    def indices(self):
        return self._globalCSR().indices

    @property
    def indptr(self):
        return self._globalCSR().indptr

    @property
    def rowids(self):
        return self._globalCSR().rowids

    def to_scipy(self):
        return self._globalCSR().to_scipy()

    def toarray(self):
        return self._globalCSR().toarray()

    @property
    def T(self):
        from ..base.linear_operators import _CSRTranspose
        return _CSRTranspose(self)

    def __repr__(self):
        return (f'<TreeNearOperator {self.num_rows}x{self.num_columns} '
                f'nnz={self.nnz} buckets={self.bucketShapes}>')


def _nearop_flatten(op):
    children = (op.dataZ, tuple(op.blocks), op.permPad, op._diag)
    aux = (op.meta, tuple(op.bucketShapes), op.outDtype, op.nbar,
           op._nNear)
    return children, aux


def _nearop_unflatten(aux, children):
    op = TreeNearOperator.__new__(TreeNearOperator)
    op.meta, shapes, op.outDtype, op.nbar, op._nNear = aux
    op.bucketShapes = list(shapes)
    op.dataZ, blocks, op.permPad, op._diag = children
    op.blocks = list(blocks)
    op.num_rows = op.num_columns = op.meta.N
    op._gcsr = None
    return op


jax.tree_util.register_pytree_node(
    TreeNearOperator, _nearop_flatten, _nearop_unflatten)


def _treeCSRToGlobalData(dataT, m, outDtype):
    """Host conversion of tree-ordered near data to a global-dof CSR
    (interop path; the matvec never uses it)."""
    from ..nl.assembly import _treeCSRToGlobal
    if outDtype is not None:
        dataT = np.asarray(dataT).astype(outDtype, copy=False)
    At = type('X', (), {'data': dataT})()
    return _treeCSRToGlobal(At, m.perm, m.tLen, m.rowLen, m.tStartRow,
                            m.tmplAll, m.tmplStart, m.indptrT, m.N)


# ------------------------------------------------------------ H2 operator --

class _H2Level:
    """Per-level device arrays; 'size' is static metadata."""

    def __init__(self, size, T=None, parentIdx=None, K=None, src=None,
                 dst=None):
        self.size = size
        self.T = T
        self.parentIdx = parentIdx
        self.K = K
        self.src = src
        self.dst = dst

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, val):
        setattr(self, key, val)


jax.tree_util.register_pytree_node(
    _H2Level,
    lambda l: ((l.T, l.parentIdx, l.K, l.src, l.dst), (l.size,)),
    lambda aux, ch: _H2Level(aux[0], *ch))

class H2Matrix(LinearOperator):
    """Level-major padded H2 operator (pytree).

    Data layout (device):
      Anear                      CSR near field
      leafDofs   [L, maxLeafN]   dof gather map (pad -1)
      leafPhi    [L, maxLeafN, M]
      leafNode   [L]             node id -> position maps per level below
      For each tree level ell (coarse->fine):
        T[ell]       [n_ell, M, M]   child->parent transfer (applied to each
                                     node's coeffs, summed into parents)
        parentIdx[ell] [n_ell]       position of parent in level ell-1
      For each level with far-field pairs:
        K[ell]       [p_ell, M, M]   kernel on Chebyshev grids
        src[ell], dst[ell] [p_ell]   positions within level ell
    """

    def __init__(self, Anear, leafDofs, leafPhi, leafLevelPos, levels,
                 num_rows, symmetric=True):
        self.Anear = Anear
        self.leafDofs = leafDofs
        self.leafPhi = leafPhi
        # static metadata: (lvlIdx, posIdx) per leaf, as hashable tuples
        lvlIdx, posIdx = leafLevelPos
        self.leafLevelPos = (tuple(int(v) for v in lvlIdx),
                             tuple(int(v) for v in posIdx))
        self.levels = levels              # list of _H2Level
        self.num_rows = self.num_columns = num_rows
        self.symmetric = symmetric
        # per-level leaf gather/scatter maps as DEVICE arrays (pytree
        # children): host-numpy index constants inside the jitted matvec
        # would be serialized into the HLO as constants; device args are
        # transferred once
        lvlArr = np.asarray(self.leafLevelPos[0], dtype=np.int64)
        posArr = np.asarray(self.leafLevelPos[1], dtype=np.int64)
        self.leafSel = []
        self.leafPos = []
        for ell in range(len(levels)):
            sel = np.nonzero(lvlArr == ell)[0]
            self.leafSel.append(jnp.asarray(sel, dtype=INDEX))
            self.leafPos.append(jnp.asarray(posArr[sel], dtype=INDEX))
        # fused tree layout: when the near operator's padded row layout
        # coincides with the leaf list (leaf li == near row li), the whole
        # matvec shares ONE global->tree gather and ONE tree->global
        # segment-sum (leaf moments read x2 rows directly, no leafDofs
        # gather)
        self.fusedTree = False
        if (isinstance(Anear, TreeNearOperator)
                and Anear._nNear == leafPhi.shape[0]
                and Anear.nbar == leafPhi.shape[1]):
            lfFlat = np.where(np.asarray(leafDofs) >= 0,
                              np.asarray(leafDofs), num_rows).reshape(-1)
            self.fusedTree = bool(
                (np.asarray(Anear.permPad) == lfFlat).all())

    def isSparse(self):
        return False

    def matvec(self, x):
        return _h2_matvec(self, x)

    @property
    def diagonal(self):
        return self.Anear.diagonal

    @property
    def T(self):
        if self.symmetric:
            return self
        return _H2Transpose(self)

    def getnear(self):
        return self.Anear

    # ---- HDF5 checkpointing (assembly is expensive; operators are
    # checkpointable in the reference: H2Matrix.HDF5write/read,
    # clusterMethodCy.pyx:2449-2551, tree serializers :1492-1778)
    def HDF5write(self, node):
        node.attrs['type'] = 'h2'
        node.attrs['num_rows'] = self.num_rows
        node.attrs['symmetric'] = self.symmetric
        node.create_dataset('leafDofs', data=np.asarray(self.leafDofs))
        node.create_dataset('leafPhi', data=np.asarray(self.leafPhi))
        node.create_dataset('leafLvl',
                            data=np.asarray(self.leafLevelPos[0]))
        node.create_dataset('leafPos',
                            data=np.asarray(self.leafLevelPos[1]))
        An = node.create_group('Anear')
        An.create_dataset('rowids', data=np.asarray(self.Anear.rowids))
        An.create_dataset('indices', data=np.asarray(self.Anear.indices))
        An.create_dataset('data', data=np.asarray(self.Anear.data))
        An.attrs['num_rows'] = self.Anear.num_rows
        An.attrs['num_columns'] = self.Anear.num_columns
        lv = node.create_group('levels')
        lv.attrs['n'] = len(self.levels)
        for ell, l in enumerate(self.levels):
            g = lv.create_group(str(ell))
            g.attrs['size'] = l.size
            for nm in ('T', 'parentIdx', 'K', 'src', 'dst'):
                v = getattr(l, nm)
                if v is not None:
                    g.create_dataset(nm, data=np.asarray(v))

    @staticmethod
    def HDF5read(node):
        assert node.attrs['type'] == 'h2'
        An = node['Anear']
        Anear = CSR_LinearOperator(
            np.asarray(An['indices']), data=np.asarray(An['data']),
            rowids=np.asarray(An['rowids']),
            num_rows=int(An.attrs['num_rows']),
            num_columns=int(An.attrs['num_columns']))
        levels = []
        lv = node['levels']
        for ell in range(int(lv.attrs['n'])):
            g = lv[str(ell)]
            entry = _H2Level(int(g.attrs['size']))
            for nm in ('T', 'parentIdx', 'K', 'src', 'dst'):
                if nm in g:
                    dt = INDEX if nm in ('parentIdx', 'src', 'dst') else None
                    entry[nm] = jnp.asarray(np.asarray(g[nm]), dtype=dt)
            levels.append(entry)
        return H2Matrix(
            Anear, jnp.asarray(np.asarray(node['leafDofs']), dtype=INDEX),
            jnp.asarray(np.asarray(node['leafPhi'])),
            (np.asarray(node['leafLvl']), np.asarray(node['leafPos'])),
            levels, int(node.attrs['num_rows']),
            symmetric=bool(node.attrs['symmetric']))

    def __repr__(self):
        far = sum(lvl['K'].shape[0] for lvl in self.levels if lvl['K'] is not None)
        return (f'<H2Matrix {self.num_rows}x{self.num_columns} '
                f'nnz_near={self.Anear.nnz} farPairs={far} '
                f'levels={len(self.levels)}>')


class _H2Transpose(LinearOperator):
    """Transpose matvec of a nonsymmetric H2 operator: the same level-major
    passes with far-pair src/dst roles swapped and K transposed, plus the
    transposed near field (ref clusterMethodCy transpose matvec variants
    around :2269-2348)."""

    def __init__(self, op):
        self.op = op
        self.num_rows = op.num_columns
        self.num_columns = op.num_rows

    def matvec(self, x):
        return _h2_matvec_T(self.op, x)

    @property
    def T(self):
        return self.op

    @property
    def diagonal(self):
        return self.op.diagonal


jax.tree_util.register_pytree_node(
    _H2Transpose,
    lambda t: ((t.op,), ()),
    lambda aux, ch: _H2Transpose(ch[0]))


def _h2_flatten(op):
    children = (op.Anear, op.leafDofs, op.leafPhi, op.levels,
                op.leafSel, op.leafPos)
    aux = (op.leafLevelPos, op.num_rows, op.symmetric,
           getattr(op, 'fusedTree', False))
    return children, aux


def _h2_unflatten(aux, children):
    op = object.__new__(H2Matrix)
    (op.Anear, op.leafDofs, op.leafPhi, op.levels,
     op.leafSel, op.leafPos) = children
    op.leafLevelPos, op.num_rows, op.symmetric, op.fusedTree = aux
    op.num_columns = op.num_rows
    return op


jax.tree_util.register_pytree_node(H2Matrix, _h2_flatten, _h2_unflatten)


@jax.jit
def _h2_matvec_T(op, x):
    """Transpose matvec: far field with src<->dst swapped and K transposed;
    near field via the CSR transpose (segment-sum over columns)."""
    nLvl = len(op.levels)
    M = op.leafPhi.shape[2]

    xg = jnp.where(op.leafDofs >= 0, x[jnp.clip(op.leafDofs, 0)], 0.0)
    cLeaf = jnp.einsum('lnm,ln->lm', op.leafPhi, xg)

    coeffs = []
    for ell in range(nLvl):
        coeffs.append(jnp.zeros((op.levels[ell]['size'], M), dtype=x.dtype))
    for ell in range(nLvl):
        if op.leafSel[ell].shape[0]:
            coeffs[ell] = coeffs[ell].at[op.leafPos[ell]].add(
                cLeaf[op.leafSel[ell]])

    for ell in range(nLvl - 1, 0, -1):
        lvl = op.levels[ell]
        up = jnp.einsum('nij,nj->ni', lvl['T'], coeffs[ell])
        coeffs[ell - 1] = coeffs[ell - 1] + jax.ops.segment_sum(
            up, lvl['parentIdx'], num_segments=op.levels[ell - 1]['size'])

    out = [jnp.zeros_like(c) for c in coeffs]
    for ell in range(nLvl):
        lvl = op.levels[ell]
        if lvl['K'] is not None:
            # A^T: pair (dst, src, K) acts as (src, dst, K^T)
            contrib = jnp.einsum('pji,pj->pi', lvl['K'],
                                 coeffs[ell][lvl['dst']])
            out[ell] = out[ell].at[lvl['src']].add(contrib)

    for ell in range(1, nLvl):
        lvl = op.levels[ell]
        down = out[ell - 1][lvl['parentIdx']]
        out[ell] = out[ell] + jnp.einsum('nji,nj->ni', lvl['T'], down)

    yLeaf = jnp.zeros_like(cLeaf)
    for ell in range(nLvl):
        if op.leafSel[ell].shape[0]:
            yLeaf = yLeaf.at[op.leafSel[ell]].set(
                out[ell][op.leafPos[ell]])

    yvals = jnp.einsum('lnm,lm->ln', op.leafPhi, yLeaf)
    N = op.num_rows
    flat = jnp.where(op.leafDofs >= 0, op.leafDofs, N).reshape(-1)
    y = jax.ops.segment_sum(yvals.reshape(-1), flat, num_segments=N + 1)[:N]

    y = y + op.Anear.rmatvec(x)
    return y


@jax.jit
def _h2_matvec(op, x):
    nLvl = len(op.levels)
    M = op.leafPhi.shape[2]

    # ---- leaf moments (fused: leaf li's x-values ARE row li of the near
    # operator's padded tree layout -- one shared global->tree gather)
    if getattr(op, 'fusedTree', False):
        L = op.leafPhi.shape[0]
        x2 = op.Anear._x2(x)
        cLeaf = jnp.einsum('lnm,ln->lm', op.leafPhi, x2[:L])
    else:
        xg = jnp.where(op.leafDofs >= 0, x[jnp.clip(op.leafDofs, 0)], 0.0)
        cLeaf = jnp.einsum('lnm,ln->lm', op.leafPhi, xg)   # [L, M]

    # ---- scatter leaf moments into their levels, then sweep up
    # (device index maps; shapes are static at trace time)
    coeffs = []
    for ell in range(nLvl):
        n = op.levels[ell]['size']
        coeffs.append(jnp.zeros((n, M), dtype=x.dtype))
    for ell in range(nLvl):
        if op.leafSel[ell].shape[0]:
            coeffs[ell] = coeffs[ell].at[op.leafPos[ell]].add(
                cLeaf[op.leafSel[ell]])

    for ell in range(nLvl - 1, 0, -1):
        lvl = op.levels[ell]
        up = jnp.einsum('nij,nj->ni', lvl['T'], coeffs[ell])
        coeffs[ell - 1] = coeffs[ell - 1] + jax.ops.segment_sum(
            up, lvl['parentIdx'], num_segments=op.levels[ell - 1]['size'])

    # ---- far field per level (the admissible pair list contains BOTH
    # orders (i,j) and (j,i), so no transpose application is needed)
    out = [jnp.zeros_like(c) for c in coeffs]
    for ell in range(nLvl):
        lvl = op.levels[ell]
        if lvl['K'] is not None:
            contrib = jnp.einsum('pij,pj->pi', lvl['K'], coeffs[ell][lvl['src']])
            out[ell] = out[ell].at[lvl['dst']].add(contrib)

    # ---- sweep down
    for ell in range(1, nLvl):
        lvl = op.levels[ell]
        down = out[ell - 1][lvl['parentIdx']]
        out[ell] = out[ell] + jnp.einsum('nji,nj->ni', lvl['T'], down)

    # ---- gather to leaves and scatter to dofs
    yLeaf = jnp.zeros_like(cLeaf)
    for ell in range(nLvl):
        if op.leafSel[ell].shape[0]:
            yLeaf = yLeaf.at[op.leafSel[ell]].set(
                out[ell][op.leafPos[ell]])

    yvals = jnp.einsum('lnm,lm->ln', op.leafPhi, yLeaf)    # [L, maxLeafN]
    N = op.num_rows

    # ---- near field + tree->global (fused: one segment-sum for both)
    if getattr(op, 'fusedTree', False):
        y2 = op.Anear._matvec_tree(x2)
        y2 = y2.at[:L].add(yvals)
        return op.Anear._scatter_tree(y2)
    flat = jnp.where(op.leafDofs >= 0, op.leafDofs, N).reshape(-1)
    y = jax.ops.segment_sum(yvals.reshape(-1), flat, num_segments=N + 1)[:N]
    y = y + op.Anear.matvec(x)
    return y
