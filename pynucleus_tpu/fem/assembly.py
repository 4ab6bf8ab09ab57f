"""Local FEM assembly: mass, stiffness, RHS as batched einsums.

Counterpart of /root/reference/fem/PyNucleus_fem/femCy.pyx (assembleMatrix,
assembleRHS and the generated mass_*/stiffness_* tables).  Instead of per-cell
C loops with hardcoded element tables, element matrices are computed for ALL
cells at once with einsums over static shape-function tables (matmul-friendly),
then scattered into CSR slots with a segment-sum (the device analogue of the
reference's sparsityPattern.freeze + addToEntry flow).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

import scipy.sparse as sp

from ..config import REAL, INDEX
from ..base.linear_operators import (LinearOperator, CSR_LinearOperator,
                                     Dense_LinearOperator, SSS_LinearOperator)
from .dofmaps import DoFMap, fe_vector
from .quadrature import simplexDuffy

__all__ = ['assembleMass', 'assembleStiffness', 'assembleRHS',
           'assembleSurfaceMass', 'assembleSurfaceRHS',
           'assembleDrift', 'assembleRHSgrad', 'assembleNonlinearity',
           'matrixFreeOperator',
           'assembleSurfaceMass', 'buildSparsityPattern', 'scatterToCSR']


def _geometry(mesh):
    """Simplex volumes and barycentric gradients.
    Returns vol [C], gradLam [C, m+1, dim]."""
    V = mesh.vertices[mesh.cells]              # [C, m+1, dim]
    m = mesh.manifold_dim
    span = V[:, 1:, :] - V[:, :1, :]           # [C, m, dim]
    if m == mesh.dim:
        det = np.linalg.det(span)
        fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
        vol = np.abs(det) * fac
        inv = np.linalg.inv(span)              # [C, dim, m] == inv of span rows
        # x = v0 + xi @ span  =>  dxi/dx = inv(span) with xi row vec:
        # grad xi_k = inv[:, :, k]
        gradLam = np.zeros((V.shape[0], m + 1, mesh.dim))
        gradLam[:, 1:, :] = np.transpose(inv, (0, 2, 1))
        gradLam[:, 0, :] = -gradLam[:, 1:, :].sum(axis=1)
    else:
        G = np.einsum('cid,cjd->cij', span, span)
        det = np.linalg.det(G) if m > 1 else G[:, :, 0]
        fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
        vol = np.sqrt(np.abs(det)).reshape(-1) * fac
        gradLam = None
    return vol, gradLam


def buildSparsityPattern(dm: DoFMap, dm2: DoFMap = None):
    """Sparsity of sum_c outer(dofs_c, dofs_c); returns (csr_pattern, slotIdx)
    where slotIdx [C, dpe, dpe] maps each local contribution to its nnz slot
    (or -1 for dropped boundary rows/cols).  Host-side, built once
    (ref base sparsityPattern.pyx freeze)."""
    dofs1 = dm.dofs
    dofs2 = dofs1 if dm2 is None else dm2.dofs
    C, dpe1 = dofs1.shape
    dpe2 = dofs2.shape[1]
    I = np.repeat(dofs1, dpe2, axis=1).reshape(C, dpe1, dpe2)
    J = np.tile(dofs2, (1, dpe1)).reshape(C, dpe1, dpe2)
    mask = (I >= 0) & (J >= 0)
    rows = I[mask]
    cols = J[mask]
    n1 = dm.num_dofs
    n2 = n1 if dm2 is None else dm2.num_dofs
    # unique (r, c) pairs in lexicographic order == CSR order with sorted
    # per-row indices; 'inverse' gives each contribution its nnz slot.
    key = rows.astype(np.int64) * n2 + cols.astype(np.int64)
    uniq, inverse = np.unique(key, return_inverse=True)
    u_rows = (uniq // n2).astype(INDEX)
    u_cols = (uniq % n2).astype(INDEX)
    indptr = np.zeros(n1 + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr)
    pat = sp.csr_matrix((np.zeros(len(uniq)), u_cols, indptr), shape=(n1, n2))
    slot = np.full((C, dpe1, dpe2), -1, dtype=np.int64)
    slot[mask] = inverse
    return pat, slot


def scatterToCSR(pat, slot, vals, symmetricize=False):
    """vals [C, dpe, dpe] device array -> CSR operator with device data."""
    nnz = pat.indptr[-1]
    flat_slot = jnp.asarray(np.where(slot.reshape(-1) >= 0,
                                     slot.reshape(-1), nnz), dtype=INDEX)
    data = jax.ops.segment_sum(vals.reshape(-1), flat_slot,
                               num_segments=nnz + 1)[:nnz]
    op = CSR_LinearOperator(pat.indices, pat.indptr, data,
                            num_columns=pat.shape[1])
    return op


def assembleMass(dm: DoFMap, coefficient=None, sss_format=False,
                 qOrder=None, dense=False):
    """Mass matrix (ref DoFMaps.assembleMass -> femCy mass tables)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    order = qOrder if qOrder is not None else 2 * p + 2
    bary, w = simplexDuffy(order, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    vol, _ = _geometry(mesh)
    if coefficient is not None:
        # evaluate coefficient at quad points
        V = mesh.vertices[mesh.cells]
        X = np.einsum('qk,ckd->cqd', bary, V)
        cvals = coefficient(X.reshape(-1, mesh.dim)).reshape(X.shape[0], -1)
        Mloc = np.einsum('c,q,cq,iq,jq->cij', vol, w, cvals, PHI, PHI)
    else:
        Mref = np.einsum('q,iq,jq->ij', w, PHI, PHI)
        Mloc = vol[:, None, None] * Mref[None, :, :]
    pat, slot = buildSparsityPattern(dm)
    if dense:
        A = np.zeros((dm.num_dofs, dm.num_dofs))
        d = dm.dofs
        for c in range(mesh.num_cells):
            for i in range(d.shape[1]):
                if d[c, i] < 0:
                    continue
                for j in range(d.shape[1]):
                    if d[c, j] < 0:
                        continue
                    A[d[c, i], d[c, j]] += Mloc[c, i, j]
        return Dense_LinearOperator(jnp.asarray(A))
    return scatterToCSR(pat, slot, jnp.asarray(Mloc))


def assembleStiffness(dm: DoFMap, coefficient=None, qOrder=None):
    """Stiffness matrix int grad(phi_i).grad(phi_j)
    (ref DoFMaps.assembleStiffness -> femCy stiffness tables)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    assert m == mesh.dim, 'stiffness on manifold meshes not supported'
    p = max(dm.polynomialOrder, 1)
    order = qOrder if qOrder is not None else max(2 * (p - 1) + 2, 2)
    bary, w = simplexDuffy(order, m)
    DPHI = dm.evalGradPhi(bary)                # [dpe, Q, m+1]
    vol, gradLam = _geometry(mesh)             # [C], [C, m+1, dim]
    # grad phi_i(x_q) in cell c: sum_k DPHI[i,q,k] gradLam[c,k,:]
    if coefficient is not None:
        V = mesh.vertices[mesh.cells]
        X = np.einsum('qk,ckd->cqd', bary, V)
        cvals = coefficient(X.reshape(-1, mesh.dim)).reshape(X.shape[0], -1)
        Kloc = np.einsum('c,q,cq,iqk,ckd,jql,cld->cij', vol, w, cvals,
                         DPHI, gradLam, DPHI, gradLam, optimize=True)
    else:
        Kloc = np.einsum('c,q,iqk,ckd,jql,cld->cij', vol, w,
                         DPHI, gradLam, DPHI, gradLam, optimize=True)
    pat, slot = buildSparsityPattern(dm)
    return scatterToCSR(pat, slot, jnp.asarray(Kloc))


def assembleRHS(dm: DoFMap, fun, qOrder=None):
    """Load vector b_i = int f phi_i (ref femCy.assembleRHS)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    if qOrder is None:
        # mirror the reference's defaults so cached error values reproduce
        # (ref femCy.pyx:2636-2665: 1D P0/P1->3, P2->5; 2D P0/P1->2, P2->5;
        # 3D P1/P2->3; anything else 2p+2)
        po = dm.polynomialOrder
        if m == 1 and po <= 1:
            qOrder = 3
        elif m == 1 and po == 2:
            qOrder = 5
        elif m == 2 and po <= 1:
            qOrder = 2
        elif m == 2 and po == 2:
            qOrder = 5
        elif m == 3 and po in (1, 2):
            qOrder = 3
        else:
            qOrder = 2 * po + 2
    order = qOrder
    bary, w = simplexDuffy(order, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    vol, _ = _geometry(mesh)
    V = mesh.vertices[mesh.cells]
    X = np.einsum('qk,ckd->cqd', bary, V)      # [C, Q, dim]
    fvals = np.asarray(fun(X.reshape(-1, mesh.dim))).reshape(
        X.shape[0], X.shape[1])
    bloc = np.einsum('c,q,cq,iq->ci', vol, w, fvals, PHI)   # [C, dpe]
    b = np.zeros(dm.num_dofs,
                 dtype=np.complex128 if np.iscomplexobj(fvals) else REAL)
    d = dm.dofs
    mask = d >= 0
    np.add.at(b, d[mask], bloc[mask])
    return fe_vector(jnp.asarray(b), dm)


def assembleDrift(dm: DoFMap, coeff, qOrder=None):
    """Advection matrix D_ij = int (coeff(x) . grad phi_j) phi_i
    (ref DoFMaps.assembleDrift:692 -> femCy assembleDrift)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    assert m == mesh.dim, 'drift on manifold meshes not supported'
    p = max(dm.polynomialOrder, 1)
    order = qOrder if qOrder is not None else 2 * p + 1
    bary, w = simplexDuffy(order, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    DPHI = dm.evalGradPhi(bary)                # [dpe, Q, m+1]
    vol, gradLam = _geometry(mesh)
    V = mesh.vertices[mesh.cells]
    X = np.einsum('qk,ckd->cqd', bary, V)
    cvals = np.asarray(coeff(X.reshape(-1, mesh.dim))).reshape(
        X.shape[0], X.shape[1], mesh.dim)      # [C, Q, dim]
    Dloc = np.einsum('c,q,iq,cqd,jqk,ckd->cij', vol, w, PHI, cvals,
                     DPHI, gradLam, optimize=True)
    pat, slot = buildSparsityPattern(dm)
    return scatterToCSR(pat, slot, jnp.asarray(Dloc))


def assembleRHSgrad(dm: DoFMap, fun, coeff, qOrder=None):
    """Gradient load vector b_i = int f(x) (coeff(x) . grad phi_i)
    (ref DoFMaps.assembleRHSgrad -> femCy assembleGradRHS)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    order = qOrder if qOrder is not None else 2 * p + 1
    bary, w = simplexDuffy(order, m)
    DPHI = dm.evalGradPhi(bary)
    vol, gradLam = _geometry(mesh)
    V = mesh.vertices[mesh.cells]
    X = np.einsum('qk,ckd->cqd', bary, V)
    fvals = np.asarray(fun(X.reshape(-1, mesh.dim))).reshape(
        X.shape[0], X.shape[1])
    cvals = np.asarray(coeff(X.reshape(-1, mesh.dim))).reshape(
        X.shape[0], X.shape[1], mesh.dim)
    bloc = np.einsum('c,q,cq,cqd,iqk,ckd->ci', vol, w, fvals, cvals,
                     DPHI, gradLam, optimize=True)
    b = np.zeros(dm.num_dofs, dtype=REAL)
    d = dm.dofs
    mask = d >= 0
    np.add.at(b, d[mask], bloc[mask])
    return fe_vector(jnp.asarray(b), dm)


def assembleNonlinearity(dm: DoFMap, fun, U, qOrder=None):
    """Project a pointwise nonlinearity onto the FE space:
    b^out_i = int fun(u_1(x), ..., u_k(x))_out phi_i(x) dx
    (ref femCy.assembleNonlinearity:3087; fun is a multi_function
    counterpart: callable [..., numInputs] -> [..., numOutputs]).

    :param U: fe_vector or list of fe_vectors (the k inputs).
    Returns a list of numOutputs fe_vectors (a single fe_vector if the
    function declares numOutputs == 1)."""
    if not isinstance(U, (list, tuple)):
        U = [U]
    mesh = dm.mesh
    m = mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    order = qOrder if qOrder is not None else (3 if m <= 2 else 3)
    bary, w = simplexDuffy(order, m)
    PHI = dm.evalPhi(bary)                       # [dpe, Q]
    vol, _ = _geometry(mesh)
    d = dm.dofs
    mask = d >= 0
    # u_h at quad points per cell: gather dof values (boundary dofs -> 0)
    uq = []
    for u in U:
        uv = np.asarray(u.data if hasattr(u, 'data') else u)
        loc = np.where(mask, uv[np.clip(d, 0, None)], 0.0)   # [C, dpe]
        uq.append(np.einsum('ci,iq->cq', loc, PHI))
    uin = np.stack(uq, axis=-1)                  # [C, Q, k]
    fout = np.asarray(fun(uin))                  # [C, Q, nOut]
    if fout.ndim == 2:
        fout = fout[:, :, None]
    bloc = np.einsum('c,q,cqo,iq->cio', vol, w, fout, PHI)
    out = []
    for o in range(fout.shape[-1]):
        b = np.zeros(dm.num_dofs, dtype=REAL)
        np.add.at(b, d[mask], bloc[..., o][mask])
        out.append(fe_vector(jnp.asarray(b), dm))
    return out[0] if len(out) == 1 else out


class matrixFreeOperator(LinearOperator):
    """Matrix-free mass/stiffness/drift operator: y = A x without
    materializing A (ref femCy.matrixFreeOperator:3403).  The matvec is one
    jitted gather -> per-cell einsum -> segment-sum scatter."""

    def __init__(self, dm: DoFMap, kind='stiffness', coefficient=None,
                 qOrder=None):
        mesh = dm.mesh
        m = mesh.manifold_dim
        p = max(dm.polynomialOrder, 1)
        order = qOrder if qOrder is not None else 2 * p + 2
        bary, w = simplexDuffy(order, m)
        vol, gradLam = _geometry(mesh)
        N = dm.num_dofs
        self.num_rows = self.num_columns = N
        d = dm.dofs
        self._gather = jnp.asarray(np.where(d >= 0, d, N), dtype=INDEX)
        self._scatter = jnp.asarray(np.where(d >= 0, d, N), dtype=INDEX)
        if kind == 'mass':
            PHI = dm.evalPhi(bary)
            Mref = np.einsum('q,iq,jq->ij', w, PHI, PHI)
            Aloc = vol[:, None, None] * Mref[None, :, :]
        elif kind == 'stiffness':
            DPHI = dm.evalGradPhi(bary)
            Aloc = np.einsum('c,q,iqk,ckd,jql,cld->cij', vol, w,
                             DPHI, gradLam, DPHI, gradLam, optimize=True)
        else:
            raise NotImplementedError(kind)
        if coefficient is not None:
            V = mesh.vertices[mesh.cells]
            X = np.einsum('qk,ckd->cqd', bary, V)
            cv = np.asarray(coefficient(
                X.reshape(-1, mesh.dim))).reshape(X.shape[0], -1).mean(axis=1)
            Aloc = Aloc * cv[:, None, None]
        self._Aloc = jnp.asarray(Aloc)

        @jax.jit
        def mv(Aloc, x):
            xpad = jnp.concatenate([x, jnp.zeros(1, dtype=x.dtype)])
            xl = xpad[self._gather]                    # [C, dpe]
            yl = jnp.einsum('cij,cj->ci', Aloc, xl)
            return jax.ops.segment_sum(yl.reshape(-1),
                                       self._scatter.reshape(-1),
                                       num_segments=N + 1)[:N]
        self._mv = mv

    def matvec(self, x):
        return self._mv(self._Aloc, jnp.asarray(x))

    @property
    def diagonal(self):
        dpe = self._Aloc.shape[1]
        N = self.num_rows
        diag = jax.ops.segment_sum(
            jnp.einsum('cii->ci', self._Aloc).reshape(-1),
            self._scatter.reshape(-1), num_segments=N + 1)[:N]
        return diag


def _vertexDofMap(dm):
    # vertex id -> volume dof (interior >= 0; boundary < 0), P1/P2/P3 keep
    # vertex dofs in the leading local slots
    nv = dm.mesh.manifold_dim + 1
    vdof = np.full(dm.mesh.num_vertices, np.iinfo(np.int64).min,
                   dtype=np.int64)
    vdof[dm.mesh.cells[:, :nv].reshape(-1)] = \
        dm.dofs[:, :nv].reshape(-1)
    return vdof


def _boundaryFacets(mesh):
    m = mesh.manifold_dim
    if m == 1:
        return mesh.boundaryVertices.reshape(-1, 1)
    if m == 2:
        return mesh.boundaryEdges
    return mesh.boundaryFaces


def assembleSurfaceMass(dm: DoFMap, facets=None):
    """Boundary mass matrix MB_ij = int_{boundary} phi_i phi_j over the
    physical boundary facets, in VOLUME dof numbering (P1; ref
    femCy.assembleSurfaceMass).  Dense output [N, N]."""
    assert dm.polynomialOrder == 1, 'surface mass implemented for P1'
    mesh = dm.mesh
    m = mesh.manifold_dim
    if facets is None:
        facets = _boundaryFacets(mesh)
    import scipy.sparse as sp
    vdof = _vertexDofMap(dm)
    N = dm.num_dofs
    if m == 1:
        # the boundary of an interval: point masses
        ii = vdof[facets.reshape(-1)]
        ii = ii[ii >= 0]
        return sp.coo_matrix((np.ones(len(ii)), (ii, ii)),
                             shape=(N, N)).tocsr()
    V = mesh.vertices[facets]                     # [F, m, dim]
    if m == 2:
        meas = np.linalg.norm(V[:, 1] - V[:, 0], axis=1)
        loc = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    else:
        e1 = V[:, 1] - V[:, 0]
        e2 = V[:, 2] - V[:, 0]
        meas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        loc = (np.ones((3, 3)) + np.eye(3)) / 12.0
    dr = vdof[facets]                             # [F, m]
    rows, cols, vals = [], [], []
    for a in range(facets.shape[1]):
        for b_ in range(facets.shape[1]):
            r, c = dr[:, a], dr[:, b_]
            keep = (r >= 0) & (c >= 0)
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(meas[keep] * loc[a, b_])
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(N, N)).tocsr()


def assembleSurfaceRHS(dm: DoFMap, fun, facets=None, qOrder=3):
    """Boundary load vector b_i = int_{boundary} g phi_i (P1; complex g
    supported; ref getSurfaceDoFMap + assembleRHS on the surface mesh)."""
    assert dm.polynomialOrder == 1
    mesh = dm.mesh
    m = mesh.manifold_dim
    if facets is None:
        facets = _boundaryFacets(mesh)
    vdof = _vertexDofMap(dm)
    b = np.zeros(dm.num_dofs, dtype=np.complex128)

    def ev(x):
        return complex(np.asarray(fun(x)).ravel()[0])

    if m == 1:
        for v in facets.reshape(-1):
            i = vdof[v]
            if i >= 0:
                b[i] += ev(mesh.vertices[v])
        return b
    from .quadrature import simplexDuffy
    bary, w = simplexDuffy(qOrder, m - 1)         # facet simplex
    V = mesh.vertices[facets]                     # [F, m, dim]
    X = np.einsum('qk,fkd->fqd', bary, V)
    gv = np.asarray([ev(x) for x in X.reshape(-1, mesh.dim)],
                    dtype=np.complex128).reshape(X.shape[0], X.shape[1])
    if m == 2:
        meas = np.linalg.norm(V[:, 1] - V[:, 0], axis=1)
    else:
        meas = 0.5 * np.linalg.norm(np.cross(V[:, 1] - V[:, 0],
                                             V[:, 2] - V[:, 0]), axis=1)
    # P1 facet shape functions = barycentric coordinates
    bloc = np.einsum('f,q,fq,qk->fk', meas, w, gv, bary)
    dr = vdof[facets]
    keep = dr >= 0
    np.add.at(b, dr[keep], bloc[keep])
    return b
