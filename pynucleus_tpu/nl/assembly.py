"""Nonlocal operator assembly: batched panel quadrature on device.

Counterpart of /root/reference/nl/PyNucleus_nl/nonlocalAssembly_{SCALAR}.pxi
(nonlocalBuilder.getDense :1262, IndexManager scatter :8-254) — redesigned for
an accelerator: instead of an O(C^2) Python/Cython loop dispatching per-pair
quadrature, pairs are classified host-side into panel buckets (panels.py),
each bucket is evaluated by ONE fused device kernel

    x    = bary_x^T @ simplex1          (batched gather + einsum)
    y    = bary_y^T @ simplex2
    t    = w * gamma(x, y) * vol        [P, Q]      (elementwise)
    M    = t @ (PSI_I * PSI_J)          [P, nPSI^2] (matmul)
    A   += scatter-add(M, dofRows)

and the results accumulate into the global operator with scatter-adds.
Symmetric pairs (i < j) carry weight 2, matching the reference's
addToMatrixElemElemSym(contrib, 2.) bookkeeping.
"""
from __future__ import annotations

from functools import partial

import os

import numpy as np
import jax
import jax.numpy as jnp

import scipy.sparse as sp

from ..config import REAL, INDEX, COMPLEX, toDevice as _jd
from ..base.linear_operators import Dense_LinearOperator, CSR_LinearOperator
from .panels import (classifyPairsDense, classifyBoundaryPairs,
                     permuteLocalDofs, _sharedPermFromEq)
from .quad_singular import (sameCellRule1D, vertexRule1D, distantRule,
                            boundaryVertexRule1D, boundaryDistantRule)

__all__ = ['assembleNonlocal', 'nonlocalBuilder']

# sentinel for 'dropped' local entries; boundary dofs are encoded -dof-1, so
# -1 is a REAL boundary dof and must not be used as a drop marker
DROP = np.iinfo(np.int32).min // 2

MAX_PAIRS_PER_LAUNCH = 1 << 18

# Cap on the per-scan-step chunk: XLA compile time of the bucket kernels
# grows super-linearly in the chunk while steady-state throughput is
# chunk-insensitive (the scan trip count absorbs the pair-stream growth).
# Small fixed chunks bound the per-mesh-size compile bill.  The value was
# chosen on the previous accelerator and awaits an H100 measurement.
CHUNK_CAP = int(os.environ.get('PYNUCLEUS_TPU_CHUNK_CAP', 8192))


def _radial_eval(kernel, r2, x=None, y=None):
    """gamma evaluated NaN-safe at r2=0 (padding).  Variable-order kernels
    evaluate s(x, y) and the pointwise normalization on device."""
    r2safe = jnp.where(r2 > 0, r2, 1.0)
    if x is not None and hasattr(kernel, 'evalXY'):
        val = kernel.evalXY(x, y, r2safe)
        if getattr(kernel, 'phiJax', None) is not None:
            # smooth two-point weights evaluate per quadrature point
            val = val * kernel.phiJax(x, y)
    else:
        val = kernel._radialJax(r2safe)
    return jnp.where(r2 > 0, val, 0.0)


def _log_extra_scalar(kernel, r2, x, y, lnEta, cw1, cw2):
    """Per-node log-correction term for s-derivative kernels on singular
    rules: cw1 (b + 2 c lnR) + cw2 c with (b, c) the ln r / ln^2 r
    coefficients and lnR = ln r - lnEta smooth (see PanelRule docstring)."""
    r2safe = jnp.where(r2 > 0, r2, 1.0)
    b, c = kernel.evalLogCoeffsJax(x, y, r2safe)
    ok = (r2 > 0)
    if b.ndim == r2.ndim + 1:          # vector-valued [..., V]
        ok = ok[..., None]
        lnR = (0.5 * jnp.log(r2safe) - lnEta[None, :])[..., None]
        cw1 = cw1[None, :, None]
        cw2 = cw2[None, :, None]
    else:
        lnR = 0.5 * jnp.log(r2safe) - lnEta[None, :]
        cw1 = cw1[None, :]
        cw2 = cw2[None, :]
    b = jnp.where(ok, b, 0.0)
    c = jnp.where(ok, c, 0.0)
    return cw1 * (b + 2.0 * c * lnR) + cw2 * c


@partial(jax.jit, static_argnames=('kernel', 'useNormals', 'useYShift',
                                   'useLogCorr'))
def _bucket_contrib(vertices, vertIdx1, vertIdx2, volsym,
                    bary_x, bary_y, w, PSIP,
                    normals=None, kernel=None, useNormals=False,
                    yShift=None, useYShift=False,
                    lnEta=None, cw1=None, cw2=None, useLogCorr=False):
    """One panel bucket -> local pair matrices M [P, nPSI^2].

    yShift [P, dim] nudges the y evaluation points (surface integrals of
    variable-order kernels select the fractional-order side of a jump
    interface this way; ref evalShift nonlocalAssembly pxi:1683,2014-2060).

    This kernel is independent of the global operator size, so it compiles
    once per (panel shape, kernel) and is reused across hierarchy levels."""
    v1 = vertices[vertIdx1]                       # [P, nv1, dim]
    v2 = vertices[vertIdx2]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)     # [P, Q, dim]
    y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
    if useYShift:
        y = y + yShift[:, None, :]
    r2 = jnp.sum((x - y) ** 2, axis=-1)
    g = _radial_eval(kernel, r2, x, y)
    t = g * w[None, :]
    if useLogCorr:
        t = t + _log_extra_scalar(kernel, r2, x, y, lnEta, cw1, cw2)
    if kernel.finiteHorizon or kernel.complement:
        ind = kernel.interaction.jaxIndicator(x, y, kernel.horizonValue ** 2)
        t = t * ind
    if useNormals:
        # boundary kernels carry n.(y-x)/|y-x| (outward normal at y on the
        # surface element; ref fractionalLaplacian1D.pyx:736-749 and the 2D
        # eval_distant_boundary)
        rsafe = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
        fac = jnp.einsum('pd,pqd->pq', normals, y - x) / rsafe
        t = t * jnp.where(r2 > 0, fac, 0.0)
    t = t * volsym[:, None]                       # [P, Q]
    return t @ PSIP                               # [P, nPSI*nPSI]


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=('kernel', 'nTiles', 'Ct'))
def _grid_distant_pass(A, X, Y, ccf, vols, rowDofPad, incRows,
                       PhiXw, PhiX, PhiY, PsiYw, w1, w2, t_lo, t_hi,
                       kernel=None, nTiles=None, Ct=None):
    """Scatter-free dense assembly of one distance window of distant pairs.

    The per-pair gather/scatter of the bucket path is replaced by a CELL-PAIR
    GRID: a lax.scan over row tiles of the full C x C grid evaluates the
    kernel on the tensor quadrature (Q1 x-points vs Q2 y-points, all
    broadcast — no index gathers), contracts over quadrature with batched
    matmuls, and reduces to dofs with ONE row-granular segment-sum per
    tile.  This is the device replacement for the reference's O(C^2)
    per-pair Cython loop (nonlocalAssembly_{SCALAR}.pxi:1387-1450).

    Pair selection: ordered pair (c1, c2) is handled iff
    t_lo <= d2(c1,c2) < t_hi, with d2 the squared cell-center distance
    computed IN FLOAT32 with a fixed expression replicated on the host;
    thresholds are gap midpoints between realized d2 values, so host and
    device partition the pairs identically despite FMA rounding.

    Per ordered pair the symmetric local 2dpe x 2dpe matrix decomposes as
      xx-diag (rows c1), yy-diag (rows c2): grid row/column reductions;
      cross block (factor 2; the transposed ordering supplies the other
      cross position): a [dpe, Q1] x [Q1, Q2] x [Q2, dpe] contraction.

    A [N+1, N+1] donated; X [C, Q1, dim], Y [C, Q2, dim] quadrature points;
    ccf [C, dim] float32 centers; rowDofPad [C, dpe] (boundary -> N);
    incRows [N+1, K] flat (cell, local-dof) incidences of each column dof
    (pad/dump = C*dpe); PhiXw = phi(x-pts) * w1, PsiYw = -phi(y-pts) * w2.

    The column reduction (C*dpe cell-dof columns -> N dof columns) runs as K
    row-GATHERS over the incidence table instead of a segment-sum, so no
    scatter-add sees duplicate indices.

    Layout: every large intermediate keeps a LARGE trailing dimension, and
    no reshape/transpose splits or moves it.  The tile is computed Y-MAJOR
    with the x side flattened to mW = Ct*Q1: the gather target [C, dpe, mW]
    indexes leading axes only, and the x-side dof contraction is a
    block-diagonal [mW, Ct*dpe] matmul (kron(I, PhiXw^T), Ct times the
    needed multiply work) instead of a reshape to [..., Ct, Q1].  These
    choices were shaped for the previous accelerator's tiled layout; on the
    H100 they are correct but await measurement against a plain
    einsum + segment-sum form."""
    N = A.shape[0] - 1
    C, Q1, dim = X.shape
    Q2 = Y.shape[1]
    dpe = PhiX.shape[0]
    mW = Ct * Q1
    # x-side dof contraction as block-diag matmul (see docstring)
    Wq = jnp.kron(jnp.eye(Ct, dtype=A.dtype), PhiXw.T)     # [mW, Ct*dpe]
    w1F = jnp.tile(w1, Ct)                                 # [mW]
    incSafe = jnp.clip(incRows, 0, C * dpe - 1)
    incCell = incSafe // dpe
    incLoc = incSafe % dpe
    incOk = incRows < C * dpe

    def body(carry, t):
        A, Bxx, Byy = carry
        rows = t * Ct + jnp.arange(Ct)
        valid = rows < C
        rc = jnp.clip(rows, 0, C - 1)
        XtF = X[rc].reshape(mW, dim)
        c1 = ccf[rc]
        d2 = None
        for d in range(dim):
            dd = ccf[:, d][:, None] - c1[:, d][None, :]
            d2 = dd * dd if d2 is None else d2 + dd * dd   # [C, Ct]
        m = (d2 >= t_lo) & (d2 < t_hi) & valid[None, :]
        mF = jnp.repeat(m, Q1, axis=1)                     # [C, mW]
        r2 = None
        for d in range(dim):
            dd = Y[:, :, None, d] - XtF[None, None, :, d]
            r2 = dd * dd if r2 is None else r2 + dd * dd   # [C, Q2, mW]
        g = _radial_eval(kernel, r2)
        vol1 = jnp.where(valid, vols[rc], 0.0)
        volF = jnp.repeat(vol1, Q1)                        # [mW]
        G = jnp.where(mF[:, None, :], g, 0.0) \
            * (vols[:, None, None] * volF[None, None, :])  # [C, Q2, mW]
        # ---- y-side dof contraction (gather-ready: leading-axis indexing)
        GvT = jnp.einsum('yrm,br->ybm', G, PsiYw)          # [C, dpe, mW]
        # ---- diag blocks via row/column reductions
        Rx = jnp.einsum('yrm,r->m', G, w2).reshape(Ct, Q1)
        Bxx = Bxx.at[rc].add(jnp.einsum('aq,bq,xq->xab', PhiXw, PhiX, Rx)
                             * valid[:, None, None])
        Sy = jnp.einsum('yrm,m->yr', G, w1F)               # [C, Q2]
        Byy = Byy + jnp.einsum('ar,br,yr->yab', PhiY * w2[None, :], PhiY, Sy)
        # ---- cross into A: incidence row-gathers + row-granular scatter
        gathered = GvT[incCell, incLoc]                    # [N+1, K, mW]
        gathered = jnp.where(incOk[:, :, None], gathered, 0.0)
        colGv = gathered.sum(axis=1)                       # [N+1, mW]
        colredT = 2.0 * jnp.einsum('mw,nm->wn', Wq, colGv)  # [Ct*dpe, N+1]
        rowD = jnp.where(rowDofPad[rc] >= 0, rowDofPad[rc], N).reshape(-1)
        rowD = jnp.where(jnp.repeat(valid, dpe), rowD, N)
        A = A.at[rowD].add(colredT)
        return (A, Bxx, Byy), None

    Bxx = jnp.zeros((C, dpe, dpe), dtype=A.dtype)
    Byy = jnp.zeros((C, dpe, dpe), dtype=A.dtype)
    (A, Bxx, Byy), _ = jax.lax.scan(body, (A, Bxx, Byy),
                                    jnp.arange(nTiles))
    # diagonal blocks: scatter C*dpe^2 values once
    rAll = jnp.where(rowDofPad >= 0, rowDofPad, N)         # [C, dpe]
    rb = jnp.broadcast_to(rAll[:, :, None], (C, dpe, dpe)).reshape(-1)
    cb = jnp.broadcast_to(rAll[:, None, :], (C, dpe, dpe)).reshape(-1)
    A = A.at[rb, cb].add((Bxx + Byy).reshape(-1))
    return A


@partial(jax.jit, static_argnames=('kernel', 'nTiles', 'Ct', 'useNormals',
                                   'maskIn', 'dtype'))
def _grid_boundary_blocks(X, Ysurf, svolw2, vols, normals,
                          PhiXw, PhiX, w1, maskRow, maskCol,
                          kernel=None, nTiles=None, Ct=None,
                          useNormals=False, maskIn=False, dtype=None):
    """Scatter-free zeroExterior (Gauss-theorem surface) assembly: the
    boundary term only contributes (dof_i x dof_i) diagonal blocks, so on
    the (cell x surface-cell) grid the surface axis is a pure reduction —
    contributions never scatter (cf. the per-pair loop it replaces,
    ref nonlocalAssembly pxi:1430-1448 zeroExterior).  Returns the per-cell
    blocks [C, dpe, dpe]; the caller scatters them into its accumulator
    (dense device scatter, or C*dpe^2 CSR slot adds for the H2 near field).

    X [C, Q1, dim] cell quadrature points; Ysurf [S, Q2, dim] surface
    points; svolw2 [S, Q2] = surfaceVol * w2; normals [S, dim];
    maskRow/maskCol [nTiles, maxM]: per-tile pair lists (local row, surface
    col; pad -1) EXCLUDED from the grid (maskIn=False) or the only ones
    INCLUDED (maskIn=True)."""
    C, Q1, dim = X.shape
    S, Q2, _ = Ysurf.shape
    dpe = PhiX.shape[0]
    # flat surface axis (mS = S*Q2): keeps the trailing dimension large
    # (see _grid_distant_pass layout rule)
    mS = S * Q2
    YsurfF = Ysurf.reshape(mS, dim)
    svolw2F = svolw2.reshape(mS)
    normalsF = jnp.repeat(normals, Q2, axis=0)        # [mS, dim]

    def body(carry, xs):
        Bxx, = carry
        t, mr, mc = xs
        rows = t * Ct + jnp.arange(Ct)
        valid = rows < C
        rc = jnp.clip(rows, 0, C - 1)
        Xt = X[rc]
        ok = mr >= 0
        marks = jnp.zeros((Ct + 1, S), dtype=jnp.int32)
        marks = marks.at[jnp.where(ok, mr, Ct),
                         jnp.clip(mc, 0, S - 1)].add(1)
        marked = marks[:Ct] > 0
        m = (marked if maskIn else ~marked) & valid[:, None]
        mF = jnp.repeat(m, Q2, axis=1)                # [Ct, mS]
        dd = Xt[:, :, None, :] - YsurfF[None, None, :, :]
        r2 = jnp.sum(dd * dd, axis=-1)                # [Ct, Q1, mS]
        g = _radial_eval(kernel, r2)
        if useNormals:
            rsafe = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
            fac = jnp.einsum('md,xqmd->xqm', normalsF, -dd) / rsafe
            g = g * jnp.where(r2 > 0, fac, 0.0)
        vol1 = jnp.where(valid, vols[rc], 0.0)
        G = jnp.where(mF[:, None, :], g, 0.0) \
            * vol1[:, None, None]
        R = jnp.einsum('xqm,m->xq', G, svolw2F)       # [Ct, Q1]
        Bxx = Bxx.at[rc].add(jnp.einsum('aq,bq,xq->xab', PhiXw, PhiX, R)
                             * valid[:, None, None])
        return (Bxx,), None

    Bxx = jnp.zeros((C, dpe, dpe), dtype=dtype)
    (Bxx,), _ = jax.lax.scan(body, (Bxx,),
                             (jnp.arange(nTiles), maskRow, maskCol))
    return Bxx


@partial(jax.jit, donate_argnums=(0,))
def _scatter_cell_blocks(A, rowDofPad, Bxx):
    """Dense scatter of per-cell diagonal blocks [C, dpe, dpe]."""
    N = A.shape[0] - 1
    C, dpe, _ = Bxx.shape
    rAll = jnp.where(rowDofPad >= 0, rowDofPad, N)
    rb = jnp.broadcast_to(rAll[:, :, None], (C, dpe, dpe)).reshape(-1)
    cb = jnp.broadcast_to(rAll[:, None, :], (C, dpe, dpe)).reshape(-1)
    return A.at[rb, cb].add(Bxx.reshape(-1))


@partial(jax.jit, static_argnames=('kernel', 'nPSI', 'useNormals'),
         donate_argnums=(0,))
def _bucket_rows_scatter_scan(A, vertices, vi1, vi2, dr, vs, nm,
                              bary_x, bary_y, w, PSIP,
                              kernel=None, nPSI=None, useNormals=False):
    """Explicit-pair bucket in ONE device launch (lax.scan over pre-chunked
    [nChunks, chunk, ...] arrays) instead of one host-driven launch per
    chunk for the boundary (zeroExterior) distant bucket."""
    N = A.shape[0] - 1

    def body(Acc, chunk):
        v1i, v2i, drc, vsc, nmc = chunk
        v1 = vertices[v1i]
        v2 = vertices[v2i]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        if kernel.finiteHorizon or kernel.complement:
            g = g * kernel.interaction.jaxIndicator(
                x, y, kernel.horizonValue ** 2)
        if useNormals:
            rsafe = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
            fac = jnp.einsum('pd,pqd->pq', nmc, y - x) / rsafe
            g = g * jnp.where(r2 > 0, fac, 0.0)
        t = (g * w[None, :]) * vsc[:, None]
        M = t @ PSIP
        rows = jnp.where(drc >= 0, drc, N)
        P = rows.shape[0]
        rb = jnp.broadcast_to(rows[:, :, None], (P, nPSI, nPSI)).reshape(-1)
        cb = jnp.broadcast_to(rows[:, None, :], (P, nPSI, nPSI)).reshape(-1)
        return Acc.at[rb, cb].add(M.reshape(-1)), None

    A, _ = jax.lax.scan(body, A, (vi1, vi2, dr, vs, nm))
    return A


@partial(jax.jit, static_argnames=('kernel', 'nPSI'),
         donate_argnums=(0,))
def _bucket_natural_scatter_scan(A, vertices, cellsArr, dofsArr, volsArr,
                                 di, dj, symfac, bary_x, bary_y, w, PSIP,
                                 kernel=None, nPSI=None):
    """Whole bucket in ONE device launch: di/dj/symfac arrive pre-chunked
    [nChunks, chunkP] and a lax.scan walks the chunks on device, replacing
    a chunked host loop (256 launches at 1M-dof scale).  Whether one launch
    per bucket pays on the H100 is not yet measured."""
    N = A.shape[0] - 1
    dpe = dofsArr.shape[1]

    def body(Acc, chunk):
        dic, djc, sfc = chunk
        v1 = vertices[cellsArr[dic]]
        v2 = vertices[cellsArr[djc]]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        if kernel.finiteHorizon or kernel.complement:
            g = g * kernel.interaction.jaxIndicator(
                x, y, kernel.horizonValue ** 2)
        vols = volsArr[dic] * volsArr[djc] * sfc
        t = (g * w[None, :]) * vols[:, None]
        M = t @ PSIP
        if nPSI == dpe:
            dr = dofsArr[dic]
        else:
            dr = jnp.concatenate([dofsArr[dic], dofsArr[djc]], axis=1)
        rows = jnp.where(dr >= 0, dr, N)
        P = rows.shape[0]
        rb = jnp.broadcast_to(rows[:, :, None], (P, nPSI, nPSI)).reshape(-1)
        cb = jnp.broadcast_to(rows[:, None, :], (P, nPSI, nPSI)).reshape(-1)
        return Acc.at[rb, cb].add(M.reshape(-1)), None

    A, _ = jax.lax.scan(body, A, (di, dj, symfac))
    return A


@partial(jax.jit, static_argnames=('kernel', 'nPSI'),
         donate_argnums=(0,))
def _bucket_natural_scatter(A, vertices, cellsArr, dofsArr, volsArr,
                            di, dj, symfac, bary_x, bary_y, w, PSIP,
                            kernel=None, nPSI=None):
    # Fused distant/id bucket for NATURALLY-ORDERED pairs: gathers geometry
    # on device (only pair indices cross the host-device link), evaluates the
    # panel quadrature, and scatter-adds into the dense accumulator.  One
    # device call per chunk.
    N = A.shape[0] - 1
    v1 = vertices[cellsArr[di]]
    v2 = vertices[cellsArr[dj]]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
    y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
    r2 = jnp.sum((x - y) ** 2, axis=-1)
    g = _radial_eval(kernel, r2, x, y)
    if kernel.finiteHorizon or kernel.complement:
        g = g * kernel.interaction.jaxIndicator(x, y, kernel.horizonValue ** 2)
    vols = volsArr[di] * volsArr[dj] * symfac
    t = (g * w[None, :]) * vols[:, None]
    M = t @ PSIP                                   # [P, nPSI^2]
    dpe = dofsArr.shape[1]
    if nPSI == dpe:
        dr = dofsArr[di]
    else:
        dr = jnp.concatenate([dofsArr[di], dofsArr[dj]], axis=1)
    rows = jnp.where(dr >= 0, dr, N)
    P = rows.shape[0]
    rb = jnp.broadcast_to(rows[:, :, None], (P, nPSI, nPSI)).reshape(-1)
    cb = jnp.broadcast_to(rows[:, None, :], (P, nPSI, nPSI)).reshape(-1)
    return A.at[rb, cb].add(M.reshape(-1))


@partial(jax.jit, static_argnames=('kernel', 'useLogCorr'))
def _bucket_contrib_nonsym(vertices, vertIdx1, vertIdx2, volsym,
                           bary_x, bary_y, w, PHIxPSI, PHIyPSI, kernel=None,
                           lnEta=None, cw1=None, cw2=None, useLogCorr=False):
    """Nonsymmetric local matrices (ref fractionalLaplacian1D_nonsym eval
    :549-603): M = t1 @ (PHIx_I PSI_J) - t2 @ (PHIy_I PSI_J) with
    t1 = w gamma(x,y) vol, t2 = w gamma(y,x) vol."""
    v1 = vertices[vertIdx1]
    v2 = vertices[vertIdx2]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
    y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
    r2 = jnp.sum((x - y) ** 2, axis=-1)
    t1 = _radial_eval(kernel, r2, x, y) * w[None, :]
    t2 = _radial_eval(kernel, r2, y, x) * w[None, :]
    if useLogCorr:
        t1 = t1 + _log_extra_scalar(kernel, r2, x, y, lnEta, cw1, cw2)
        t2 = t2 + _log_extra_scalar(kernel, r2, y, x, lnEta, cw1, cw2)
    if kernel.finiteHorizon or kernel.complement:
        ind = kernel.interaction.jaxIndicator(x, y, kernel.horizonValue ** 2)
        t1 = t1 * ind
        t2 = t2 * ind
    t1 = t1 * volsym[:, None]
    t2 = t2 * volsym[:, None]
    return t1 @ PHIxPSI - t2 @ PHIyPSI


def _vec_eval(kernel, r2, x, y):
    """All valueSize components, NaN-safe at r2=0 (padding)."""
    r2safe = jnp.where(r2 > 0, r2, 1.0)
    val = kernel.evalComponentsJax(x, y, r2safe)
    return jnp.where((r2 > 0)[..., None], val, 0.0)


@partial(jax.jit, static_argnames=('kernel', 'useNormals', 'useLogCorr'))
def _bucket_contrib_vec(vertices, vertIdx1, vertIdx2, volsym,
                        bary_x, bary_y, w, PSIP,
                        normals=None, kernel=None, useNormals=False,
                        lnEta=None, cw1=None, cw2=None, useLogCorr=False):
    """Vector-valued local pair matrices [P, nPSI^2, V]: ONE quadrature
    pass evaluates every component (ref IndexManagerVector scatter loops,
    nonlocalAssembly pxi; kernelsCy.pyx eval :1911 fills vec[valueSize])."""
    v1 = vertices[vertIdx1]
    v2 = vertices[vertIdx2]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
    y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
    r2 = jnp.sum((x - y) ** 2, axis=-1)
    t = _vec_eval(kernel, r2, x, y) * w[None, :, None]    # [P, Q, V]
    if useLogCorr:
        t = t + _log_extra_scalar(kernel, r2, x, y, lnEta, cw1, cw2)
    if kernel.finiteHorizon or kernel.complement:
        ind = kernel.interaction.jaxIndicator(x, y, kernel.horizonValue ** 2)
        t = t * ind[..., None]
    if useNormals:
        rsafe = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
        fac = jnp.einsum('pd,pqd->pq', normals, y - x) / rsafe
        t = t * jnp.where(r2 > 0, fac, 0.0)[..., None]
    t = t * volsym[:, None, None]
    return jnp.einsum('pqv,qm->pmv', t, PSIP)     # [P, nPSI^2, V]


@partial(jax.jit, static_argnames=('kernel', 'useLogCorr'))
def _bucket_contrib_nonsym_vec(vertices, vertIdx1, vertIdx2, volsym,
                               bary_x, bary_y, w, PHIxPSI, PHIyPSI,
                               kernel=None, lnEta=None, cw1=None, cw2=None,
                               useLogCorr=False):
    """Nonsymmetric vector local matrices (the vector analogue of
    _bucket_contrib_nonsym)."""
    v1 = vertices[vertIdx1]
    v2 = vertices[vertIdx2]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
    y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
    r2 = jnp.sum((x - y) ** 2, axis=-1)
    t1 = _vec_eval(kernel, r2, x, y) * w[None, :, None]
    t2 = _vec_eval(kernel, r2, y, x) * w[None, :, None]
    if useLogCorr:
        t1 = t1 + _log_extra_scalar(kernel, r2, x, y, lnEta, cw1, cw2)
        t2 = t2 + _log_extra_scalar(kernel, r2, y, x, lnEta, cw1, cw2)
    if kernel.finiteHorizon or kernel.complement:
        ind = kernel.interaction.jaxIndicator(x, y, kernel.horizonValue ** 2)
        t1 = t1 * ind[..., None]
        t2 = t2 * ind[..., None]
    t1 = t1 * volsym[:, None, None]
    t2 = t2 * volsym[:, None, None]
    return jnp.einsum('pqv,qm->pmv', t1, PHIxPSI) \
        - jnp.einsum('pqv,qm->pmv', t2, PHIyPSI)


@partial(jax.jit, static_argnames=('kernel', 'dpe'))
def _bucket_cut2d_polar(vertices, vi1, vi2, vols1, bary_x, wx,
                        thetas, wtheta, rq, wr, exps, Vinv,
                        horizon, kernel=None, dpe=None):
    """2D pairs cut by the L2 horizon ball: EXACT geometric clipping.

    For each x quadrature point of cell1, the y-integral over
    cell2 n B(x, delta) is taken in polar coordinates around x: the angular
    Gauss rule is mapped onto the window subtended by cell2 from x (the
    integrand vanishes continuously at the window ends), and per angle the
    ray's entry/exit distances through the (convex) triangle are solved
    exactly with the radial Gauss rule mapped onto
    [r_in, min(r_out, delta)].  Smooth integrand, no indicator jump
    (replaces the reference's chord sub-triangulation,
    interactionDomains.pyx startLoopSubSimplices_*; fully batched here).

    `thetas`/`wtheta` are gauss01 nodes/weights on [0, 1].

    Returns M [P, (2 dpe)^2] local pair matrices (x-cell dofs first).
    """
    v1 = vertices[vi1]                             # [P, 3, 2]
    v2 = vertices[vi2]
    x = jnp.einsum('pvd,vq->pqd', v1, bary_x)      # [P, Qx, 2]
    # shape functions of cell1 at x (static table)
    mono1 = jnp.prod(bary_x.T[:, None, :] ** exps[None, :, :], axis=-1)
    PHI1 = (mono1 @ Vinv).T                        # [dpe, Qx]

    # angular window of cell2 seen from x: vertex angles recentred around
    # the centroid direction (x is outside the triangle -> window < pi)
    cen = v2.mean(axis=1)                           # [P, 2]
    relC = cen[:, None, :] - x                      # [P, Qx, 2]
    angC = jnp.arctan2(relC[..., 1], relC[..., 0])  # [P, Qx]
    relV = v2[:, None, :, :] - x[:, :, None, :]     # [P, Qx, 3, 2]
    angV = jnp.arctan2(relV[..., 1], relV[..., 0])
    dAng = jnp.mod(angV - angC[..., None] + np.pi, 2 * np.pi) - np.pi
    thLo = angC + dAng.min(axis=-1)                 # [P, Qx]
    thHi = angC + dAng.max(axis=-1)
    # the radial limit rHi(theta) = min(t_out(theta), rBall(theta)) has
    # KINKS at the triangle vertex directions (t_out) and at the corner
    # directions of non-smooth norm balls (Linf/L1); Gauss across a kink
    # converges only algebraically.  Split the window at every candidate
    # kink so each angular segment is smooth (spectral per segment).
    cand = [angC[..., None] + dAng]                 # in [thLo, thHi]
    inter0 = getattr(kernel, 'interaction', None)
    cornerAngs = {'ballInf': (0.25, 0.75, 1.25, 1.75),
                  'ball1': (0.0, 0.5, 1.0, 1.5)}.get(
                      type(inter0).__name__ if inter0 is not None else '',
                      ())
    for om in cornerAngs:
        rec = angC + jnp.mod(om * np.pi - angC + np.pi,
                             2 * np.pi) - np.pi
        cand.append(rec[..., None])
    cands = jnp.clip(jnp.concatenate(cand, axis=-1),
                     thLo[..., None], thHi[..., None])
    bnds = jnp.sort(jnp.concatenate(
        [thLo[..., None], cands, thHi[..., None]], axis=-1))  # [P,Qx,S+1]
    seg = bnds[..., 1:] - bnds[..., :-1]                      # [P,Qx,S]
    th = (bnds[..., :-1, None] + seg[..., None] * thetas)
    wth = seg[..., None] * wtheta
    S = th.shape[-2]
    th = th.reshape(th.shape[:-2] + (S * th.shape[-1],))      # [P,Qx,S*Qt]
    wth = wth.reshape(th.shape)
    d = jnp.stack([jnp.cos(th), jnp.sin(th)], axis=-1)        # [P,Qx,Qt,2]

    # ray-edge intersections: edges (a, b) of cell2
    A_ = v2                                        # [P, 3, 2]
    B_ = jnp.roll(v2, -1, axis=1)
    E = B_ - A_                                    # [P, 3, 2]
    # solve x + t d = a + u e per (P, Qx, Qt, edge)
    ax = A_[:, None, None, :, :] - x[:, :, None, None, :]   # [P,Qx,Qt,3,2]
    dd = d[:, :, :, None, :]
    ee = E[:, None, None, :, :]
    denom = dd[..., 0] * ee[..., 1] - dd[..., 1] * ee[..., 0]
    safe = jnp.where(jnp.abs(denom) > 1e-14, denom, 1.0)
    t = (ax[..., 0] * ee[..., 1] - ax[..., 1] * ee[..., 0]) / safe
    u = (ax[..., 0] * dd[..., 1] - ax[..., 1] * dd[..., 0]) / safe
    valid = (jnp.abs(denom) > 1e-14) & (u >= -1e-12) & (u <= 1 + 1e-12) \
        & (t > 0)
    tIn = jnp.min(jnp.where(valid, t, np.inf), axis=-1)     # [P, Qx, Qt]
    tOut = jnp.max(jnp.where(valid, t, -np.inf), axis=-1)
    hits = valid.sum(axis=-1) >= 2
    # exact radial clip against the interaction ball: every supported
    # domain is a norm ball, so the ray exits it at horizon / ||d||
    # (L2: 1, Linf: max|d_i|, L1: sum|d_i|, ellipse: |T d|)
    inter = getattr(kernel, 'interaction', None)
    dNorm = inter.jaxDirNorm(d) if inter is not None else 1.0
    rBall = horizon / jnp.maximum(dNorm, 1e-30)
    rLo = jnp.where(hits, tIn, 0.0)
    rHi = jnp.where(hits, jnp.minimum(tOut, rBall), 0.0)
    rHi = jnp.maximum(rHi, rLo)

    # radial rule mapped to [rLo, rHi]
    r = rLo[..., None] + (rHi - rLo)[..., None] * rq        # [P,Qx,Qt,Qr]
    wrad = (rHi - rLo)[..., None] * wr                      # scaled weights
    y = x[:, :, None, None, :] + r[..., None] * d[:, :, :, None, :]

    r2 = r ** 2
    g = _radial_eval(kernel, r2, x[:, :, None, None, :], y)

    # cell2 barycentric coords of y (affine inverse per pair)
    span = jnp.stack([v2[:, 1] - v2[:, 0], v2[:, 2] - v2[:, 0]], axis=2)
    det = span[:, 0, 0] * span[:, 1, 1] - span[:, 0, 1] * span[:, 1, 0]
    inv = jnp.stack([
        jnp.stack([span[:, 1, 1], -span[:, 0, 1]], axis=1),
        jnp.stack([-span[:, 1, 0], span[:, 0, 0]], axis=1)], axis=1) \
        / det[:, None, None]
    rel = y - v2[:, None, None, None, 0, :]
    xi = jnp.einsum('pqtrd,ped->pqtre', rel, inv)
    bary2 = jnp.concatenate([1.0 - xi.sum(-1, keepdims=True), xi], axis=-1)
    # clipped rays keep y inside cell2 up to roundoff, but a pow lowered as
    # exp(e*log(b)) gives NaN for non-positive barycentrics even at e=0
    # (the exponent table is a traced argument and log(b<=0) is nan/-inf);
    # clamp to a tiny positive floor
    bary2 = jnp.clip(bary2, 1e-30, 1.0)
    mono2 = jnp.prod(bary2[..., None, :] ** exps[None, None, None, None, :, :],
                     axis=-1)
    PHI2 = jnp.einsum('pqtrm,mk->pqtrk', mono2, Vinv)       # [...,dpe]

    # weights: wx (volume rule, sum 1 -> scale by 2*vol1) x wth x wrad x r
    W = (g * r * wrad) * wth[..., None]
    W = W * wx[None, :, None, None]
    # local matrix: Psi_k = [phi1_k(x); -phi2_k(y)]
    # blocks: (1,1): sum W phi1_i phi1_j ; (1,2): -sum W phi1_i phi2_j ; etc
    s11 = jnp.einsum('pqtr,iq,jq->pij', W, PHI1, PHI1)
    s12 = -jnp.einsum('pqtr,iq,pqtrj->pij', W, PHI1, PHI2)
    s22 = jnp.einsum('pqtr,pqtri,pqtrj->pij', W, PHI2, PHI2)
    M = jnp.concatenate([
        jnp.concatenate([s11, s12], axis=2),
        jnp.concatenate([jnp.swapaxes(s12, 1, 2), s22], axis=2)], axis=1)
    M = M * (2.0 * vols1)[:, None, None]
    return M.reshape(M.shape[0], -1)


@partial(jax.jit, static_argnames=('kernel', 'dpe'))
def _bucket_cut1d(vertices, vi1, vi2, vols1, tq, wq, ur, wr,
                  exps, Vinv, horizon, kernel=None, dpe=None):
    # 1D horizon-cut pairs by EXACT interval clipping (the 1D analogue of
    # the reference's retriangulation mode, interactionDomains.pyx
    # ball2_retriangulation): for each x-node the y-integration runs over
    # K2 intersect [x-horizon, x+horizon].  Shape functions at the
    # transformed y-nodes are evaluated on device.  M [P, (2*dpe)^2].
    v10 = vertices[vi1[:, 0], 0]
    v11 = vertices[vi1[:, 1], 0]
    v20 = vertices[vi2[:, 0], 0]
    v21 = vertices[vi2[:, 1], 0]
    x = v10[:, None] + tq[None, :] * (v11 - v10)[:, None]        # [P, Qx]
    lo2 = jnp.minimum(v20, v21)
    hi2 = jnp.maximum(v20, v21)
    lo = jnp.maximum(lo2[:, None], x - horizon)                  # [P, Qx]
    hi = jnp.minimum(hi2[:, None], x + horizon)
    ln = jnp.maximum(hi - lo, 0.0)                               # [P, Qx]
    y = lo[:, :, None] + ur[None, None, :] * ln[:, :, None]      # [P, Qx, Qy]
    bx = jnp.stack([1 - tq, tq], axis=-1)                        # [Qx, 2]
    monoX = jnp.prod(bx[:, None, :] ** exps[None, :, :], axis=-1)
    PHIx = monoX @ Vinv                                          # [Qx, dpe]
    t2 = (y - v20[:, None, None]) / (v21 - v20)[:, None, None]
    by = jnp.stack([1 - t2, t2], axis=-1)                        # [P,Qx,Qy,2]
    # see _bucket_cut2d_polar: non-positive barycentrics NaN under an
    # exp(e*log(b)) pow lowering
    by = jnp.clip(by, 1e-30, 1.0)
    monoY = jnp.prod(by[..., None, :] ** exps[None, None, None, :, :],
                     axis=-1)
    PHIy = monoY @ Vinv                                          # [P,Qx,Qy,dpe]
    r2 = (x[:, :, None] - y) ** 2
    g = _radial_eval(kernel, r2, x[:, :, None, None], y[..., None])
    wfac = (wq[None, :, None] * wr[None, None, :]) * ln[:, :, None] \
        * vols1[:, None, None]                                   # [P,Qx,Qy]
    PSIx = jnp.broadcast_to(PHIx[None, :, None, :], PHIy.shape)  # [P,Qx,Qy,dpe]
    PSI = jnp.concatenate([PSIx, -PHIy], axis=-1)                # [P,Qx,Qy,2dpe]
    M = jnp.einsum('pqr,pqri,pqrj->pij', g * wfac, PSI, PSI)
    return M.reshape(M.shape[0], -1)


def _psi_prod(PSI):
    """PSIP[q, I*n+J] = PSI[I,q]*PSI[J,q]."""
    n, Q = PSI.shape
    return (PSI[:, None, :] * PSI[None, :, :]).reshape(n * n, Q).T.copy()


def _pad(arr, P, fill=0):
    if arr.shape[0] == P:
        return arr
    pad_shape = (P - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)




def _dofIncidence(dofs, N):
    """[N+1, K] flat indices into dofs.reshape(-1) of each dof's (cell,
    local) incidences, K the max interior-dof valence padded to a power of
    two; pad/dump entries = C*dpe.  Row N (the boundary dump) gathers
    nothing — its accumulated values are sliced away by every consumer."""
    flat = dofs.reshape(-1)
    tgt = np.where(flat >= 0, flat, N).astype(np.int64)
    order = np.argsort(tgt, kind='stable')
    srt = tgt[order]
    counts = np.bincount(srt, minlength=N + 1)
    K = int(counts[:N].max()) if N else 1
    Kp = 1
    while Kp < K:
        Kp *= 2
    inc = np.full((N + 1, Kp), len(flat), dtype=np.int64)
    start = np.zeros(N + 2, dtype=np.int64)
    start[1:] = np.cumsum(counts)
    slot = np.arange(len(srt)) - start[srt]
    sel = srt < N
    inc[srt[sel], slot[sel]] = order[sel]
    return inc


def _chunk_size(chunk):
    """Pad to 256 * 4^k, capped at CHUNK_CAP, to bound both the number of
    compiled shapes and the per-kernel compile time (see CHUNK_CAP)."""
    c = 256
    while c < chunk and c < CHUNK_CAP:
        c *= 4
    return min(c, CHUNK_CAP)


def _nch_pad(n):
    """Pad a scan chunk COUNT to the next power of two.

    The chunk count is part of the scanned executable's input shape, so an
    un-padded count compiles a fresh kernel for EVERY problem size; the
    pow2 ladder bounds the distinct shapes at O(log N) across all sizes
    (persistently cached), at <=2x padded no-op work (zero symfac rows)."""
    p = 1
    while p < n:
        p *= 2
    return p


@partial(jax.jit, static_argnames=('kernel',))
def _farFieldBlocks(gi, gj, kernel=None):
    """K[p, a, b] = gamma(gi[p, a], gj[p, b]) for batched Chebyshev grids
    (ref assembleFarFieldInteractions clusterMethodCy.pyx:2153)."""
    return kernel.jaxEval(gi[:, :, None, :], gj[:, None, :, :])


def _onAccelerator():
    """Whether assembly accumulates on the device (GPU) rather than on the
    host.  XLA's scatter-add is serial on the CPU backend, so the CPU keeps
    host accumulators and the per-pair bucket path."""
    return jax.default_backend() != 'cpu'


class _ParallelCompiler:
    """Parallel-compile launcher for the bucket kernels.

    XLA compiles independent executables concurrently from several threads,
    but `jax.jit`'s implicit compile-on-first-call is serial.  Every bucket
    launch therefore goes through :func:`_launch`, which keeps a registry of
    AOT-compiled executables keyed by (fn, static args, arg shapes):

    * **harvest mode** (within :func:`_harvest`): the launch is lowered and
      queued instead of executed; the donated accumulator (or zeros of the
      output shape) is returned so the surrounding value-independent
      orchestration keeps running.  The assembly drivers run one throwaway
      pass in this mode, then :meth:`compilePending` compiles every queued
      kernel concurrently.
    * **normal mode**: executes the registered executable (compiling
      serially on a miss, so a launch the harvest pass did not see still
      works)."""

    def __init__(self):
        self.compiled = {}
        self.pending = {}
        self.outinfo = {}
        self.harvesting = False

    @staticmethod
    def _key(fn, args, dynkw, statics):
        leaves, treedef = jax.tree.flatten((args, dynkw))
        sig = tuple((np.shape(l), np.result_type(l).name) for l in leaves)
        return (fn, tuple(sorted(statics.items())), treedef, sig)

    def launch(self, fn, *args, _statics=None, _force=False, **dynkw):
        statics = _statics or {}
        if not hasattr(fn, 'lower'):
            # plain callable (e.g. a profiling monkeypatch): bypass AOT
            return fn(*args, **dynkw, **statics)
        key = self._key(fn, args, dynkw, statics)
        if self.harvesting and _force:
            # value-producing launch whose OUTPUT steers later launches
            # (e.g. the enumeration histogram): execute even while
            # harvesting so the dependent launches get harvested too
            pass
        elif self.harvesting:
            if key not in self.compiled and key not in self.pending:
                lowered = fn.lower(*args, **dynkw, **statics)
                self.pending[key] = lowered
                self.outinfo[key] = lowered.out_info
            return self._placeholder(key, args)
        ex = self.compiled.get(key)
        if ex is None:
            lowered = self.pending.pop(
                key, None) or fn.lower(*args, **dynkw, **statics)
            self.outinfo[key] = lowered.out_info
            ex = lowered.compile()
            self.compiled[key] = ex
        return ex(*args, **dynkw)

    def _placeholder(self, key, args):
        """Output stand-in for a harvested launch: the donated first arg
        when shapes match (accumulator pattern), zeros otherwise."""
        leaves, treedef = jax.tree.flatten(self.outinfo[key])
        if (len(leaves) == 1 and len(args) and hasattr(args[0], 'shape')
                and leaves[0].shape == tuple(args[0].shape)
                and leaves[0].dtype == args[0].dtype):
            return jax.tree.unflatten(treedef, [args[0]])
        return jax.tree.unflatten(
            treedef, [jnp.zeros(l.shape, l.dtype) for l in leaves])

    def compilePending(self):
        if not self.pending:
            return
        items = list(self.pending.items())
        self.pending.clear()
        nThreads = min(int(os.environ.get(
            'PYNUCLEUS_TPU_COMPILE_THREADS', '16')), len(items))
        if nThreads <= 1:
            for k, low in items:
                self.compiled[k] = low.compile()
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(nThreads) as pool:
            for k, ex in zip([k for k, _ in items],
                             pool.map(lambda kl: kl[1].compile(), items)):
                self.compiled[k] = ex


_compiler = _ParallelCompiler()


def _launch(fn, *args, _statics=None, _force=False, **dynkw):
    return _compiler.launch(fn, *args, _statics=_statics, _force=_force,
                            **dynkw)


# problem signatures whose launches were already harvested this process
_HARVESTED = set()


def _parallelCompileWorthIt():
    """Whether assemblies run the throwaway harvest pass first.

    On the GPU it pays: a cold H2 build of the 18,145-dof disc rung on one
    H100 took 34.5 s with the pass and 44.4 s without (400 W card), and
    30.7 s against 37.3 s in a second pair run in the opposite order
    (700 W card).  On the CPU backend the extra pass is pure overhead.
    PYNUCLEUS_TPU_PARALLEL_COMPILE=1/0 overrides the choice."""
    v = os.environ.get('PYNUCLEUS_TPU_PARALLEL_COMPILE')
    if v is not None:
        return v not in ('0', 'false', 'no')
    return _onAccelerator()


class _harvest:
    """Context manager: record-and-queue bucket launches instead of
    executing them, then compile everything queued in parallel on exit.

    defer=True skips the compile on exit: the queued lowerings join the
    NEXT harvest's parallel compile batch (or compile lazily on first real
    launch) -- used to batch the far-field kernel with the near-field
    bucket compiles."""

    def __init__(self, defer=False):
        self.defer = defer

    def __enter__(self):
        self._prev = _compiler.harvesting
        _compiler.harvesting = True
        return self

    def __exit__(self, *exc):
        _compiler.harvesting = self._prev
        if not _compiler.harvesting and not self.defer and exc[0] is None:
            _compiler.compilePending()
        return False


class _PatternMaskLookup:
    """Entry masks for near-field cell pairs, derived ON THE FLY from the
    cluster structure (replaces the ref tupleDictMASK machinery and the
    former stored per-pair mask table, whose [pairs, 2dpe, 2dpe] build was
    the host bottleneck of the H2 near field).

    Entry (a, b) of cell pair (c1, c2) is admitted iff the owning leaf pair
    (node(a), node(b)) ENUMERATES the cell pair, i.e. c1 and c2 are incident
    to the two nodes in either order.  The Pnear-membership half of the old
    mask is enforced downstream by CSR-pattern membership: the pattern is
    exactly the union of near dof blocks, and both CSR accumulators drop
    out-of-pattern entries at scatter time.

    Masks are returned in the canonical (lo, hi) = (min, max) cell order --
    the convention the stored table used; callers that process swapped
    orderings roll the dpe-blocks themselves."""

    def __init__(self, keys, C, dofs, dofNode, cellNodes):
        self.keys = keys          # sorted unique lo * C + hi [K]
        self.C = C
        self._dofs = dofs
        self._dofNode = dofNode
        self._cellNodes = cellNodes

    def pairs(self):
        return self.keys // self.C, self.keys % self.C

    def lookup(self, ii, jj):
        """Vectorized mask computation for (unordered) cell pairs."""
        ii = np.asarray(ii)
        jj = np.asarray(jj)
        lo = np.minimum(ii, jj)
        hi = np.maximum(ii, jj)
        dr = np.concatenate([self._dofs[lo], self._dofs[hi]], axis=1)
        valid = dr >= 0
        nr = np.where(valid, self._dofNode[np.where(valid, dr, 0)], -1)
        inc1 = (nr[:, :, None] ==
                self._cellNodes[lo][:, None, :]).any(axis=2) & valid
        inc2 = (nr[:, :, None] ==
                self._cellNodes[hi][:, None, :]).any(axis=2) & valid
        return (inc1[:, :, None] & inc2[:, None, :]) \
            | (inc2[:, :, None] & inc1[:, None, :])


class _DiagAccumulator:
    """Accumulate only the diagonal entries (ref getDiagonal pxi:2269)."""

    def __init__(self, N, dtype=None):
        self.N = N
        self.diag = np.zeros(N + 1, dtype=dtype or REAL)

    def add(self, rows, cols, vals):
        sel = (rows == cols) & (rows >= 0)
        np.add.at(self.diag, rows[sel], np.asarray(vals)[sel])


class DenseAccumulator:
    """Accumulate (row, col, val) into a dense [N+1, N+1] with dump slot."""

    def __init__(self, N, dtype=None):
        self.N = N
        self.A = np.zeros((N + 1, N + 1), dtype=dtype or REAL)

    def add(self, rows, cols, vals):
        r = np.where(rows >= 0, rows, self.N)
        c = np.where(cols >= 0, cols, self.N)
        np.add.at(self.A, (r, c), vals)

    def result(self):
        from ..base.linear_operators import Dense_LinearOperator
        return Dense_LinearOperator(jnp.asarray(self.A[:self.N, :self.N]))


@partial(jax.jit, donate_argnums=(0,), static_argnames=('nPSI',))
def _device_scatter_rows(A, dofRows, M, mask, nPSI):
    """Broadcast local (nPSI x nPSI) entries to (row, col) pairs ON DEVICE —
    only the compact dofRows/mask arrays cross the host-device link."""
    N = A.shape[0] - 1
    rows = jnp.where(dofRows >= 0, dofRows, N)
    P = rows.shape[0]
    rb = jnp.broadcast_to(rows[:, :, None], (P, nPSI, nPSI))
    if mask is not None:
        rb = jnp.where(mask, rb, N)
    cb = jnp.broadcast_to(rows[:, None, :], (P, nPSI, nPSI))
    return A.at[rb.reshape(-1), cb.reshape(-1)].add(M.reshape(-1))


@partial(jax.jit, donate_argnums=(0,))
def _device_scatter_add(A, rows, cols, vals):
    return A.at[rows, cols].add(vals)


class DeviceDenseAccumulator:
    """Device-resident dense accumulator: contributions never leave the
    accelerator (the GPU path; see _onAccelerator)."""

    def __init__(self, N, dtype=None):
        self.N = N
        self.dtype = dtype or REAL
        self.A = jnp.zeros((N + 1, N + 1), dtype=self.dtype)

    def add(self, rows, cols, vals):
        """Host-computed (row, col, val) triplets, scattered on device;
        negative rows/cols (boundary dofs, DROP) go to the dump slot."""
        r = np.where(rows >= 0, rows, self.N)
        c = np.where(cols >= 0, cols, self.N)
        self.A = _launch(_device_scatter_add, self.A, _jd(r, INDEX),
                         _jd(c, INDEX), _jd(vals, self.dtype))

    def deviceAddRows(self, dofRows, M, mask, nPSI):
        self.A = _launch(
            _device_scatter_rows,
            self.A, _jd(dofRows, INDEX), M,
            jnp.asarray(mask) if mask is not None else None,
            _statics=dict(nPSI=nPSI))

    def result(self):
        from ..base.linear_operators import Dense_LinearOperator
        return Dense_LinearOperator(self.A[:self.N, :self.N])


class VectorDenseAccumulator:
    """Dense accumulator with a trailing component axis [N+1, N+1, V]
    (ref Dense_VectorLinearOperator target of the vecA getDense branch)."""

    def __init__(self, N, V, dtype=None):
        self.N = N
        self.V = V
        self.A = np.zeros((N + 1, N + 1, V), dtype=dtype or REAL)

    def add(self, rows, cols, vals):
        # vals [n, V]
        r = np.where(rows >= 0, rows, self.N)
        c = np.where(cols >= 0, cols, self.N)
        np.add.at(self.A, (r, c), np.asarray(vals))

    def result(self):
        from ..base.linear_operators import Dense_VectorLinearOperator
        return Dense_VectorLinearOperator(
            jnp.asarray(self.A[:self.N, :self.N, :]))


class BCAccumulator:
    """Accumulate the interior x boundary coupling A_BC (ref getFracLapl
    with dm2=dmBC; boundary dofs are encoded as negative ids -d-1)."""

    def __init__(self, N, NB):
        self.N = N
        self.NB = NB
        self.A = np.zeros((N + 1, NB + 1), dtype=REAL)

    def add(self, rows, cols, vals):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        keep = (rows >= 0) & (cols < 0) & (cols > DROP // 2)
        r = np.where(keep, rows, self.N)
        c = np.where(keep, -cols - 1, self.NB)
        np.add.at(self.A, (r, c), vals)

    def result(self):
        from ..base.linear_operators import Dense_LinearOperator
        return Dense_LinearOperator(jnp.asarray(self.A[:self.N, :self.NB]))


class CSRAccumulator:
    """Accumulate into a fixed CSR pattern; entries outside the pattern are
    dropped (replaces ref IndexManager + tupleDict masks).

    treePos: optional global-dof -> pattern-row translation (the H2 near
    field keeps its pattern in cluster-tree ordering so scatter slots are
    arithmetic; host contributions arrive in global dof ids)."""

    def __init__(self, pattern, treePos=None, dtype=None):
        # pattern: scipy CSR with sorted indices.  Accumulation happens in
        # f64 host-side (np.add.at accuracy); ``dtype`` only sets the dtype
        # of the RESULT operator, so an f32 build keeps f32 matvecs.
        self.pattern = pattern
        self.indptr = pattern.indptr
        self.indices = pattern.indices
        self.data = np.zeros(pattern.nnz + 1, dtype=REAL)
        self.N = pattern.shape[0]
        self.treePos = treePos
        self.outDtype = dtype or REAL

    def _slots(self, rows, cols):
        # one global C-level binary search over row-major CSR keys (see
        # DeviceCSRAccumulator._slots)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if self.treePos is not None:
            rows = np.where(rows >= 0, self.treePos[np.maximum(rows, 0)], -1)
            cols = np.where(cols >= 0, self.treePos[np.maximum(cols, 0)], -1)
        if not hasattr(self, '_sortedKeys'):
            rowIdx = np.repeat(np.arange(self.N, dtype=np.int64),
                               np.diff(self.indptr))
            self._sortedKeys = rowIdx * np.int64(self.N + 1) \
                + self.indices.astype(np.int64)
        valid = (rows >= 0) & (cols >= 0)
        key = np.where(valid, rows, 0).astype(np.int64) * np.int64(self.N + 1) \
            + np.where(valid, cols, 0)
        pos = np.searchsorted(self._sortedKeys, key)
        inb = pos < len(self._sortedKeys)
        found = inb & (self._sortedKeys[np.minimum(
            pos, len(self._sortedKeys) - 1)] == key)
        return np.where(valid & found, pos, self.pattern.nnz)

    def add(self, rows, cols, vals):
        slots = self._slots(rows, cols)
        np.add.at(self.data, slots, vals)

    def result(self):
        return CSR_LinearOperator(
            self.indices, self.indptr,
            jnp.asarray(self.data[:-1], dtype=self.outDtype),
            num_columns=self.pattern.shape[1])


@partial(jax.jit, static_argnames=('kernel',),
         donate_argnums=(0,))
def _bucket_masked_csr_scan(data, vertices, cellsArr, volsArr,
                            di, dj, symfac, slots, bary_x, bary_y, w, PSIP,
                            kernel=None):
    """Masked natural-order buckets accumulated DIRECTLY into device CSR
    data.  The nnz scatter slots (cluster-pair masks + CSR pattern lookups)
    are precomputed host-side and shipped per chunk, so the device does a
    direct scatter instead of random-access binary searches.  One launch per
    bucket (lax.scan over chunks)."""

    def body(Acc, chunk):
        dic, djc, sfc, slotc = chunk
        v1 = vertices[cellsArr[dic]]
        v2 = vertices[cellsArr[djc]]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        if kernel.finiteHorizon or kernel.complement:
            g = g * kernel.interaction.jaxIndicator(
                x, y, kernel.horizonValue ** 2)
        vols = volsArr[dic] * volsArr[djc] * sfc
        t = (g * w[None, :]) * vols[:, None]
        M = t @ PSIP                                   # [P, nPSI^2]
        return Acc.at[slotc.reshape(-1)].add(M.reshape(-1)), None

    data, _ = jax.lax.scan(body, data, (di, dj, symfac, slots))
    return data


@partial(jax.jit, static_argnames=('kernel',), donate_argnums=(0,))
def _bucket_tree_csr_scan(data, vertices, cellsArr, volsArr, dofsArr,
                          treePosArr, dofNodeArr, indptrT, tStartArr,
                          c1A, c2A, IA, JA, offFA, offBA, sfA,
                          bary_x, bary_y, w, PSIP, kernel=None):
    """Near-field distant bucket with ARITHMETIC scatter slots, fully on
    device (the scalable replacement for host maskedSlots + slot shipping;
    ref assembleClusters cluster-pair loops, nonlocalAssembly pxi:1663).

    Each scanned element is one (cell pair, processing cluster pair): the
    per-cluster-pair EXACT mask (rows in I x cols in J and the transpose)
    makes repeated processing of a cell pair under different cluster pairs
    additive without dedup -- every pattern entry belongs to exactly one
    leaf pair.  The pattern lives in cluster-tree dof ordering, so the slot
    of entry (a, b) with a in I, b in J is
        indptrT[tree(a)] + blockOff[I, J] + (tree(b) - treeStart[J])
    -- gathers and adds only, no binary search on device.  Only
    (c1, c2, I, J, offF, offB, symfac) cross the link: 28 bytes/pair."""
    nnz = data.shape[0] - 1

    def body(Acc, ch):
        c1, c2, I, J, offF, offB, sf = ch
        v1 = vertices[cellsArr[c1]]
        v2 = vertices[cellsArr[c2]]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        vols = volsArr[c1] * volsArr[c2] * sf
        t = (g * w[None, :]) * vols[:, None]
        M = t @ PSIP                                    # [P, (2dpe)^2]
        dr = jnp.concatenate([dofsArr[c1], dofsArr[c2]], axis=1)
        valid = dr >= 0
        drs = jnp.where(valid, dr, 0)
        nr = jnp.where(valid, dofNodeArr[drs], -1)
        ta = treePosArr[drs]
        inI = nr == I[:, None]
        inJ = nr == J[:, None]
        mF = inI[:, :, None] & inJ[:, None, :]
        mB = inJ[:, :, None] & inI[:, None, :]
        rowStart = indptrT[ta]
        colF = ta[:, None, :] - tStartArr[J][:, None, None]
        colB = ta[:, None, :] - tStartArr[I][:, None, None]
        slot = jnp.where(
            mF, rowStart[:, :, None] + offF[:, None, None] + colF,
            jnp.where(mB, rowStart[:, :, None] + offB[:, None, None] + colB,
                      nnz))
        return Acc.at[slot.reshape(-1)].add(M.reshape(-1)), None

    data, _ = jax.lax.scan(body, data,
                           (c1A, c2A, IA, JA, offFA, offBA, sfA))
    return data


# ------------------------------------------------------------------------
# Device-side near-field enumeration (zero per-cell-pair host transfer).
#
# The host-enumeration path ships (c1, c2, I, J, offF, offB, sf) per cell
# pair -- 28 bytes/pair, ~2.3 GB at 16k 2D dofs.  Here the device derives
# everything from per-CLUSTER-pair descriptors (a few MB total):
#
#   phase 1 (_enum_phase1): for every flat index t of the concatenated
#     cells(I) x cells(J) products, recover the cell pair, apply the
#     validity rules (no identical cells, no vertex-sharing cells -- the
#     singular path owns those -- and canonical orientation only when both
#     orderings are enumerated), evaluate the SAME f32 quadrature-order
#     model as the host path (panels.distantOrders, ref
#     fractionalLaplacian2D.pyx:622-641), snap orders to the bucket ladder,
#     and return (key per element, cluster-pair index per element, order
#     histogram).  Only the histogram crosses to the host.
#
#   phase 2 (_enum_phase2): per order bucket, stream-compact that order's
#     element ids on device (cumsum + scatter), then run the standard
#     arithmetic-slot quadrature scan over the compacted ids.  Work equals
#     the host-enumerated path's (same per-element orders); the ordered
#     pads and invalid elements are evaluated only by the ~20-flop key
#     model, never by quadrature.

_ENUM_SENTINEL = 127


def _enum_elem_key(t, Treal, cum, offI, offJ, n2A, IA, JA, ncArrD,
                   cellsArr, cellNodesD, centersD, loghD, cA, cB, cC,
                   mdim, p=None):
    """(cluster pair p, cells a/b, validity, snapped order) for flat ids t.

    Order-model constants: 2D (cA, cB, cC) = (s, c, logH0); 1D = (sval, c,
    logH0) (see panels.distantOrders / the native enumerator scalars)."""
    if p is None:
        p = jnp.searchsorted(cum, t, side='right') - 1
        p = jnp.clip(p, 0, IA.shape[0] - 1)
    l = t - cum[p]
    n2p = n2A[p]
    a = ncArrD[offI[p] + l // n2p]
    b = ncArrD[offJ[p] + l % n2p]
    I = IA[p]
    J = JA[p]
    # validity: skip identical + vertex-sharing cells (singular path) and
    # the non-canonical ordering of doubly-enumerated pairs.  All gathers
    # are COLUMN-wise ([C]-slice then flat [T] gather) rather than one
    # [T, nv] gather with a tiny trailing dimension
    nv = cellsArr.shape[1]
    vaCols = [jax.lax.index_in_dim(cellsArr, i, 1, keepdims=False)[a]
              for i in range(nv)]
    vbCols = [jax.lax.index_in_dim(cellsArr, i, 1, keepdims=False)[b]
              for i in range(nv)]
    share = jnp.zeros(t.shape, bool)
    for i in range(nv):
        for j_ in range(nv):
            share = share | (vaCols[i] == vbCols[j_])
    dpe = cellNodesD.shape[1]
    bInI = jnp.zeros(t.shape, bool)
    aInJ = jnp.zeros(t.shape, bool)
    for i in range(dpe):
        col = jax.lax.index_in_dim(cellNodesD, i, 1, keepdims=False)
        bInI = bInI | (col[b] == I)
        aInJ = aInJ | (col[a] == J)
    dup = bInI & aInJ
    valid = (t < Treal) & (a != b) & ~share & (~dup | (a < b))
    # f32 order model (mirrors panels.distantOrders).  centersD is stored
    # COLUMN-wise [dim, C] and gathered per coordinate (no [T, dim] gather
    # with a tiny trailing dimension)
    r2c = jnp.zeros_like(loghD[a])
    for d_ in range(centersD.shape[0]):
        dd = centersD[d_][a] - centersD[d_][b]
        r2c = r2c + dd * dd
    logd = 0.5 * jnp.log(jnp.maximum(r2c, jnp.float32(1e-38)))
    lh1 = loghD[a]
    lh2 = loghD[b]
    if mdim == 1:
        sval, c_, lH0 = cA, cB, cC
        lH1 = jnp.abs(lh1 - lH0)
        lH2 = jnp.abs(lh2 - lH0)
        ldh1 = logd - lh1
        ldh2 = logd - lh2
        num1 = c_ + (2 * sval - 1) * lH2 - 2 * sval * ldh2
        num2 = c_ + (2 * sval - 1) * lH1 - 2 * sval * ldh1
        o1 = jnp.ceil(num1 / (jnp.maximum(ldh1, 0) + jnp.float32(0.8)))
        o2 = jnp.ceil(num2 / (jnp.maximum(ldh2, 0) + jnp.float32(0.8)))
    else:
        s_, c_, lH0 = cA, cB, cC
        ldh1 = logd - lh1
        ldh2 = logd - lh2
        l1 = jnp.abs(lh1 - lH0)
        l2 = jnp.abs(lh2 - lH0)
        lmin = jnp.maximum(l1, l2)
        o1 = jnp.ceil((c_ + (s_ - 1.0) * l2 + lmin - s_ * ldh2) /
                      (jnp.maximum(ldh1, 0) + jnp.float32(0.4)))
        o2 = jnp.ceil((c_ + (s_ - 1.0) * l1 + lmin - s_ * ldh1) /
                      (jnp.maximum(ldh2, 0) + jnp.float32(0.4)))
    o = jnp.maximum(jnp.maximum(o1, o2), 2.0)
    o = jnp.clip(o, 2.0, 120.0).astype(jnp.int32)
    # deterministic snap (matches emitChunk): even; (8,16]->16; >16->mult 8
    o = ((o + 1) // 2) * 2
    o = jnp.where(o > 16, ((o + 7) // 8) * 8, o)
    o = jnp.where((o > 8) & (o <= 16), 16, o)
    key = jnp.where(valid, o, _ENUM_SENTINEL)
    return p, a, b, I, J, key


@partial(jax.jit, static_argnames=('Tpad', 'mdim'))
def _enum_phase1(cum, offI, offJ, n2A, IA, JA, ncArrD, cellsArr,
                 cellNodesD, centersD, loghD, cA, cB, cC, Treal,
                 Tpad=None, mdim=2):
    """Keys + cluster-pair index per flat element, order histogram.

    The element -> cluster-pair map pT is built by a boundary scatter +
    cumsum (nP scatter increments, one contiguous [Tpad] prefix sum) -- a
    per-element searchsorted would cost log2(nP) full-array gather rounds
    (measured ~half of phase 1)."""
    t = jnp.arange(Tpad, dtype=jnp.int32)
    nP = IA.shape[0]
    bumps = jnp.zeros(Tpad, jnp.int32).at[cum[1:nP]].add(
        1, mode='drop')
    p = jnp.cumsum(bumps)
    p, a, b, I, J, key = _enum_elem_key(
        t, Treal, cum, offI, offJ, n2A, IA, JA, ncArrD, cellsArr,
        cellNodesD, centersD, loghD, cA, cB, cC, mdim, p=p)
    hist = jnp.bincount(key, length=_ENUM_SENTINEL + 1)
    return key.astype(jnp.int8), p, hist


# ------------------------------------------------------------------------
# Block-structured near field: process each near cluster pair as the dense
# [n1, n2] product of its cell lists, with quadrature points tensorized
# [n1, Q1] x [n2, Q2] and dof placement factored into one-hot matrices so
# the whole accumulation becomes batched matmul contractions (the reference
# walks the same products per-pair on the host, assembleClusters
# nonlocalAssembly pxi:1663; the flat per-element device path above is
# dominated by gathers and 36-wide scatter-adds rather than quadrature
# math -- to be re-measured on the H100).
#
# For one cluster pair (I, J) and cells a in cells(I), b in cells(J):
#   M_ab = PSI^T diag(w g_ab) PSI with PSI = [phi_x; -phi_y] splits into
#   xx/xy/yx/yy blocks; placing rows into I's tree slots and columns into
#   J's gives
#     B_IJ = sum_ab [ Rx_I(a)^T diag(sx) Rx_J(a) + Ry_I(b)^T diag(sy) Ry_J(b)
#                     - Rx_I(a)^T G_ab Ry_J(b) - Ry_I(b)^T G_ab^T Rx_J(a) ]
#   where R*_N(c) [Q, nbar] is the basis evaluated on the quadrature grid
#   times the one-hot placement of c's dofs into node N's tree slots.
#   B_JI = B_IJ^T (kernel symmetric).  The four terms are einsums over
#   [B, n1, n2, Q1, Q2] g with per-row/per-col [.., Q, nbar] placements --
#   all matmuls.  Scatter volume collapses from 36 adds per CELL pair to one
#   [nbar, nbar] block add per CLUSTER pair.
#
# Element validity and the per-element f32 order model are identical to
# _enum_elem_key (outer-product form); the block path runs each cluster
# pair once per LOW order it contains (counts from _block_near_count).
# High orders (>8; Duffy rules with Q up to ~80k) stay on the flat
# per-element path, restricted to the few pairs that contain them.

_LOW_ORDER_MAX = 8


def _block_mask_order(offI, offJ, n1q, n2q, I, J, cellsArr, dofsArr,
                      dofNodeArr, ncArrD, centersD, loghD, cA, cB, cC,
                      n1p, n2p, mdim):
    """Shared prelude: per-(row cell, col cell) validity mask and snapped
    order for a chunk of cluster pairs (all gathers O(n1 + n2))."""
    ar1 = jnp.arange(n1p, dtype=jnp.int32)
    ar2 = jnp.arange(n2p, dtype=jnp.int32)
    cellsA = ncArrD[offI[:, None] + ar1[None, :]]        # [Bc, n1]
    cellsB = ncArrD[offJ[:, None] + ar2[None, :]]        # [Bc, n2]
    rowLive = ar1[None, :] < n1q[:, None]
    colLive = ar2[None, :] < n2q[:, None]
    vA = cellsArr[cellsA]                                # [Bc, n1, nv]
    vB = cellsArr[cellsB]
    dA = dofsArr[cellsA]                                 # [Bc, n1, dpe]
    dB = dofsArr[cellsB]
    dAs = jnp.where(dA >= 0, dA, 0)
    dBs = jnp.where(dB >= 0, dB, 0)
    nodeA = jnp.where(dA >= 0, dofNodeArr[dAs], -1)
    nodeB = jnp.where(dB >= 0, dofNodeArr[dBs], -1)
    aInJ = (nodeA == J[:, None, None]).any(axis=2)       # [Bc, n1]
    bInI = (nodeB == I[:, None, None]).any(axis=2)       # [Bc, n2]
    dup = aInJ[:, :, None] & bInI[:, None, :]
    canon = ~dup | (cellsA[:, :, None] < cellsB[:, None, :])
    share = (vA[:, :, None, :, None] == vB[:, None, :, None, :]) \
        .any(axis=(3, 4))
    neq = cellsA[:, :, None] != cellsB[:, None, :]
    live = rowLive[:, :, None] & colLive[:, None, :]
    mask = live & neq & ~share & canon
    # f32 order model on the [n1, n2] grid (same formulas as
    # _enum_elem_key; centersD column-wise [dim, C])
    r2c = jnp.zeros(mask.shape, jnp.float32)
    for d_ in range(centersD.shape[0]):
        col = centersD[d_]
        dd = col[cellsA][:, :, None] - col[cellsB][:, None, :]
        r2c = r2c + dd * dd
    logd = 0.5 * jnp.log(jnp.maximum(r2c, jnp.float32(1e-38)))
    lh1 = loghD[cellsA][:, :, None]
    lh2 = loghD[cellsB][:, None, :]
    if mdim == 1:
        sval, c_, lH0 = cA, cB, cC
        lH1 = jnp.abs(lh1 - lH0)
        lH2 = jnp.abs(lh2 - lH0)
        ldh1 = logd - lh1
        ldh2 = logd - lh2
        num1 = c_ + (2 * sval - 1) * lH2 - 2 * sval * ldh2
        num2 = c_ + (2 * sval - 1) * lH1 - 2 * sval * ldh1
        o1 = jnp.ceil(num1 / (jnp.maximum(ldh1, 0) + jnp.float32(0.8)))
        o2 = jnp.ceil(num2 / (jnp.maximum(ldh2, 0) + jnp.float32(0.8)))
    else:
        s_, c_, lH0 = cA, cB, cC
        ldh1 = logd - lh1
        ldh2 = logd - lh2
        l1 = jnp.abs(lh1 - lH0)
        l2 = jnp.abs(lh2 - lH0)
        lmin = jnp.maximum(l1, l2)
        o1 = jnp.ceil((c_ + (s_ - 1.0) * l2 + lmin - s_ * ldh2) /
                      (jnp.maximum(ldh1, 0) + jnp.float32(0.4)))
        o2 = jnp.ceil((c_ + (s_ - 1.0) * l1 + lmin - s_ * ldh1) /
                      (jnp.maximum(ldh2, 0) + jnp.float32(0.4)))
    o = jnp.maximum(jnp.maximum(o1, o2), 2.0)
    o = jnp.clip(o, 2.0, 120.0).astype(jnp.int32)
    o = ((o + 1) // 2) * 2
    o = jnp.where(o > 16, ((o + 7) // 8) * 8, o)
    o = jnp.where((o > 8) & (o <= 16), 16, o)
    return (cellsA, cellsB, vA, vB, dA, dB, dAs, dBs, nodeA, nodeB,
            mask, o)


@partial(jax.jit, static_argnames=('n1p', 'n2p', 'mdim'))
def _block_near_count(offIx, offJx, n1x, n2x, Ix, Jx, cellsArr, dofsArr,
                      dofNodeArr, ncArrD, centersD, loghD, cA, cB, cC,
                      n1p=None, n2p=None, mdim=2):
    """Per-(cluster pair, order class) element counts.  Classes 0-3 =
    orders 2/4/6/8, class 4 = any order > 8 (flat-path pairs)."""

    def body(_, xs):
        offI, offJ, n1q, n2q, I, J = xs
        (_, _, _, _, _, _, _, _, _, _, mask, o) = _block_mask_order(
            offI, offJ, n1q, n2q, I, J, cellsArr, dofsArr, dofNodeArr,
            ncArrD, centersD, loghD, cA, cB, cC, n1p, n2p, mdim)
        cnt = []
        for k in range(4):
            cnt.append((mask & (o == 2 * (k + 1))).sum(
                axis=(1, 2), dtype=jnp.int32))
        cnt.append((mask & (o > _LOW_ORDER_MAX)).sum(
            axis=(1, 2), dtype=jnp.int32))
        return 0, jnp.stack(cnt, axis=1)                 # [Bc, 5]

    _, counts = jax.lax.scan(body, 0, (offIx, offJx, n1x, n2x, Ix, Jx))
    return counts                                        # [nCh, Bc, 5]


@partial(jax.jit,
         static_argnames=('kernel', 'n1p', 'n2p', 'nbar', 'order', 'mdim'))
def _block_near_quad(data, vertices, cellsArr, volsArr, dofsArr,
                     treePosArr, dofNodeArr, ncArrD, centersD, loghD,
                     offIx, offJx, n1x, n2x, Ix, Jx, tSIx, tSJx, baseFx,
                     baseBx, LIx, LJx, cA, cB, cC, PHI1, PHI2, B1, B2,
                     W1, W2, kernel=None, n1p=None, n2p=None, nbar=None,
                     order=None, mdim=2):
    """One (order, size-bucket) pass of the block near field (see the
    section comment above).  Scatter: one [nbar, nbar] block add per
    cluster pair into the tree-ordered CSR (slots are affine:
    base + i*rowLen + j), plus the transpose block for I != J."""
    HI = jax.lax.Precision.HIGHEST

    def body(dataAcc, xs):
        (offI, offJ, n1q, n2q, I, J, tSI, tSJ, baseF, baseB, LI, LJ) = xs
        (cellsA, cellsB, vA, vB, dA, dB, dAs, dBs, nodeA, nodeB, mask,
         o) = _block_mask_order(
            offI, offJ, n1q, n2q, I, J, cellsArr, dofsArr, dofNodeArr,
            ncArrD, centersD, loghD, cA, cB, cC, n1p, n2p, mdim)
        mask = mask & (o == order)
        dt = dataAcc.dtype
        # quadrature points/values, tensorized [n1, Q1] x [n2, Q2]
        vxA = vertices[vA]                               # [Bc, n1, nv, d]
        vxB = vertices[vB]
        x = jnp.einsum('qv,bavd->baqd', B1, vxA, precision=HI)
        y = jnp.einsum('pv,bcvd->bcpd', B2, vxB, precision=HI)
        xb = x[:, :, None, :, None, :]
        yb = y[:, None, :, None, :, :]
        r2 = jnp.sum((xb - yb) ** 2, axis=-1)      # [Bc, n1, n2, Q1, Q2]
        g = _radial_eval(kernel, r2, xb, yb)
        volsA = volsArr[cellsA]
        volsB = volsArr[cellsB]
        fac = (volsA[:, :, None] * volsB[:, None, :] * 2.0) \
            * mask.astype(dt)
        gW = g * (W1[:, None] * W2[None, :])[None, None, None, :, :] \
            * fac[:, :, :, None, None]
        # dof placements into tree slots of I (rows) / J (cols)
        ib = jnp.arange(nbar, dtype=jnp.int32)

        def placed(node, tree, dofsRaw, tS, N_, PHI):
            slot = jnp.where((node == N_[:, None, None]) & (dofsRaw >= 0),
                             tree - tS[:, None, None], nbar)
            oneh = (slot[..., None] == ib).astype(dt)    # [Bc, n, dpe, nbar]
            return jnp.einsum('rq,bart->baqt', PHI, oneh, precision=HI)

        treeA = treePosArr[dAs]
        treeB = treePosArr[dBs]
        RxI = placed(nodeA, treeA, dA, tSI, I, PHI1)     # [Bc, n1, Q1, nbar]
        RxJ = placed(nodeA, treeA, dA, tSJ, J, PHI1)
        RyI = placed(nodeB, treeB, dB, tSI, I, PHI2)     # [Bc, n2, Q2, nbar]
        RyJ = placed(nodeB, treeB, dB, tSJ, J, PHI2)
        sx = gW.sum(axis=(2, 4))                         # [Bc, n1, Q1]
        sy = gW.sum(axis=(1, 3))                         # [Bc, n2, Q2]
        C = jnp.einsum('baq,baqi,baqj->bij', sx, RxI, RxJ, precision=HI)
        C += jnp.einsum('bcp,bcpi,bcpj->bij', sy, RyI, RyJ, precision=HI)
        H = jnp.einsum('bacqp,bcpj->baqj', gW, RyJ, precision=HI)
        C -= jnp.einsum('baqj,baqi->bij', H, RxI, precision=HI)
        H2 = jnp.einsum('bacqp,bcpi->baqi', gW, RyI, precision=HI)
        C -= jnp.einsum('baqi,baqj->bij', H2, RxJ, precision=HI)
        # block scatter (affine slots); transpose block only for I != J
        # (the I == J block already holds the full symmetric local matrix)
        idxF = (baseF[:, None, None] + ib[None, :, None] * LI[:, None, None]
                + ib[None, None, :])
        dataAcc = dataAcc.at[idxF.reshape(-1)].add(
            C.reshape(-1), mode='drop')
        Ct = C.transpose(0, 2, 1) \
            * (I != J).astype(dt)[:, None, None]
        idxB = (baseB[:, None, None] + ib[None, :, None] * LJ[:, None, None]
                + ib[None, None, :])
        dataAcc = dataAcc.at[idxB.reshape(-1)].add(
            Ct.reshape(-1), mode='drop')
        return dataAcc, None

    data, _ = jax.lax.scan(body, data, (offIx, offJx, n1x, n2x, Ix, Jx,
                                        tSIx, tSJx, baseFx, baseBx, LIx,
                                        LJx))
    return data


@partial(jax.jit, static_argnames=('kernel', 'chunk', 'nCh'))
def _enum_phase2(data, keys, pT, cum, offI, offJ, n2A, IA, JA, offFA,
                 offBA, ncArrD, vertices, cellsArr, volsArr, dofsArr,
                 treePosArr, dofNodeArr, indptrT, tStartArr, orderD, count,
                 bary_x, bary_y, w, PSIP, chunk=None, nCh=None,
                 kernel=None):
    """Compact one order's element ids on device, then the quadrature scan
    (same slot arithmetic as _bucket_tree_csr_scan)."""
    nnz = data.shape[0] - 1
    Tpad = keys.shape[0]
    idsLen = nCh * chunk
    flags = keys == orderD.astype(keys.dtype)
    pos = jnp.cumsum(flags.astype(jnp.int32)) - flags
    ids = jnp.zeros(idsLen, jnp.int32).at[
        jnp.where(flags, pos, idsLen)].set(
        jnp.arange(Tpad, dtype=jnp.int32), mode='drop')

    def body(Acc, ch):
        tq = jax.lax.dynamic_slice(ids, (ch * chunk,), (chunk,))
        live = (ch * chunk + jnp.arange(chunk, dtype=jnp.int32)) < count
        p = pT[tq]
        l = tq - cum[p]
        n2p = n2A[p]
        c1 = ncArrD[offI[p] + l // n2p]
        c2 = ncArrD[offJ[p] + l % n2p]
        I = IA[p]
        J = JA[p]
        offF = offFA[p]
        offB = offBA[p]
        sf = jnp.where(live, jnp.asarray(2.0, data.dtype), 0.0)
        v1 = vertices[cellsArr[c1]]
        v2 = vertices[cellsArr[c2]]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        vols = volsArr[c1] * volsArr[c2] * sf
        tt = (g * w[None, :]) * vols[:, None]
        M = tt @ PSIP
        dr = jnp.concatenate([dofsArr[c1], dofsArr[c2]], axis=1)
        validD = dr >= 0
        drs = jnp.where(validD, dr, 0)
        nr = jnp.where(validD, dofNodeArr[drs], -1)
        ta = treePosArr[drs]
        inI = nr == I[:, None]
        inJ = nr == J[:, None]
        mF = inI[:, :, None] & inJ[:, None, :]
        mB = inJ[:, :, None] & inI[:, None, :]
        rowStart = indptrT[ta]
        colF = ta[:, None, :] - tStartArr[J][:, None, None]
        colB = ta[:, None, :] - tStartArr[I][:, None, None]
        slot = jnp.where(
            mF, rowStart[:, :, None] + offF[:, None, None] + colF,
            jnp.where(mB, rowStart[:, :, None] + offB[:, None, None] + colB,
                      nnz))
        return Acc.at[slot.reshape(-1)].add(M.reshape(-1)), None

    data, _ = jax.lax.scan(body, data, jnp.arange(nCh, dtype=jnp.int32))
    return data


@partial(jax.jit, static_argnames=('kernel', 'useNormals', 'useYShift'),
         donate_argnums=(0,))
def _bucket_surface_tree_scan(data, vertices, dofNodeArr, treePosArr,
                              indptrT, tStartArr, vi1A, vi2A, drA, vsA,
                              nmA, yoA, IA, JA, offFA, offBA,
                              bary_x, bary_y, w, PSIP, kernel=None,
                              useNormals=False, useYShift=False):
    """Union-surface boundary quadrature accumulated DIRECTLY into device
    CSR data with ARITHMETIC tree slots (same slot formula as
    `_bucket_tree_csr_scan`; masks re-derived on device from the owning
    cluster pair (I, J) via dofNode).  Replaces a host path with per-chunk
    device->host pulls (ref assembleClusters 'cluster exterior',
    nonlocalAssembly pxi:1975-2035)."""
    nnz = data.shape[0] - 1

    def body(Acc, ch):
        v1i, v2i, drc, vsc, nmc, yoc, I, J, offF, offB = ch
        v1 = vertices[v1i]
        v2 = vertices[v2i]
        x = jnp.einsum('pvd,vq->pqd', v1, bary_x)
        y = jnp.einsum('pvd,vq->pqd', v2, bary_y)
        if useYShift:
            y = y + yoc[:, None, :]
        r2 = jnp.sum((x - y) ** 2, axis=-1)
        g = _radial_eval(kernel, r2, x, y)
        if useNormals:
            rsafe = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
            fac = jnp.einsum('pd,pqd->pq', nmc, y - x) / rsafe
            g = g * jnp.where(r2 > 0, fac, 0.0)
        t = (g * w[None, :]) * vsc[:, None]
        M = t @ PSIP                                    # [P, dpe^2]
        valid = drc >= 0
        drs = jnp.where(valid, drc, 0)
        nr = jnp.where(valid, dofNodeArr[drs], -1)
        ta = treePosArr[drs]
        inI = nr == I[:, None]
        inJ = nr == J[:, None]
        mF = inI[:, :, None] & inJ[:, None, :]
        mB = inJ[:, :, None] & inI[:, None, :]
        rowStart = indptrT[ta]
        colF = ta[:, None, :] - tStartArr[J][:, None, None]
        colB = ta[:, None, :] - tStartArr[I][:, None, None]
        slot = jnp.where(
            mF, rowStart[:, :, None] + offF[:, None, None] + colF,
            jnp.where(mB, rowStart[:, :, None] + offB[:, None, None] + colB,
                      nnz))
        return Acc.at[slot.reshape(-1)].add(M.reshape(-1)), None

    data, _ = jax.lax.scan(body, data,
                           (vi1A, vi2A, drA, vsA, nmA, yoA, IA, JA,
                            offFA, offBA))
    return data


class DeviceCSRAccumulator:
    """CSR accumulator with device-resident data for the masked scan fast
    path; irregular host-side contributions (surfaces, permuted touching
    pairs) accumulate into a numpy shadow merged at result()."""

    def __init__(self, pattern, C, maskTable, dtype=None, treePos=None):
        self.pattern = pattern
        self.indptr = pattern.indptr
        self.indices = pattern.indices
        self.N = pattern.shape[0]
        self.dtype = dtype or REAL
        nnz = pattern.nnz
        self.data = jnp.zeros(nnz + 1, dtype=self.dtype)
        self.hostData = np.zeros(nnz + 1, dtype=REAL)
        self.C = C
        self.maskTable = maskTable
        self.treePos = treePos

    # --- host path (same slot logic as CSRAccumulator)
    def _slots(self, rows, cols):
        """(r, c) -> nnz slot via ONE global searchsorted: CSR keys
        r*(N+1)+indices are globally sorted, so a single C-level binary
        search replaces the python-level rowwise bisection (~17x on the
        multi-million-entry masked near-field queries)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if self.treePos is not None:
            rows = np.where(rows >= 0, self.treePos[np.maximum(rows, 0)], -1)
            cols = np.where(cols >= 0, self.treePos[np.maximum(cols, 0)], -1)
        if not hasattr(self, '_sortedKeys'):
            rowIdx = np.repeat(np.arange(self.N, dtype=np.int64),
                               np.diff(self.indptr))
            self._sortedKeys = rowIdx * np.int64(self.N + 1) \
                + self.indices.astype(np.int64)
        valid = (rows >= 0) & (cols >= 0)
        key = np.where(valid, rows, 0).astype(np.int64) * np.int64(self.N + 1) \
            + np.where(valid, cols, 0)
        pos = np.searchsorted(self._sortedKeys, key)
        inb = pos < len(self._sortedKeys)
        found = inb & (self._sortedKeys[np.minimum(
            pos, len(self._sortedKeys) - 1)] == key)
        return np.where(valid & found, pos, self.pattern.nnz)

    def add(self, rows, cols, vals):
        np.add.at(self.hostData, self._slots(rows, cols), vals)

    def maskedSlots(self, ii, jj, nPSI, dpe, dofs):
        """Host-precomputed scatter slots [P, nPSI, nPSI] for natural-order
        masked pairs; masked/out-of-pattern entries map to the dump slot."""
        em = self.maskTable.lookup(ii, jj)
        if nPSI == dpe:
            dr = dofs[ii]
            em = em[:, :dpe, :dpe]
        else:
            dr = np.concatenate([dofs[ii], dofs[jj]], axis=1)
        P = dr.shape[0]
        rows = np.broadcast_to(dr[:, :, None], (P, nPSI, nPSI))
        cols = np.broadcast_to(dr[:, None, :], (P, nPSI, nPSI))
        slots = self._slots(rows.reshape(-1), cols.reshape(-1))
        slots = np.where(em.reshape(-1), slots, self.pattern.nnz)
        return slots.reshape(P, nPSI * nPSI)

    # --- device scan path
    def scanMasked(self, runnerArgs, kernel=None):
        self.data = _launch(_bucket_masked_csr_scan, self.data, *runnerArgs,
                            _statics=dict(kernel=kernel))

    def result(self):
        # keep the accumulation dtype: an f32 build keeps f32 matvecs
        data = jnp.asarray(self.hostData[:-1], dtype=self.dtype) \
            + self.data[:-1]
        return CSR_LinearOperator(self.indices, self.indptr, data,
                                  num_columns=self.pattern.shape[1])


def _aranges(reps):
    """Concatenated [0..r) ranges for each r in reps (ragged arange)."""
    total = int(reps.sum())
    starts = np.repeat(np.cumsum(reps) - reps, reps)
    return np.arange(total) - starts


def _treeCSRToGlobal(At, perm, tLen, rowLen, tStartRow, tmplAll, tmplStart,
                     indptrT, N):
    """Convert the tree-ordered near-field CSR to global dof ordering.

    Rows within a tree node share one column template, so one small
    argsort per NODE (not per row, not per nnz) re-sorts columns, and data
    moves with vectorized per-node gathers -- O(nnz) total, no global
    sort."""
    dataT = np.asarray(At.data)
    nnz = dataT.shape[0]
    nNear = len(tLen)
    # zeros (not empty): with a partial node cover (restricted Pnear, see
    # _assembleNearField) uncovered dofs keep zero-length rows
    lenPerG = np.zeros(N, dtype=np.int64)
    lenPerG[perm] = np.repeat(rowLen, tLen)
    indptrG = np.zeros(N + 1, dtype=np.int64)
    indptrG[1:] = np.cumsum(lenPerG)
    indicesG = np.empty(nnz, dtype=np.int32)
    dataG = np.empty(nnz, dtype=dataT.dtype)
    for r in range(nNear):
        L = int(rowLen[r])
        n = int(tLen[r])
        if L == 0 or n == 0:
            continue
        tmpl = tmplAll[tmplStart[r]:tmplStart[r] + L]
        gcols = perm[tmpl]
        ordC = np.argsort(gcols)
        rows_t0 = int(tStartRow[r])
        D = dataT[indptrT[rows_t0]:indptrT[rows_t0 + n]].reshape(n, L)
        g = perm[rows_t0:rows_t0 + n]
        pos = (indptrG[g][:, None] + np.arange(L)[None, :]).reshape(-1)
        dataG[pos] = D[:, ordC].reshape(-1)
        indicesG[pos] = np.tile(gcols[ordC].astype(np.int32), n)
    return CSR_LinearOperator(indicesG, indptrG, jnp.asarray(dataG),
                              num_columns=N)


class _BucketRunner:
    """Launches the device quadrature kernel in bounded padded chunks and
    accumulates into the global dense matrix.

    Accumulation is a host-side np.add.at by default (XLA's dense
    scatter-add is serial on CPU and would dominate); device accumulators
    (see _onAccelerator) take the device scatter path.  The heavy
    quadrature math always runs on device."""

    def __init__(self, vertices, kernel, useNormals=False, dtype=None,
                 cells=None, dofs=None, vols=None):
        # dtype=float32 selects the f32 path; quadrature tables and
        # geometry are cast once.
        self.dtype = dtype or REAL
        self.vertices = _jd(vertices, self.dtype)
        self.kernel = kernel
        self.useNormals = useNormals
        # device-resident mesh data for the natural-pair fast path
        self.cellsDev = _jd(cells, INDEX) if cells is not None else None
        self.dofsDev = _jd(dofs, INDEX) if dofs is not None else None
        self.dofsHost = np.asarray(dofs) if dofs is not None else None
        self.volsDev = _jd(vols, self.dtype) if vols is not None else None

    def runNatural(self, acc, rule, PSI, di, dj, symfac):
        # Fast path for id/distant buckets in natural dof order with a
        # device accumulator: only (di, dj) cross the link, the whole bucket
        # runs as ONE launch (lax.scan over fixed-size chunks on device).
        P = len(di)
        if P == 0:
            return
        PSIP = _jd(_psi_prod(PSI), self.dtype)
        bary_x = _jd(rule.bary_x, self.dtype)
        bary_y = _jd(rule.bary_y, self.dtype)
        w = _jd(rule.w, self.dtype)
        nPSI = PSI.shape[0]
        Q = rule.num_nodes
        maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1)), 256)
        chunk = _chunk_size(min(maxP, P))     # pow2 ladder: no 8192 floor
        nChunks = _nch_pad((P + chunk - 1) // chunk)
        total = nChunks * chunk
        dip = _pad(np.asarray(di), total, fill=0).reshape(nChunks, chunk)
        djp = _pad(np.asarray(dj), total, fill=0).reshape(nChunks, chunk)
        sf = np.full(total, float(symfac))
        sf[P:] = 0.0
        acc.A = _launch(
            _bucket_natural_scatter_scan,
            acc.A, self.vertices, self.cellsDev, self.dofsDev,
            self.volsDev, _jd(dip, INDEX),
            _jd(djp, INDEX),
            _jd(sf.reshape(nChunks, chunk), self.dtype),
            bary_x, bary_y, w, PSIP,
            _statics=dict(kernel=self.kernel, nPSI=nPSI))

    def runNaturalMaskedCSR(self, acc, rule, PSI, di, dj, symfac):
        """Masked natural-order bucket into a DeviceCSRAccumulator: whole
        bucket in one scan launch, masks and CSR slots resolved on device."""
        P = len(di)
        if P == 0:
            return
        PSIP = _jd(_psi_prod(PSI), self.dtype)
        bary_x = _jd(rule.bary_x, self.dtype)
        bary_y = _jd(rule.bary_y, self.dtype)
        w = _jd(rule.w, self.dtype)
        nPSI = PSI.shape[0]
        Q = rule.num_nodes
        maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1)), 256)
        chunk = _chunk_size(min(maxP, P))     # pow2 ladder: no 8192 floor
        nChunks = _nch_pad((P + chunk - 1) // chunk)
        total = nChunks * chunk
        diA = np.asarray(di)
        djA = np.asarray(dj)
        dip = _pad(diA, total, fill=0).reshape(nChunks, chunk)
        djp = _pad(djA, total, fill=0).reshape(nChunks, chunk)
        sf = np.full(total, float(symfac))
        sf[P:] = 0.0
        dpe = self.dofsHost.shape[1]
        slots = acc.maskedSlots(diA, djA, nPSI, dpe, self.dofsHost)
        slotsP = np.full((total, nPSI * nPSI), acc.pattern.nnz,
                         dtype=np.int64)
        slotsP[:P] = slots
        acc.scanMasked((self.vertices, self.cellsDev, self.volsDev,
                        _jd(dip, INDEX),
                        _jd(djp, INDEX),
                        _jd(sf.reshape(nChunks, chunk), self.dtype),
                        jnp.asarray(slotsP.reshape(nChunks, chunk,
                                                   nPSI * nPSI)),
                        bary_x, bary_y, w, PSIP),
                       kernel=self.kernel)

    def runRowsScan(self, acc, rule, PSI, vertIdx1, vertIdx2, dofRows,
                    volsym, normals=None):
        """Whole explicit-pair bucket in one scan launch into a device dense
        accumulator (boundary distant panels; see _bucket_rows_scatter_scan).
        """
        P = vertIdx1.shape[0]
        if P == 0:
            return
        PSIP = _jd(_psi_prod(PSI), self.dtype)
        bary_x = _jd(rule.bary_x, self.dtype)
        bary_y = _jd(rule.bary_y, self.dtype)
        w = _jd(rule.w, self.dtype)
        nPSI = PSI.shape[0]
        Q = rule.num_nodes
        maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1)), 256)
        chunk = _chunk_size(min(maxP, P))     # pow2 ladder: no 8192 floor
        nCh = _nch_pad((P + chunk - 1) // chunk)
        tot = nCh * chunk
        dim = self.vertices.shape[1]
        nv1, nv2 = vertIdx1.shape[1], vertIdx2.shape[1]

        def padTo(a, shape, fill=0):
            out = np.full(shape, fill, dtype=a.dtype)
            out[:P] = a
            return out

        vi1 = padTo(np.asarray(vertIdx1), (tot, nv1)).reshape(nCh, chunk, nv1)
        vi2 = padTo(np.asarray(vertIdx2), (tot, nv2)).reshape(nCh, chunk, nv2)
        dr = padTo(np.asarray(dofRows), (tot, nPSI),
                   fill=-1).reshape(nCh, chunk, nPSI)
        vs = padTo(np.asarray(volsym, dtype=np.float64),
                   (tot,)).reshape(nCh, chunk)
        nm = padTo(np.asarray(normals), (tot, dim)).reshape(nCh, chunk, dim) \
            if normals is not None else np.zeros((nCh, chunk, dim))
        acc.A = _launch(
            _bucket_rows_scatter_scan,
            acc.A, self.vertices,
            _jd(vi1, INDEX), _jd(vi2, INDEX),
            _jd(dr, INDEX), _jd(vs, self.dtype),
            _jd(nm, self.dtype),
            bary_x, bary_y, w, PSIP,
            _statics=dict(kernel=self.kernel, nPSI=nPSI,
                          useNormals=self.useNormals))

    def run(self, acc, rule, PSI, vertIdx1, vertIdx2, dofRows, volsym,
            normals=None, entryMask=None, PHI=None, yOffset=None):
        """acc: DenseAccumulator or CSRAccumulator.  entryMask [P, nPSI,
        nPSI] bool restricts which local entries scatter (cluster-pair masks,
        ref IndexManager getElemSymMaskCluster).  PHI=(PHIx, PHIy) selects the
        NONSYMMETRIC local matrix.  yOffset [P, dim] nudges the y quadrature
        points (jump-side selection for variable-order surface integrals)."""
        P = vertIdx1.shape[0]
        if P == 0:
            return
        V = getattr(self.kernel, 'valueSize', 1)
        useLogCorr = (getattr(rule, 'cw1', None) is not None
                      and bool(getattr(self.kernel, 'derivative', 0))
                      and hasattr(self.kernel, 'evalLogCoeffsJax'))
        logkw = {}
        if useLogCorr:
            logkw = dict(lnEta=_jd(rule.lnEta, self.dtype),
                         cw1=_jd(rule.cw1, self.dtype),
                         cw2=_jd(rule.cw2, self.dtype))
        nonsym = PHI is not None
        if nonsym:
            PHIx, PHIy = PHI
            nn, Q_ = PSI.shape
            PHIxPSI = _jd((PHIx[:, None, :] * PSI[None, :, :]).reshape(nn * nn, Q_).T.copy(), self.dtype)
            PHIyPSI = _jd((PHIy[:, None, :] * PSI[None, :, :]).reshape(nn * nn, Q_).T.copy(), self.dtype)
        PSIP = _jd(_psi_prod(PSI), self.dtype)
        bary_x = _jd(rule.bary_x, self.dtype)
        bary_y = _jd(rule.bary_y, self.dtype)
        w = _jd(rule.w, self.dtype)
        nPSI = PSI.shape[0]
        Q = rule.num_nodes
        # bound the [P, Q] intermediate: ~32M elements per launch
        maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1),
                       CHUNK_CAP), 256)
        start = 0
        while start < P:
            chunk = min(maxP, P - start)
            csize = _chunk_size(chunk)
            sl = slice(start, start + chunk)
            vi1 = _pad(vertIdx1[sl], csize)
            vi2 = _pad(vertIdx2[sl], csize)
            vs = _pad(volsym[sl], csize, fill=0.0).astype(self.dtype)
            nm = None
            if self.useNormals:
                nm = _jd(_pad(normals[sl], csize, fill=0.0), self.dtype)
            yo = None
            if yOffset is not None:
                yo = _jd(_pad(yOffset[sl], csize, fill=0.0), self.dtype)
            if V > 1:
                # vector-valued: one pass computes all components
                if nonsym:
                    M = _launch(
                        _bucket_contrib_nonsym_vec,
                        self.vertices, _jd(vi1, INDEX),
                        _jd(vi2, INDEX), jnp.asarray(vs),
                        bary_x, bary_y, w, PHIxPSI, PHIyPSI,
                        _statics=dict(kernel=self.kernel,
                                      useLogCorr=useLogCorr), **logkw)
                else:
                    M = _launch(
                        _bucket_contrib_vec,
                        self.vertices, _jd(vi1, INDEX),
                        _jd(vi2, INDEX), jnp.asarray(vs),
                        bary_x, bary_y, w, PSIP,
                        normals=nm,
                        _statics=dict(kernel=self.kernel,
                                      useNormals=self.useNormals,
                                      useLogCorr=useLogCorr), **logkw)
            elif nonsym:
                M = _launch(
                    _bucket_contrib_nonsym,
                    self.vertices, _jd(vi1, INDEX),
                    _jd(vi2, INDEX), jnp.asarray(vs),
                    bary_x, bary_y, w, PHIxPSI, PHIyPSI,
                    _statics=dict(kernel=self.kernel,
                                  useLogCorr=useLogCorr), **logkw)
            else:
                M = _launch(
                    _bucket_contrib,
                    self.vertices, _jd(vi1, INDEX),
                    _jd(vi2, INDEX), jnp.asarray(vs),
                    bary_x, bary_y, w, PSIP,
                    normals=nm,
                    yShift=yo,
                    _statics=dict(kernel=self.kernel,
                                  useNormals=self.useNormals,
                                  useYShift=yo is not None,
                                  useLogCorr=useLogCorr), **logkw)
            dr = _pad(dofRows[sl], csize, fill=-1)
            if V > 1:
                shape3 = (chunk, nPSI, nPSI)
                rb = np.broadcast_to(dr[:chunk, :, None], shape3)
                cb = np.broadcast_to(dr[:chunk, None, :], shape3)
                if entryMask is not None:
                    rb = np.where(entryMask[sl], rb, DROP)
                Mh = np.asarray(M[:chunk]).reshape(chunk, nPSI, nPSI, V)
                acc.add(rb.reshape(-1), cb.reshape(-1), Mh.reshape(-1, V))
            elif hasattr(acc, 'deviceAddRows'):
                em = None
                if entryMask is not None:
                    em = _pad(entryMask[sl], csize, fill=False)
                acc.deviceAddRows(dr, M, em, nPSI)
            else:
                shape3 = (chunk, nPSI, nPSI)
                rb = np.broadcast_to(dr[:chunk, :, None], shape3)
                cb = np.broadcast_to(dr[:chunk, None, :], shape3)
                if entryMask is not None:
                    rb = np.where(entryMask[sl], rb, DROP)
                Mh = np.asarray(M[:chunk]).reshape(shape3)
                acc.add(rb.reshape(-1), cb.reshape(-1), Mh.reshape(-1))
            start += chunk


class nonlocalBuilder:
    """Assembly driver (ref nonlocalAssembly_{SCALAR}.pxi:878 nonlocalBuilder).

    Formats: getDense (full pair product), getSparse (finite-horizon near
    pairs only), getH2 (cluster tree + Chebyshev far field + exact near
    field).  All share one batched panel engine (_runPairBuckets)."""

    def __init__(self, dm, kernel, params=None, zeroExterior=True, comm=None,
                 dm2=None, **kwargs):
        self.dm = dm
        self.mesh = dm.mesh
        self.kernel = kernel
        self.params = params or {}
        self.zeroExterior = False if kernel.finiteHorizon else zeroExterior
        if kernel.isComplex:
            # Greens kernels have no boundary (Gauss-theorem) kernel
            # (ref kernelsCy.pyx:1307,1321 raise for boundary complex);
            # their bilinear form is the pure double integral
            self.zeroExterior = False
        self.comm = comm

    # ------------------------------------------------------------- helpers
    def _makeRules(self, info):
        """Attach default rules (constant-singularity shim; variable kernels
        build per-s rules inside _runPairBuckets)."""
        info.update(self._makeRulesFor(self.kernel.getSingularityValue()
                                       if not self.kernel.variable else
                                       self.kernel.max_singularity,
                                       info['quad_order_diagonal']))
        return info

    def _makeRulesFor(self, sing, quad_order_diagonal):
        """Panel rules for one singularity value (variable-order kernels get
        one rule set per distinct s(center1, center2))."""
        dm, mesh = self.dm, self.mesh
        mdim = mesh.manifold_dim
        p = max(dm.polynomialOrder, 1)
        # s-derivative kernels carry an extra log|x-y| factor that the
        # Gauss-Jacobi singularity cancellation only resolves at higher
        # order (the weight absorbs the power law exactly, the log remains)
        pBump = 4 * int(getattr(self.kernel, "derivative", 0) or 0)
        p = p + pBump
        continuous = dm.polynomialOrder >= 1
        out = {}
        if mdim == 1:
            out['ruleId'] = sameCellRule1D(sing, 2 * p)
            out['ruleVertex'] = vertexRule1D(sing, quad_order_diagonal, 2 * p,
                                             continuous=continuous)
        else:
            from .quad_singular_2d import (sameCellRule2DSS, edgeRule2DSS,
                                           vertexRule2DSS)
            kernel = self.kernel
            smax = max(-0.5 * (kernel.max_singularity + 2), 0.0)
            target = self.params.get('target_order') or 0.5
            H0 = mesh.diam / np.sqrt(8)
            lg = abs(np.log(mesh.hmin / H0))
            qdV = max(int(np.ceil((target + 1.0 + smax) / 0.7 * lg)), 4)
            radial = max(p - 1, 1)
            out['ruleId'] = sameCellRule2DSS(sing, 2 * p, quad_order_diagonal,
                                             radialOrder=radial)
            out['ruleEdge'] = edgeRule2DSS(sing, 2 * p, quad_order_diagonal,
                                           continuous=continuous,
                                           radialOrder=radial)
            out['ruleVertex'] = vertexRule2DSS(sing, 2 * p, qdV,
                                               continuous=continuous,
                                               radialOrder=radial)
        return out

    def _makeSplitRuleFor(self, sing, quad_order_diagonal, nS):
        """Touching-panel rule with cancellation=1 for the one-sided terms
        of mixed-singularity nonsym panels (see _runPairBuckets split
        branch / quad_singular.vertexRule1D docstring)."""
        dm, mesh = self.dm, self.mesh
        mdim = mesh.manifold_dim
        p = max(dm.polynomialOrder, 1) \
            + 4 * int(getattr(self.kernel, 'derivative', 0) or 0)
        continuous = dm.polynomialOrder >= 1
        if mdim == 1:
            return vertexRule1D(sing, quad_order_diagonal, 2 * p,
                                continuous=continuous, cancellation=1.0)
        from .quad_singular_2d import edgeRule2DSS, vertexRule2DSS
        radial = max(p - 1, 1)
        if nS == 2:
            return edgeRule2DSS(sing, 2 * p, quad_order_diagonal,
                                continuous=continuous, radialOrder=radial,
                                cancellation=1.0)
        return vertexRule2DSS(sing, 2 * p, quad_order_diagonal,
                              continuous=continuous, radialOrder=radial,
                              cancellation=1.0)

    def _pairSingularities(self, pi, pj):
        """Per-pair kernel singularity from the cell-center fractional order
        (ref getPanelType evalParams, nonlocalOperator pxi:504-520)."""
        kernel = self.kernel
        if not kernel.variable:
            return np.full(len(pi), kernel.getSingularityValue())
        mesh = self.mesh
        centers = mesh.vertices[mesh.cells].mean(axis=1)
        sv = kernel.s(centers[pi], centers[pj])
        return (1.0 if kernel.boundary else 0.0) - kernel.dim - 2 * np.asarray(sv)

    def _runPairBuckets(self, acc, info, maskLookup=None):
        """Run id / touching / distant buckets of a classification dict into
        an accumulator.  maskLookup: optional dict (i, j) -> bool
        [2dpe, 2dpe] entry mask in natural (cell-i dofs, cell-j dofs) order
        (cluster-pair masking for the H2 near field).

        Symmetric kernels: unordered pairs, off-diagonal factor 2
        (ref addToMatrixElemElemSym(contrib, 2.)).  Nonsymmetric kernels:
        the nonsym local matrix is evaluated for BOTH orderings with factor 1
        (ref getDense swapCells branch, pxi:1415-1427)."""
        dm, kernel, mesh = self.dm, self.kernel, self.mesh
        vols = mesh.simplexVolumes()
        cells = mesh.cells
        dofs = dm.dofs
        dpe = dm.dofs_per_element
        mdim = mesh.manifold_dim
        sym = kernel.symmetric
        runner = _BucketRunner(mesh.vertices, kernel,
                               dtype=self.params.get('dtype'),
                               cells=cells, dofs=dofs, vols=vols)
        phi = getattr(kernel, 'phi', None)
        centers = mesh.vertices[cells].mean(axis=1) if phi is not None \
            else None
        fast = hasattr(acc, 'deviceAddRows') and maskLookup is None and sym \
            and phi is None
        fastMaskedCSR = isinstance(acc, DeviceCSRAccumulator) \
            and maskLookup is not None and sym and phi is None \
            and runner.cellsDev is not None

        detfac = {1: 1.0, 2: 2.0, 3: 6.0}[mdim]
        dets = vols * detfac
        qd = info['quad_order_diagonal']
        ruleCache = {}

        def rulesFor(sing):
            key = round(float(sing), 12)
            if key not in ruleCache:
                ruleCache[key] = self._makeRulesFor(sing, qd)
            return ruleCache[key]

        # --- identical-cell panels, grouped by singularity
        ids = info['id']
        if len(ids):
            sings = self._pairSingularities(ids, ids)
            for sing in np.unique(np.round(sings, 12)):
                sel = np.isclose(sings, sing)
                idsS = ids[sel]
                ruleId = rulesFor(sing)['ruleId']
                PSI = ruleId.buildPSI(dm, nSharedVertices=mdim + 1)
                PHI = ruleId.buildPHI(dm, nSharedVertices=mdim + 1) \
                    if not sym else None
                if fast and kernel.symmetric and not kernel.variable:
                    runner.runNatural(acc, ruleId, PSI, idsS, idsS,
                                      detfac ** 2)
                    continue
                if fastMaskedCSR:
                    runner.runNaturalMaskedCSR(acc, ruleId, PSI, idsS, idsS,
                                               detfac ** 2)
                    continue
                em = None
                if maskLookup is not None:
                    em = maskLookup.lookup(idsS, idsS)[:, :dpe, :dpe]
                vsId = dets[idsS] ** 2
                if phi is not None:
                    w = phi.evalPairs(centers[idsS], centers[idsS])
                    keepW = w != 0.0
                    idsS, vsId = idsS[keepW], (vsId * w)[keepW]
                    if em is not None:
                        em = em[keepW]
                    if len(idsS) == 0:
                        continue
                runner.run(acc, ruleId, PSI, cells[idsS], cells[idsS],
                           dofs[idsS], vsId, entryMask=em, PHI=PHI)

        # --- touching panels, grouped by (#shared vertices, singularity of
        # gamma(x,y), singularity of gamma(y,x)).  For UNSYMMETRIC variable
        # orders the two orderings can have different singular exponents on
        # the same panel (e.g. leftRight pairs across the interface:
        # s(x,y)=slr but s(y,x)=srl); the Gauss-Jacobi weight must match
        # each term's own exponent, so such panels are evaluated in two
        # passes (t1-only with rule(sing12), t2-only with rule(sing21)).
        # The reference uses ONE rule from s(center1,center2) for both terms
        # (nonlocalOperator pxi getPanelType + fractionalLaplacian1D_nonsym
        # eval), which under-resolves the mismatched term; the split here is
        # a deliberate accuracy improvement over the reference.
        pairs, sharedInfo = info['touching']
        if len(pairs):
            sings12 = self._pairSingularities(pairs[:, 0], pairs[:, 1])
            sings21 = sings12 if sym else \
                self._pairSingularities(pairs[:, 1], pairs[:, 0])
            byKey = {}
            for k in range(len(pairs)):
                key = (sharedInfo[k][0], round(float(sings12[k]), 12),
                       round(float(sings21[k]), 12))
                byKey.setdefault(key, []).append(k)
        else:
            byKey = {}
        for (nS, sing, sing21), idxs in byKey.items():
            rules = rulesFor(sing)
            if mdim == 1:
                rule = rules['ruleVertex']
            else:
                rule = rules['ruleVertex'] if nS == 1 else rules['ruleEdge']
            PSI = rule.buildPSI(dm, nSharedVertices=nS)
            PHI = rule.buildPHI(dm, nSharedVertices=nS) if not sym else None
            sharedMask = rule.sharedDofMask(dm, nS)
            P = len(idxs)
            nv = mdim + 1
            reps = 1 if sym else 2
            vi1 = np.zeros((reps * P, nv), dtype=np.int64)
            vi2 = np.zeros((reps * P, nv), dtype=np.int64)
            dr = np.zeros((reps * P, 2 * dpe), dtype=np.int64)
            vs = np.zeros(reps * P)
            em = np.zeros((reps * P, 2 * dpe, 2 * dpe), dtype=bool) \
                if maskLookup is not None else None
            idxsArr = np.asarray(idxs)
            ii = pairs[idxsArr, 0]
            jj = pairs[idxsArr, 1]
            # group by the shared-vertex permutation signature: all pair
            # geometry/dof gathers vectorize per group (few distinct perms)
            permSig = np.stack([np.concatenate([sharedInfo[k][1],
                                                sharedInfo[k][2]])
                                for k in idxs])
            uniqSig, sigInv = np.unique(permSig, axis=0, return_inverse=True)
            baseMask = maskLookup.lookup(ii, jj) \
                if maskLookup is not None else None
            phiW = phi.evalPairs(centers[ii], centers[jj]) \
                if phi is not None else None
            for g in range(uniqSig.shape[0]):
                gsel = np.nonzero(sigInv == g)[0]
                perm1 = uniqSig[g, :nv]
                perm2 = uniqSig[g, nv:]
                ld1 = permuteLocalDofs(dm, perm1)
                ld2 = permuteLocalDofs(dm, perm2)
                gi, gj = ii[gsel], jj[gsel]
                vi1[gsel] = cells[gi][:, perm1]
                vi2[gsel] = cells[gj][:, perm2]
                dr[np.ix_(gsel, np.arange(dpe))] = dofs[gi][:, ld1]
                drj = dofs[gj][:, ld2].copy()
                drj[:, sharedMask] = DROP
                dr[np.ix_(gsel, dpe + np.arange(dpe))] = drj
                vs[gsel] = dets[gi] * dets[gj] * (2.0 if sym else 1.0)
                if phiW is not None:
                    vs[gsel] *= phiW[gsel]
                if em is not None:
                    ldFull = np.concatenate([ld1, dpe + ld2])
                    em[gsel] = baseMask[gsel][:, ldFull][:, :, ldFull]
                if not sym:
                    o2 = P + gsel
                    vi1[o2] = cells[gj][:, perm2]
                    vi2[o2] = cells[gi][:, perm1]
                    dr[np.ix_(o2, np.arange(dpe))] = dofs[gj][:, ld2]
                    dri = dofs[gi][:, ld1].copy()
                    dri[:, sharedMask] = DROP
                    dr[np.ix_(o2, dpe + np.arange(dpe))] = dri
                    vs[o2] = dets[gi] * dets[gj]
                    if phiW is not None:
                        vs[o2] *= phiW[gsel]
                    if em is not None:
                        # swapped ordering: local row r is cell-j dof ld2[r]
                        # = natural mask position dpe + ld2[r]
                        ldFull2 = np.concatenate([dpe + ld2, ld1])
                        em[o2] = baseMask[gsel][:, ldFull2][:, :, ldFull2]
            if sym or sing == sing21:
                runner.run(acc, rule, PSI, vi1, vi2, dr, vs, entryMask=em,
                           PHI=PHI)
            else:
                # mixed-singularity nonsym panel: each one-sided kernel term
                # with its own matched rule.  The split terms only carry ONE
                # vanishing factor (the trial difference; the test function
                # does not vanish at the shared simplex), so the split rules
                # use cancellation=1 (see group-key comment above).
                splitRules = {}

                def splitRule(sg):
                    if sg not in splitRules:
                        r = self._makeSplitRuleFor(sg, qd, nS)
                        ps = r.buildPSI(dm, nSharedVertices=nS)
                        ph = r.buildPHI(dm, nSharedVertices=nS)
                        z = np.zeros_like(ph[0])
                        splitRules[sg] = (r, ps, ph, z)
                    return splitRules[sg]

                sA, sB = slice(0, P), slice(P, 2 * P)
                for rows in (sA, sB):
                    emR = em[rows] if em is not None else None
                    # gamma(x,y) term: singularity of (cell1, cell2) order
                    s12 = sing if rows is sA else sing21
                    s21 = sing21 if rows is sA else sing
                    r1, ps1, ph1, z1 = splitRule(s12)
                    runner.run(acc, r1, ps1, vi1[rows], vi2[rows], dr[rows],
                               vs[rows], entryMask=emR, PHI=(ph1[0], z1))
                    # gamma(y,x) term: the transposed ordering's singularity
                    r2, ps2, ph2, z2 = splitRule(s21)
                    runner.run(acc, r2, ps2, vi1[rows], vi2[rows], dr[rows],
                               vs[rows], entryMask=emR, PHI=(z2, ph2[1]))

        # --- distant panels, bucketed by quad order (high orders merged)
        di, dj, orders = info['distant']
        useGrid = 'gridPasses' in info or (
            fast and not kernel.variable and not kernel.finiteHorizon
            and not getattr(kernel, 'complement', False)
            and phi is None and len(orders) > 0
            and self.params.get('denseGrid', len(orders) > (1 << 14)))
        if useGrid:
            di, dj, orders = self._runDistantGrid(acc, runner, info,
                                                  di, dj, orders)
        if len(orders):
            omax = int(orders.max())
            orders = np.where(orders > 16, omax, orders)
            orders = np.where((orders > 8) & (orders <= 16),
                              min(16, omax), orders)
        for order in np.unique(orders):
            sel = orders == order
            ii, jj = di[sel], dj[sel]
            rule = distantRule(int(order), mdim)
            PSI = rule.buildPSI(dm, nSharedVertices=0)
            PHI = rule.buildPHI(dm, nSharedVertices=0) if not sym else None
            if fast:
                runner.runNatural(acc, rule, PSI, ii, jj, 2.0)
                continue
            if fastMaskedCSR:
                runner.runNaturalMaskedCSR(acc, rule, PSI, ii, jj, 2.0)
                continue
            if sym:
                iiA, jjA = ii, jj
                fac = 2.0
            else:
                iiA = np.concatenate([ii, jj])
                jjA = np.concatenate([jj, ii])
                fac = 1.0
            dr = np.concatenate([dofs[iiA], dofs[jjA]], axis=1)
            vs = vols[iiA] * vols[jjA] * fac
            if phi is not None:
                w = phi.evalPairs(centers[iiA], centers[jjA])
                keepW = w != 0.0
                iiA, jjA = iiA[keepW], jjA[keepW]
                dr, vs = dr[keepW], (vs * w)[keepW]
                if len(iiA) == 0:
                    continue
            em = None
            if maskLookup is not None and len(iiA):
                em = maskLookup.lookup(iiA, jjA).copy()
                swapped = iiA > jjA
                if swapped.any():
                    # natural mask is (lo, hi)-ordered; swap the blocks
                    em[swapped] = np.roll(np.roll(em[swapped], -dpe, axis=1),
                                          -dpe, axis=2)
            runner.run(acc, rule, PSI, cells[iiA], cells[jjA], dr, vs,
                       entryMask=em, PHI=PHI)

        # --- horizon-cut pairs (finite horizon only)
        ci, cj, cutOrders = info.get('cut', (np.zeros(0, dtype=np.int64),) * 3)
        if len(ci):
            self._runCutPairs(acc, ci, cj, cutOrders, maskLookup)

    def _runDistantGrid(self, acc, runner, info, di, dj, orders):
        """Scatter-free grid assembly of the low-order distant pairs (see
        _grid_distant_pass); returns the correction subset (close pairs)
        for the per-pair bucket path.

        Pair windows are selected by squared f32 cell-center distance with
        gap-midpoint thresholds: the same f32 values partition the pairs on
        host and device even under FMA rounding differences."""
        from ..fem.quadrature import simplexCompact
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        dtype = runner.dtype
        mdim = mesh.manifold_dim
        dim = mesh.dim
        C = mesh.num_cells
        N = dm.num_dofs

        cc32 = mesh.vertices[mesh.cells].mean(axis=1).astype(np.float32)

        if 'gridPasses' in info:
            # thresholds precomputed by the sparse classifier
            # (classifyPairsDenseGrid); info['distant'] is already the
            # correction subset
            cuts = info['gridPasses']
            if not cuts:
                return di, dj, orders
            keep = None
        else:
            from .panels import _d2f32
            d2p = _d2f32(cc32, di, dj)
            tp, _ = info['touching']
            d2t = _d2f32(cc32, tp[:, 0], tp[:, 1]) if len(tp) else \
                np.zeros(0, dtype=np.float32)

            gridOrders = sorted(int(o) for o in np.unique(orders) if o <= 4)
            if not gridOrders:
                return di, dj, orders

            def threshold(maxGridOrder):
                """Gap-midpoint threshold: everything at or above it is
                safe at maxGridOrder (no touching/id/higher-order pair
                above it)."""
                excl = np.concatenate([d2t, d2p[orders > maxGridOrder],
                                       np.zeros(1, dtype=np.float32)])
                v = float(excl.max())
                while True:
                    above = d2p[d2p > v]
                    if len(above) == 0:
                        return None
                    nxt = float(above.min())
                    if (nxt - v) > 1e-6 * max(nxt, 1e-30):
                        return 0.5 * (v + nxt)
                    v = nxt  # degenerate gap: push borderline pairs inward

            # ascending orders: order 2 takes the farthest window [t2, inf),
            # order 4 the closer [t4, t2); everything below tMin is
            # corrected by the exact bucket path
            cuts = []
            hi = np.float32(np.inf)
            for o in gridOrders:
                t = threshold(o)
                if t is None or np.float32(t) >= hi:
                    continue
                cuts.append((o, np.float32(t), hi))
                hi = np.float32(t)
            if not cuts:
                return di, dj, orders
            tMin = min(t for (_, t, _) in cuts)
            keep = d2p < tMin

        V = mesh.vertices[mesh.cells]
        vols = _jd(mesh.simplexVolumes(), dtype)
        ccf = jnp.asarray(cc32)
        rowDofPad = _jd(dm.dofs, INDEX)
        incRows = _jd(_dofIncidence(dm.dofs, N), INDEX)

        for o, t_lo, t_hi in cuts:
            b1, w1 = simplexCompact(o, mdim)
            Q1 = len(w1)
            X = _jd(np.einsum('qk,ckd->cqd', b1, V), dtype)
            Phi = dm.evalPhi(b1)                           # [dpe, Q1]
            PhiX = _jd(Phi, dtype)
            PhiXw = _jd(Phi * w1[None, :], dtype)
            PsiYw = _jd(-Phi * w1[None, :], dtype)
            w1d = _jd(w1, dtype)
            # pow2 tile rows, bounded by the [C, Q2, Ct*Q1] kernel-eval
            # intermediate (512 MiB) and the [N+1, K, Ct*Q1] incidence
            # gather (384 MiB), in bytes of the assembly dtype
            K_ = incRows.shape[1]
            itemsize = np.dtype(dtype).itemsize
            cap = min((512 << 20) // max(itemsize * C * Q1 * Q1, 1),
                      (384 << 20) // max(itemsize * (N + 1) * K_ * Q1, 1))
            Ct = 8
            while Ct * 2 <= min(C, cap):
                Ct *= 2
            nTiles = -(-C // Ct)
            acc.A = _launch(
                _grid_distant_pass,
                acc.A, X, X, ccf, vols, rowDofPad, incRows,
                PhiXw, PhiX, PhiX, PsiYw, w1d, w1d,
                jnp.float32(t_lo), jnp.float32(t_hi),
                _statics=dict(kernel=kernel, nTiles=nTiles, Ct=Ct))

        self._gridStats = {'corrections': int(len(di) if keep is None
                                              else keep.sum()),
                           'passes': [(o, float(t)) for o, t, _ in cuts]}
        if keep is None:
            return di, dj, orders
        self._gridStats['gridPairs'] = int((~keep).sum())
        return di[keep], dj[keep], orders[keep]

    def _runCutPairs(self, acc, ci, cj, orders, maskLookup=None):
        # Exact 1D interval clipping for pairs cut by the horizon; 2D falls
        # back to the (discontinuous) indicator quadrature with a boosted
        # order.
        dm, kernel, mesh = self.dm, self.kernel, self.mesh
        mdim = mesh.manifold_dim
        dpe = dm.dofs_per_element
        cells = mesh.cells
        dofs = dm.dofs
        vols = mesh.simplexVolumes()
        phi = getattr(kernel, 'phi', None)
        centersC = mesh.vertices[cells].mean(axis=1) if phi is not None \
            else None
        if mdim == 2 and kernel.symmetric \
                and not getattr(kernel, 'variableHorizon', False) \
                and type(kernel.interaction).__name__ in (
                    'ball2', 'ballInf', 'ball1', 'ellipse'):
            # exact polar clipping against the interaction norm ball
            # (see _bucket_cut2d_polar / interactionDomain.jaxDirNorm)
            from ..fem.quadrature import simplexDuffy, gauss01
            exps = _jd(dm.evalPhi.monomialExps, REAL) \
                if dm.polynomialOrder > 0 else jnp.zeros((1, 3))
            Vinv = jnp.asarray(dm.evalPhi.Vinv) \
                if dm.polynomialOrder > 0 else jnp.ones((1, 1))
            vertices = jnp.asarray(mesh.vertices)
            for order in np.unique(orders):
                sel = orders == order
                ii, jj = ci[sel], cj[sel]
                oX = max(int(order) // 2, 4)
                bary_x, wx = simplexDuffy(oX, 2)
                thetas, wtheta = gauss01(max(int(order) // 2 + 2, 6))
                rq, wr = gauss01(max(int(order) // 2, 4))
                M = _launch(
                    _bucket_cut2d_polar,
                    vertices, _jd(cells[ii], INDEX),
                    _jd(cells[jj], INDEX),
                    jnp.asarray(vols[ii]),
                    jnp.asarray(bary_x.T.copy()), jnp.asarray(wx),
                    jnp.asarray(thetas), jnp.asarray(wtheta),
                    jnp.asarray(rq), jnp.asarray(wr), exps, Vinv,
                    kernel.horizonValue,
                    _statics=dict(kernel=kernel, dpe=dpe))
                M = np.asarray(M).reshape(len(ii), 2 * dpe, 2 * dpe)
                if phi is not None:
                    M = M * phi.evalPairs(centersC[ii],
                                          centersC[jj])[:, None, None]
                dr = np.concatenate([dofs[ii], dofs[jj]], axis=1)
                rb = np.broadcast_to(dr[:, :, None], M.shape)
                cb = np.broadcast_to(dr[:, None, :], M.shape)
                if maskLookup is not None:
                    em = maskLookup.lookup(ii, jj)
                    rb = np.where(em, rb, DROP)
                acc.add(rb.reshape(-1), cb.reshape(-1), M.reshape(-1))
            return
        if mdim != 1 or not kernel.symmetric:
            # fallback: indicator mode (barycenter-type accuracy)
            runner = _BucketRunner(mesh.vertices, kernel,
                                   dtype=self.params.get('dtype'))
            sym = kernel.symmetric
            for order in np.unique(orders):
                sel = orders == order
                ii, jj = ci[sel], cj[sel]
                # compact=False: the integrand carries the horizon
                # indicator (discontinuous); point density matters here
                rule = distantRule(int(order), mdim, compact=False)
                PSI = rule.buildPSI(dm, nSharedVertices=0)
                PHI = rule.buildPHI(dm, nSharedVertices=0) if not sym else None
                if sym:
                    iiA, jjA, fac = ii, jj, 2.0
                else:
                    iiA = np.concatenate([ii, jj])
                    jjA = np.concatenate([jj, ii])
                    fac = 1.0
                dr = np.concatenate([dofs[iiA], dofs[jjA]], axis=1)
                vs = vols[iiA] * vols[jjA] * fac
                if phi is not None:
                    vs = vs * phi.evalPairs(centersC[iiA], centersC[jjA])
                em = None
                if maskLookup is not None:
                    em = maskLookup.lookup(iiA, jjA)
                runner.run(acc, rule, PSI, cells[iiA], cells[jjA], dr, vs,
                           entryMask=em, PHI=PHI)
            return
        from ..fem.quadrature import gauss01
        exps = jnp.asarray(dm.evalPhi.monomialExps) \
            if dm.polynomialOrder > 0 else jnp.zeros((1, 2))
        Vinv = jnp.asarray(dm.evalPhi.Vinv) \
            if dm.polynomialOrder > 0 else jnp.ones((1, 1))
        vertices = jnp.asarray(mesh.vertices)
        for order in np.unique(orders):
            sel = orders == order
            ii, jj = ci[sel], cj[sel]
            tq, wq = gauss01(int(order))
            ur, wr = gauss01(int(order))
            # both orderings, factor 1 each (the clipped domain is not
            # symmetric in (x, y))
            iiA = np.concatenate([ii, jj])
            jjA = np.concatenate([jj, ii])
            M = _launch(_bucket_cut1d, vertices,
                        _jd(cells[iiA], INDEX),
                        _jd(cells[jjA], INDEX),
                        jnp.asarray(vols[iiA]),
                        jnp.asarray(tq), jnp.asarray(wq),
                        jnp.asarray(ur), jnp.asarray(wr),
                        exps, Vinv, kernel.horizonValue,
                        _statics=dict(kernel=kernel, dpe=dpe))
            M = np.asarray(M).reshape(len(iiA), 2 * dpe, 2 * dpe)
            if phi is not None:
                M = M * phi.evalPairs(centersC[iiA],
                                      centersC[jjA])[:, None, None]
            dr = np.concatenate([dofs[iiA], dofs[jjA]], axis=1)
            rb = np.broadcast_to(dr[:, :, None], M.shape)
            cb = np.broadcast_to(dr[:, None, :], M.shape)
            if maskLookup is not None:
                em = maskLookup.lookup(iiA, jjA).copy()
                swapped = iiA > jjA
                if swapped.any():
                    em[swapped] = np.roll(np.roll(em[swapped], -dpe, axis=1),
                                          -dpe, axis=2)
                rb = np.where(em, rb, DROP)
            acc.add(rb.reshape(-1), cb.reshape(-1), M.reshape(-1))

    def _gridEligible(self):
        """Kernel classes the scatter-free dense grid handles (symmetric
        constant-order radial kernels over the full space; the grid
        evaluates the radial profile only, so no two-point weight phi,
        neither per cell pair nor per quadrature point)."""
        k = self.kernel
        return (not k.isComplex and k.symmetric and not k.variable
                and not k.finiteHorizon
                and not getattr(k, 'complement', False)
                and getattr(k, 'phi', None) is None
                and getattr(k, 'phiJax', None) is None)

    def getDense(self, trySparsification=False):
        from .panels import classifyPairsDense, classifyPairsDenseGrid
        dm = self.dm
        N = dm.num_dofs
        wantGrid = self.params.get('denseGrid')
        useGrid = self._gridEligible() and wantGrid is not False \
            and (_onAccelerator() or bool(wantGrid))
        if useGrid:
            # sparse O(C log C + near pairs) classification: the device grid
            # covers everything beyond the pass thresholds
            info = self._makeRules(classifyPairsDenseGrid(
                dm, self.kernel,
                target_order=self.params.get('target_order')))
        else:
            info = self._makeRules(classifyPairsDense(
                dm, self.kernel,
                target_order=self.params.get('target_order')))
        def makeAcc():
            if self.kernel.isComplex:
                # complex assembly (ref ComplexnonlocalBuilder, the {SCALAR}
                # template instantiated for COMPLEX): same panel machinery,
                # complex accumulator
                return DenseAccumulator(N, dtype=COMPLEX)
            if not _onAccelerator() and not useGrid:
                return DenseAccumulator(N, dtype=self.params.get('dtype'))
            return DeviceDenseAccumulator(N, dtype=self.params.get('dtype'))

        def runAll(acc):
            self._runPairBuckets(acc, info)
            if self.zeroExterior:
                self._addZeroExterior(acc)

        # throwaway harvest pass: queue every bucket kernel this assembly
        # will launch, compile them CONCURRENTLY (the serial
        # compile-on-first-call bill dominated cold assembly).  Skipped when
        # an identical problem already harvested (launch keys are a
        # deterministic function of mesh + kernel + dtype; a stale skip only
        # costs a serial compile on the miss).
        sig = ('dense', self.kernel, N, self.mesh.num_cells,
               self.dm.polynomialOrder,
               str(self.params.get('dtype')), self.zeroExterior,
               self.mesh.vertices[0].tobytes(),
               self.mesh.vertices[-1].tobytes())
        if _parallelCompileWorthIt() and sig not in _HARVESTED:
            with _harvest():
                runAll(makeAcc())
            _HARVESTED.add(sig)
        acc = makeAcc()
        runAll(acc)
        A = acc.result()
        if trySparsification:
            # drop explicit zeros if the matrix is sparse enough
            # (ref getDense trySparsification, pxi:1452-1480)
            arr = np.asarray(A.toarray())
            nnzRatio = np.count_nonzero(arr) / max(arr.size, 1)
            if nnzRatio < 0.9:
                import scipy.sparse as sp
                As = sp.csr_matrix(arr)
                from ..base.linear_operators import CSR_LinearOperator
                return CSR_LinearOperator.from_scipy(As)
        return A

    def getDiagonal(self):
        """Diagonal of the dense operator without materializing it
        (ref getDiagonal pxi:2269)."""
        N = self.dm.num_dofs
        from .panels import classifyPairsDense
        info = self._makeRules(classifyPairsDense(
            self.dm, self.kernel, target_order=self.params.get('target_order')))
        acc = _DiagAccumulator(
            N, dtype=COMPLEX if self.kernel.isComplex else None)
        self._runPairBuckets(acc, info)
        if self.zeroExterior:
            self._addZeroExterior(acc)
        from ..base.linear_operators import Diagonal_LinearOperator
        return Diagonal_LinearOperator(jnp.asarray(acc.diag[:N]))

    def getEntryCluster(self, I, J):
        """Single matrix entry A[I, J] via a restricted cluster-pair
        assembly (ref getEntryCluster nonlocalAssembly pxi:1475): two fake
        single-dof tree nodes, the full near-field machinery (singular
        panels, distant pairs, union boundary surface) runs masked to the
        one entry."""
        from .h2 import treeNode
        assert not self.kernel.finiteHorizon, \
            'entry probes need horizon == inf (ref pxi:1560)'
        I, J = int(I), int(J)
        box = np.zeros((self.mesh.dim, 2))
        if I == J:
            nodes = [treeNode(0, 0, np.array([I], dtype=np.int64), box)]
            Pnear = [(0, 0)]
        else:
            nodes = [treeNode(0, 0, np.array([I], dtype=np.int64), box),
                     treeNode(1, 0, np.array([J], dtype=np.int64), box)]
            Pnear = [(0, 1), (1, 0)]
        prevFmt = self.params.get('nearFormat')
        self.params['nearFormat'] = 'csr'
        try:
            sub = self._assembleNearField(Pnear, nodes)
        finally:
            if prevFmt is None:
                self.params.pop('nearFormat', None)
            else:
                self.params['nearFormat'] = prevFmt
        rows = np.asarray(sub.rowids)
        cols = np.asarray(sub.indices)
        data = np.asarray(sub.data)
        sel = (rows == I) & (cols == J)
        return data[sel].sum()

    def getEntry(self, I, J):
        """Single matrix entry A[I, J] (ref getEntry pxi:1539; both
        reference code paths compute the same value -- here getEntry
        delegates to the cluster-restricted assembly)."""
        return self.getEntryCluster(I, J)

    def getCoveringClusters(self):
        """Near cluster pairs covering the full near field plus the tree
        nodes (ref getCoveringClusters pxi:2907 -- used by the sparse /
        distributed assembly paths to enumerate the uncompressed part)."""
        plan = self.planH2()
        return plan['Pnear'], plan['nodes']

    # ----------------------------------------------------------- sparse ---
    def _nearCellPairs(self, S):
        """Cell pairs (i <= j) needed to assemble the entries of sparsity
        pattern S exactly: (c1, c2) with dofs(c1) x dofs(c2) hitting S."""
        dm, mesh = self.dm, self.mesh
        C = mesh.num_cells
        N = dm.num_dofs
        d = dm.dofs
        mask = d >= 0
        cc, ll = np.nonzero(mask)
        inc = sp.coo_matrix(
            (np.ones(mask.sum()), (d[cc, ll], cc)), shape=(N, C)).tocsr()
        inc.data[:] = 1.0
        need = (inc.T @ S @ inc).tocoo()
        ii, jj = need.row, need.col
        keep = ii <= jj
        return ii[keep].astype(np.int64), jj[keep].astype(np.int64)

    def getSparse(self):
        """Finite-horizon near-field-only operator (ref getSparse
        nonlocalAssembly pxi:1062): exact entries for all dof pairs whose
        supports interact within the horizon."""
        from .panels import classifyPairList
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        assert kernel.finiteHorizon, 'sparse format requires a finite horizon'
        N = dm.num_dofs
        # sparsity: dof pairs with support distance < horizon
        from .h2 import dofSupportBoxes
        lo, hi = dofSupportBoxes(dm)
        # build via cell pairs within horizon
        info = self._makeRules(classifyPairsDense(
            dm, self.kernel, target_order=self.params.get('target_order')))
        # pattern from contributing cell pairs
        rows, cols = [], []
        d = dm.dofs
        dpe = dm.dofs_per_element

        def addPairs(ii, jj):
            for a, b in ((ii, jj), (jj, ii)):
                r = np.repeat(d[a], dpe, axis=1).reshape(-1)
                c = np.tile(d[b], (1, dpe)).reshape(-1)
                m = (r >= 0) & (c >= 0)
                rows.append(r[m])
                cols.append(c[m])

        addPairs(info['id'], info['id'])
        pairs, _ = info['touching']
        if len(pairs):
            addPairs(pairs[:, 0], pairs[:, 1])
        di, dj, _ = info['distant']
        if len(di):
            addPairs(di, dj)
        ci, cj, _ = info.get('cut', (np.zeros(0, dtype=np.int64),) * 3)
        if len(ci):
            addPairs(ci, cj)
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        S = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(N, N)).tocsr()
        S.sum_duplicates()
        S.sort_indices()
        sig = ('sparse', self.kernel, N, mesh.num_cells,
               dm.polynomialOrder, str(self.params.get('dtype')),
               mesh.vertices[0].tobytes(), mesh.vertices[-1].tobytes())
        if _parallelCompileWorthIt() and sig not in _HARVESTED:
            with _harvest():
                self._runPairBuckets(
                    CSRAccumulator(S.copy(),
                                   dtype=self.params.get('dtype')), info)
            _HARVESTED.add(sig)
        acc = CSRAccumulator(S, dtype=self.params.get('dtype'))
        self._runPairBuckets(acc, info)
        return acc.result()

    # ------------------------------------------------------------ vector --
    def _componentKernels(self):
        """Scalar kernels for each of the kernel's valueSize components
        (constant-s derivative kernels have one component; ref
        IndexManagerVector loops q over kernel.valueSize)."""
        if getattr(self.kernel, 'valueSize', 1) > 1:
            return self.kernel.componentKernels()
        return [self.kernel]

    def getDenseVector(self):
        """Dense vector-valued assembly (ref getDense vecA branch,
        nonlocalAssembly pxi:1354 Dense_VectorLinearOperator).

        Multi-component kernels (valueSize > 1, e.g. derivative kernels of
        multi-parameter orders) assemble ALL components in ONE pass through
        the panel engine: the vector bucket kernels emit [P, nPSI^2, V]
        contributions (ref IndexManagerVector scatter; kernelsCy eval
        :1911 fills vec[valueSize] per point).  Constant-order derivative
        kernels (valueSize 1) go through the scalar engine."""
        from .panels import classifyPairsDense
        V = getattr(self.kernel, 'valueSize', 1)
        if V > 1:
            dm = self.dm
            N = dm.num_dofs
            info = self._makeRules(classifyPairsDense(
                dm, self.kernel,
                target_order=self.params.get('target_order')))
            acc = VectorDenseAccumulator(N, V,
                                         dtype=self.params.get('dtype'))
            self._runPairBuckets(acc, info)
            if self.zeroExterior:
                self._addZeroExterior(acc)
            return acc.result()
        from ..base.linear_operators import Dense_VectorLinearOperator
        comps = []
        for k in self._componentKernels():
            b = nonlocalBuilder(self.dm, k, zeroExterior=self.zeroExterior,
                                params=dict(self.params))
            comps.append(np.asarray(b.getDense().toarray()))
        return Dense_VectorLinearOperator(np.stack(comps, axis=2))

    def getH2Vector(self):
        """Vector-valued H2 (ref VectorH2Matrix clusterMethodCy.pyx:2670):
        component-wise level-major H2 operators."""
        from ..base.linear_operators import H2_VectorLinearOperator
        comps = []
        for k in self._componentKernels():
            b = nonlocalBuilder(self.dm, k, zeroExterior=self.zeroExterior,
                                params=dict(self.params))
            comps.append(b.getH2())
        return H2_VectorLinearOperator(comps)

    # --------------------------------------------------------------- H2 ---
    def getH2(self, returnNearField=False):
        """Hierarchical operator: cluster tree, Chebyshev far field, exact
        near field (ref getH2 nonlocalAssembly pxi:3094)."""
        if self.kernel.finiteHorizon:
            # With a finite horizon the operator support is |x-y| < delta, so
            # the matrix IS sparse (bandwidth ~ (delta/h)^d).  The reference
            # still compresses within-horizon far cluster pairs
            # (clusterMethodCy.pyx:4019-4033: dist>delta -> ZERO, cut ->
            # INADMISSIBLE/near, else eta-admissibility).  Here the exact
            # CSR near field with a batched segment-sum matvec is exact and
            # was the faster of the two at these horizon/h ratios on the
            # previous accelerator (not yet measured on the H100), so
            # finite-horizon H2 delegates to the sparse format.
            A = self.getSparse()
            return (A, None) if returnNearField else A
        from .h2 import H2Matrix, _H2Level
        kernel = self.kernel
        N = self.dm.num_dofs

        plan = self.planH2()
        nodes, Pfar, Pnear = plan['nodes'], plan['Pfar'], plan['Pnear']
        pos, dt = plan['pos'], plan['dt']
        levels = []
        for ell in range(plan['nLvl']):
            entry = _H2Level(plan['sizes'][ell])
            if ell > 0:
                entry['T'] = jnp.asarray(plan['Thost'][ell], dtype=dt)
                entry['parentIdx'] = _jd(plan['parentIdxH'][ell], INDEX)
            levels.append(entry)

        # ---- ONE device launch for ALL levels' far-field blocks (instead
        # of one launch, a device->host pull of K and a re-upload per
        # level); K stays on device and levels take static slices of the
        # one result.  The pair count is
        # padded to a power-of-two bucket so the compiled shape count stays
        # O(1) in the problem size (pad rows evaluate the kernel at two
        # far-apart dummy points -> finite values, sliced away).
        giD = gjD = None
        if plan['farGi'] is not None:
            giD, gjD = _jd(plan['farGi'], dt), _jd(plan['farGj'], dt)
            if _parallelCompileWorthIt():
                # queue the far-field lowering now so it joins the near
                # field's parallel compile batch (defer=no compile yet)
                with _harvest(defer=True):
                    _launch(_farFieldBlocks, giD, gjD,
                            _statics=dict(kernel=kernel))

        # ---- near field (ref assembleClusters pxi:1663-2160): for each near
        # cluster pair (I, J):
        #   - the (u(x)-u(y))(v(x)-v(y)) interaction over the needed cell
        #     pairs, masked to entries (I x J) u (J x I);
        #   - the diagonal mass from everything OUTSIDE the pair's cell
        #     union, via a Gauss-theorem surface integral over the union's
        #     boundary (this also covers the zeroExterior part for the
        #     infinite-horizon Dirichlet problem).
        # Cell pairs shared between cluster pairs are evaluated once with the
        # UNION of their masks (ref tupleDictMASK machinery).
        Anear = self._assembleNearField(Pnear, nodes)

        # ---- far-field blocks (compiled in the near field's batch above)
        if plan['farGi'] is not None:
            KallD = _launch(_farFieldBlocks, giD, gjD,
                            _statics=dict(kernel=kernel))
            # cross terms -u(x)v(y) carry factor -2 (both orderings of
            # the ordered cluster pair; ref clusterMethodCy.pyx:2216)
            KallD = (-2.0 * KallD).astype(dt)
            for ell, (off, pN) in plan['farOffs'].items():
                src, dst = plan['farSrcDst'][ell]
                levels[ell]['K'] = jax.lax.slice_in_dim(KallD, off, off + pN)
                levels[ell]['src'] = _jd(src, INDEX)
                levels[ell]['dst'] = _jd(dst, INDEX)

        op = H2Matrix(Anear, _jd(plan['leafDofs'], INDEX),
                      jnp.asarray(plan['leafPhi'], dtype=dt),
                      (plan['lvlIdx'], plan['posIdx']),
                      levels, N, symmetric=kernel.symmetric)
        return op

    def planH2(self):
        """Host-side H2 plan: tree, admissibility, transfer matrices, leaf
        integrals, far-field Chebyshev grids — all METADATA (O(N·M) host
        arrays), no kernel evaluations and no near-field data.  Shared by
        getH2 (single-device) and DistributedH2Matrix.assemble
        (partition-FIRST distributed assembly, ref partitionDoFs /
        createLocalStuff nonlocalAssembly pxi:2401-2424)."""
        from .h2 import (buildClusterTree, admissibleClusters,
                         batchedChebyshevGrids, batchedLagrangeEval)
        from ..fem.quadrature import simplexCompact
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        N = dm.num_dofs
        dim = mesh.dim
        mdim = mesh.manifold_dim

        # ---- parameters (ref getH2RefinementParams pxi:2983-3046)
        sing = kernel.max_singularity
        mp_target = self.params.get('target_order')
        if mp_target is None:
            smin = max(-0.5 * (kernel.min_singularity + 1), 0.0)
            mp_target = (dm.polynomialOrder + 1 - smin) if mdim == 1 else 0.5
        loggamma = abs(np.log(0.25))
        m = self.params.get('interpolation_order')
        if m is None:
            m = max(int(np.ceil((2 * mp_target + max(-sing, 2)) *
                                abs(np.log(mesh.hmin / mesh.diam))
                                / loggamma / 3.0)), 2)
        eta = self.params.get('eta', 3.0)
        minSize = self.params.get('minClusterSize', max(m ** dim // 2, 1))
        M = m ** dim
        # device dtype for the far-field pipeline (grids, K, T, leaf Phi):
        # without this the float64 numpy inputs would silently put the far
        # field of an f32 build into f64
        dt = self.params.get('dtype') or REAL

        # ---- tree + admissibility (host)
        nodes = buildClusterTree(dm, minSize)
        if kernel.variable:
            from .h2 import splitLeavesByKernelBlocks
            nodes = splitLeavesByKernelBlocks(nodes, dm, kernel)
        Pfar, Pnear = admissibleClusters(
            kernel, nodes, eta, m, dim,
            minFarFieldBlockSize=self.params.get('minFarFieldBlockSize'))

        nLvl = max(nd.level for nd in nodes) + 1
        byLevel = [[] for _ in range(nLvl)]
        for nd in nodes:
            byLevel[nd.level].append(nd.id)
        pos = {}
        for ell in range(nLvl):
            for p_, nid in enumerate(byLevel[ell]):
                pos[nid] = p_

        # ---- transfer matrices per level (child coeffs -> parent coeffs;
        # batched over the level's nodes -- the per-node python loop is the
        # host bottleneck past ~100k dofs)
        sizes = [len(byLevel[ell]) for ell in range(nLvl)]
        Thost = [None]
        parentIdxH = [None]
        for ell in range(1, nLvl):
            ids = byLevel[ell]
            childBoxes = np.stack([nodes[nid].box for nid in ids])
            parBoxes = np.stack([nodes[nodes[nid].parent].box
                                 for nid in ids])
            pidx = np.fromiter((pos[nodes[nid].parent] for nid in ids),
                               dtype=np.int64, count=len(ids))
            gridC = batchedChebyshevGrids(m, childBoxes)       # [size, M, d]
            Thost.append(batchedLagrangeEval(m, parBoxes, gridC))
            parentIdxH.append(pidx)

        # ---- far-field Chebyshev grids: all node grids built in one
        # vectorized shot; level-major concatenation padded to a power of
        # two (O(1) compiled far-field shapes in N)
        farIds = sorted({nid for cplist in Pfar.values()
                         for pair in cplist for nid in pair})
        farGi = farGj = gridsAll = None
        farOffs = {}
        farSrcDst = {}
        farRows = {}
        if farIds:
            gridsAll = batchedChebyshevGrids(
                m, np.stack([nodes[nid].box for nid in farIds]))
            gridRow = {nid: k for k, nid in enumerate(farIds)}
            riAll, rjAll = [], []
            off = 0
            for ell in sorted(Pfar.keys()):
                cplist = Pfar[ell]
                pN = len(cplist)
                ri = np.fromiter((gridRow[i] for (i, j) in cplist),
                                 dtype=np.int64, count=pN)
                rj = np.fromiter((gridRow[j] for (i, j) in cplist),
                                 dtype=np.int64, count=pN)
                riAll.append(ri)
                rjAll.append(rj)
                farRows[ell] = (ri, rj)
                farSrcDst[ell] = (
                    np.fromiter((pos[j] for (i, j) in cplist),
                                dtype=np.int64, count=pN),
                    np.fromiter((pos[i] for (i, j) in cplist),
                                dtype=np.int64, count=pN))
                farOffs[ell] = (off, pN)
                off += pN
            farGi = gridsAll[np.concatenate(riAll)]            # [Ptot, M, d]
            farGj = gridsAll[np.concatenate(rjAll)]
            Ptot = farGi.shape[0]
            Ppad = 256
            while Ppad < Ptot:
                Ppad *= 2
            if Ppad > Ptot:
                padG = np.zeros((Ppad - Ptot,) + farGi.shape[1:])
                farGi = np.concatenate([farGi, padG], axis=0)
                farGj = np.concatenate([farGj, padG + 1.0], axis=0)

        # ---- leaf integrals Phi_A[i, k] = int phi_i L_k^A
        leaves = [nd for nd in nodes if nd.isLeaf]
        maxLeafN = max(len(nd.dofs) for nd in leaves)
        L = len(leaves)
        leafDofs = np.full((L, maxLeafN), -1, dtype=np.int64)
        leafPhi = np.zeros((L, maxLeafN, M))
        lvlIdx = np.zeros(L, dtype=np.int64)
        posIdx = np.zeros(L, dtype=np.int64)

        # per-cell quadrature data
        p_el = max(dm.polynomialOrder, 1)
        bary, wq = simplexCompact(p_el + m + 1, mdim)
        PHIel = dm.evalPhi(bary)                      # [dpe, Q]
        V = mesh.vertices[mesh.cells]
        Xq = np.einsum('qk,ckd->cqd', bary, V)        # [C, Q, dim]
        vols = mesh.simplexVolumes()
        d = dm.dofs
        dpe = dm.dofs_per_element
        # dof -> (leaf, slot)
        dofLeaf = np.full(N, -1, dtype=np.int64)
        dofSlot = np.full(N, -1, dtype=np.int64)
        for li, nd in enumerate(leaves):
            leafDofs[li, :len(nd.dofs)] = nd.dofs
            dofLeaf[nd.dofs] = li
            dofSlot[nd.dofs] = np.arange(len(nd.dofs))
            lvlIdx[li] = nd.level
            posIdx[li] = pos[nd.id]
        # accumulate integrals: fully vectorized over (cell, leaf) incidence
        # pairs, chunked to bound the [B, M, Q] Lagrange intermediate (the
        # former per-cell python loop was the host bottleneck past ~50k dofs)
        Cn = mesh.num_cells
        cIdx = np.repeat(np.arange(Cn), dpe)
        dFlat = d.reshape(-1)
        ok = dFlat >= 0
        pairsCL = np.unique(
            np.stack([cIdx[ok], dofLeaf[dFlat[ok]]], axis=1), axis=0)
        cp, lp = pairsCL[:, 0], pairsCL[:, 1]
        leafBoxes = np.stack([nd.box for nd in leaves])        # [L, dim, 2]
        PW = PHIel * wq[None, :]                               # [dpe, Q]
        flatPhi = leafPhi.reshape(L * maxLeafN, M)
        Q_ = Xq.shape[1]
        chunkB = max(1, (1 << 24) // max(M * Q_, 1))
        for s0 in range(0, len(cp), chunkB):
            sl = slice(s0, s0 + chunkB)
            cs, ls = cp[sl], lp[sl]
            Lk = batchedLagrangeEval(m, leafBoxes[ls], Xq[cs])  # [B, M, Q]
            contrib = np.einsum('b,lq,bmq->blm', vols[cs], PW, Lk)
            dcs = d[cs]                                         # [B, dpe]
            valid = dcs >= 0
            dsafe = np.where(valid, dcs, 0)
            sel = valid & (dofLeaf[dsafe] == ls[:, None])
            flat = ls[:, None] * maxLeafN + np.where(sel, dofSlot[dsafe], 0)
            np.add.at(flatPhi, flat[sel], contrib[sel])
        leafPhi = flatPhi.reshape(L, maxLeafN, M)

        return dict(nodes=nodes, Pfar=Pfar, Pnear=Pnear, m=m, M=M, dt=dt,
                    nLvl=nLvl, byLevel=byLevel, pos=pos, sizes=sizes,
                    Thost=Thost, parentIdxH=parentIdxH,
                    farGi=farGi, farGj=farGj, farOffs=farOffs,
                    farSrcDst=farSrcDst, farRows=farRows, gridsAll=gridsAll,
                    leafDofs=leafDofs, leafPhi=leafPhi, lvlIdx=lvlIdx,
                    posIdx=posIdx, maxLeafN=maxLeafN)

    def _assembleNearField(self, Pnear, nodes):
        """Near field of the H2 operator (see getH2 docstring).

        Masked, deduplicated cell-pair assembly + per-cluster-pair boundary
        surface integrals (ref assembleClusters 'cluster exterior',
        pxi:1975-2035)."""
        from .panels import classifyPairList
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        N = dm.num_dofs
        dofs = dm.dofs
        dpe = dm.dofs_per_element
        mdim = mesh.manifold_dim
        C = mesh.num_cells

        assert not kernel.finiteHorizon, \
            'H2 for finite horizon goes through getH2FiniteHorizon'

        # dof -> cells incidence
        mask = dofs >= 0
        cc, ll = np.nonzero(mask)

        # per-near-node sorted cell lists (the former per-pair scipy fancy
        # indexing cost ~0.5ms/pair -- dominant at 100k+ cluster pairs)
        nearIds = sorted({n for pair in Pnear for n in pair})
        nodeRow = np.full(len(nodes), -1, dtype=np.int64)
        nodeRow[nearIds] = np.arange(len(nearIds))
        dofNode = np.full(N, -1, dtype=np.int64)
        for nid in nearIds:
            dofNode[nodes[nid].dofs] = nid
        # drop dofs of UNCOVERED nodes (partial Pnear, see Nt below): their
        # dofNode is -1 and nodeRow[-1] would alias the LAST covered node,
        # flooding its cell list with every incident cell
        dn = dofNode[dofs[cc, ll]]
        okc = dn >= 0
        lc = np.unique(np.stack([nodeRow[dn[okc]], cc[okc]],
                                axis=1), axis=0)
        ncOff = np.searchsorted(lc[:, 0], np.arange(len(nearIds) + 1))
        ncArr = lc[:, 1]

        def nodeCells(nid):
            r = nodeRow[nid]
            return ncArr[ncOff[r]:ncOff[r + 1]]

        # ---- cluster-tree dof ordering: every near node owns a contiguous
        # tree range, so near-field scatter slots become ARITHMETIC
        # (indptr[row] + blockOffset[I, J] + local column) instead of binary
        # searches -- the key to device-resident near-field assembly
        nNear = len(nearIds)
        tLen = np.fromiter((len(nodes[nid].dofs) for nid in nearIds),
                           dtype=np.int64, count=nNear)
        tStartRow = np.zeros(nNear + 1, dtype=np.int64)
        tStartRow[1:] = np.cumsum(tLen)
        # Nt == N for a full assembly; Nt < N when the caller restricted
        # Pnear to a device's pairs (DistributedH2Matrix.assemble) -- the
        # pattern then covers only the restricted nodes' tree rows and
        # treePos/dofNode stay -1 for uncovered dofs (their contributions
        # mask to the dump slot).
        perm = np.concatenate([nodes[nid].dofs for nid in nearIds])
        Nt = len(perm)
        assert Nt <= N, (Nt, N)
        treePos = np.full(N, -1, dtype=np.int64)
        treePos[perm] = np.arange(Nt)
        tStartOfNode = np.full(len(nodes), -1, dtype=np.int64)
        tStartOfNode[nearIds] = tStartRow[:-1]

        # ordered near pairs -> per-row-node partner lists sorted by tree
        # start; block offsets = exclusive prefix of partner lengths
        POrd = np.fromiter((x for pair in Pnear for x in pair),
                           dtype=np.int64).reshape(-1, 2)
        ri = nodeRow[POrd[:, 0]]
        rj = nodeRow[POrd[:, 1]]
        order = np.lexsort((tStartRow[:-1][rj], ri))
        riS, rjS = ri[order], rj[order]
        lens = tLen[rjS]
        grpStart = np.searchsorted(riS, np.arange(nNear + 1))
        total = np.zeros(len(lens) + 1, dtype=np.int64)
        total[1:] = np.cumsum(lens)
        offS = total[:-1] - np.repeat(total[grpStart[:-1]],
                                      np.diff(grpStart))
        blockOff = np.empty(len(POrd), dtype=np.int64)
        blockOff[order] = offS
        rowLen = total[grpStart[1:]] - total[grpStart[:-1]]   # [nNear]
        # (I, J) -> blockOff lookup (sorted ordered-pair keys)
        ordKeys = ri * nNear + rj
        ordSort = np.argsort(ordKeys)
        ordKeysS = ordKeys[ordSort]
        blockOffS = blockOff[ordSort]

        # tree-order CSR pattern: every row of node r has the same column
        # template (the concatenation of its partners' tree ranges)
        tmplAll = np.repeat(tStartRow[:-1][rjS], lens) + _aranges(lens)
        tmplStart = total[grpStart[:-1]]                       # [nNear]
        rowNode = np.repeat(np.arange(nNear), tLen)            # [Nt]
        rowlens = rowLen[rowNode]
        indptrT = np.zeros(Nt + 1, dtype=np.int64)
        indptrT[1:] = np.cumsum(rowlens)
        nnz = int(indptrT[-1])
        assert nnz < (1 << 31), nnz
        colIdx = np.repeat(tmplStart[rowNode], rowlens) + _aranges(rowlens)
        indicesT = tmplAll[colIdx].astype(np.int32)
        del colIdx
        S = sp.csr_matrix((np.zeros(nnz, dtype=np.float32), indicesT,
                           indptrT), shape=(Nt, Nt))

        # dofNode (built above): membership tests dofNode[d] == I replace the
        # former O(N)-reset boolean arrays (quadratic at 100k+ dofs)
        # surface items as array chunks (cell, facetVerts, normal, mask, sgn)
        sp_cell, sp_fac, sp_nrm, sp_sgn = [], [], [], []
        sp_I, sp_J = [], []

        # jump interfaces of spatially-varying kernels (ref
        # getKernelBlocksAndJumps pxi:2352-2384): the Gauss-theorem surface
        # form of int_{U^c} gamma(x,y) dy needs [G]-corrections where the
        # radial antiderivative jumps with s(x, y)
        jumps = self._getKernelJumps() if kernel.variable else []
        if jumps:
            jF = np.stack([np.asarray(j[0]) for j in jumps]).astype(np.int64)
            jN = np.stack([np.asarray(j[1]) for j in jumps])
            jC = np.array([[j[2], j[3]] for j in jumps], dtype=np.int64)

        # unordered near pairs (the dual traversal yields both orderings)
        IJ = POrd[POrd[:, 0] <= POrd[:, 1]]

        # cell -> leaf-node incidence (nodes of the cell's dofs)
        cellNodes = np.where(dofs >= 0,
                             dofNode[np.where(dofs >= 0, dofs, 0)], -1)

        # --- surface loop (diagonal mass from outside each pair's cell
        # union): only pairs sharing at least one cell contribute; the
        # shared-cell prefilter via per-cell node-pair keys skips the
        # disjoint majority without per-pair set intersections
        nL = len(nodes)
        cn = np.sort(cellNodes, axis=1)
        adjKeys = set()
        for a in range(cn.shape[1]):
            for b_ in range(a, cn.shape[1]):
                P_, Q_ = cn[:, a], cn[:, b_]
                okc = P_ >= 0
                adjKeys.update((np.minimum(P_[okc], Q_[okc]) * nL
                                + np.maximum(P_[okc], Q_[okc])).tolist())
        ijKey = IJ[:, 0] * nL + IJ[:, 1]
        touchPair = np.fromiter((int(k) in adjKeys for k in ijKey),
                                dtype=bool, count=len(ijKey))

        pairsAdj = IJ[touchPair]
        cells = mesh.cells
        verts = mesh.vertices
        if mdim == 2 and not jumps and len(pairsAdj):
            # --- fully batched union boundaries + masks across ALL adjacent
            # cluster pairs (the former per-pair loop was the last O(pairs)
            # python component of the H2 build)
            rA = nodeRow[pairsAdj[:, 0]]
            rB = nodeRow[pairsAdj[:, 1]]
            same = pairsAdj[:, 0] == pairsAdj[:, 1]
            l1 = ncOff[rA + 1] - ncOff[rA]
            l2 = np.where(same, 0, ncOff[rB + 1] - ncOff[rB])
            totA = l1 + l2
            pid = np.repeat(np.arange(len(pairsAdj)), totA)
            locA = _aranges(totA)
            fromA = locA < l1[pid]
            idxA = np.where(fromA, ncOff[rA[pid]] + locA,
                            ncOff[rB[pid]] + locA - l1[pid])
            cellsCat = ncArr[idxA]
            # union + (count==2) intersection per (pair, cell)
            keyU, cntU = np.unique(pid * np.int64(C) + cellsCat,
                                   return_counts=True)
            pidU = keyU // C
            cellU = keyU % C
            isInter = (cntU == 2) | same[pidU]
            # boundary edges of each union: per-(pair,edge) count == 1
            e0 = cells[cellU][:, [0, 1, 2]]
            e1 = cells[cellU][:, [1, 2, 0]]
            eLo = np.minimum(e0, e1).astype(np.int64)
            eHi = np.maximum(e0, e1).astype(np.int64)
            Vn = np.int64(mesh.num_vertices)
            # two-key lexsort (packing pid into the edge key would overflow
            # int64 at large vertex/pair counts)
            eK = (eLo * Vn + eHi).reshape(-1)
            pK = np.broadcast_to(pidU[:, None], eLo.shape).reshape(-1)
            orderE = np.lexsort((eK, pK))
            ekS, pkS = eK[orderE], pK[orderE]
            firstE = np.ones(len(ekS), dtype=bool)
            firstE[1:] = (ekS[1:] != ekS[:-1]) | (pkS[1:] != pkS[:-1])
            lastE = np.ones(len(ekS), dtype=bool)
            lastE[:-1] = firstE[1:]
            bIdx = orderE[firstE & lastE]           # pid-major order
            rowIdx = bIdx // 3
            bPid = pidU[rowIdx]
            bE0 = e0.reshape(-1)[bIdx]
            bE1 = e1.reshape(-1)[bIdx]
            tb = verts[bE1] - verts[bE0]
            nrm = np.stack([tb[:, 1], -tb[:, 0]], axis=1)
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            ccb = verts[cells[cellU[rowIdx]]].mean(axis=1)
            midb = 0.5 * (verts[bE0] + verts[bE1])
            flip = np.einsum('fd,fd->f', nrm, midb - ccb) < 0
            nrm[flip] = -nrm[flip]
            bFac = np.stack([bE0, bE1], axis=1)
            # masks per (pair, intersection cell)
            iSel = np.nonzero(isInter)[0]
            iPid = pidU[iSel]
            iCell = cellU[iSel]
            Iarr = pairsAdj[iPid, 0]
            Jarr = pairsAdj[iPid, 1]
            gdS = dofs[iCell]
            validS = gdS >= 0
            nrS = np.where(validS, dofNode[np.where(validS, gdS, 0)], -1)
            rIS = (nrS == Iarr[:, None]) & validS
            rJS = (nrS == Jarr[:, None]) & validS
            # the (I x J) u (J x I) mask is nonempty iff the cell holds
            # dofs of BOTH nodes (masks themselves are re-derived from
            # (I, J) at run time, on device or host)
            keepS = rIS.any(axis=1) & rJS.any(axis=1)
            kPid = iPid[keepS]
            kCell = iCell[keepS]
            # cartesian (kept inter cell) x (pair's boundary facets)
            nFac = np.bincount(bPid, minlength=len(pairsAdj))
            facOff = np.zeros(len(pairsAdj) + 1, dtype=np.int64)
            facOff[1:] = np.cumsum(nFac)
            rep = nFac[kPid]
            if rep.sum():
                posF = np.repeat(facOff[kPid], rep) + _aranges(rep)
                sp_cell.append(np.repeat(kCell, rep))
                sp_fac.append(bFac[posF])
                sp_nrm.append(nrm[posF])
                sp_I.append(np.repeat(pairsAdj[kPid, 0], rep))
                sp_J.append(np.repeat(pairsAdj[kPid, 1], rep))
                sp_sgn.append(np.ones(int(rep.sum())))
            pairsLoop = pairsAdj[:0]
        else:
            pairsLoop = pairsAdj

        for (I, J) in pairsLoop:
            cells1 = nodeCells(I)
            cells2 = nodeCells(J)
            if I == J:
                U = inter = cells1
            else:
                # both lists are sorted-unique: one unique gives union AND
                # (count==2) intersection
                U, ucnt = np.unique(np.concatenate([cells1, cells2]),
                                    return_counts=True)
                inter = U[ucnt == 2]

            # --- surface of the union (diagonal mass from outside U)
            if len(inter):
                facets, normals = _cellSetBoundary(mesh, U)
                gdS = dofs[inter]                           # [nI, dpe]
                validS = gdS >= 0
                gvalS = np.where(validS, gdS, 0)
                rIS = (dofNode[gvalS] == I) & validS
                rJS = (dofNode[gvalS] == J) & validS
                keepIdx = np.nonzero(rIS.any(axis=1) & rJS.any(axis=1))[0]
                nK = len(keepIdx)
                F = len(facets)
                if nK and F:
                    cK = inter[keepIdx]
                    sp_cell.append(np.repeat(cK, F))
                    sp_fac.append(np.tile(facets, (nK, 1)))
                    sp_nrm.append(np.tile(normals, (nK, 1)))
                    sp_I.append(np.full(nK * F, I, dtype=np.int64))
                    sp_J.append(np.full(nK * F, J, dtype=np.int64))
                    sp_sgn.append(np.ones(nK * F))
                    # jump facets strictly inside U^c: two runs with the
                    # order evaluated on either side, difference weighted by
                    # the facet normal (ref assembleClusters pxi:2032-2108)
                    if jumps:
                        outside = ~(np.isin(jC[:, 0], U)
                                    | np.isin(jC[:, 1], U))
                        jIdx = np.nonzero(outside)[0]
                        nJ = len(jIdx)
                        if nJ:
                            for sgn in (1.0, -1.0):
                                sp_cell.append(np.repeat(cK, nJ))
                                sp_fac.append(np.tile(jF[jIdx], (nK, 1)))
                                sp_nrm.append(np.tile(jN[jIdx], (nK, 1)))
                                sp_I.append(np.full(nK * nJ, I,
                                                    dtype=np.int64))
                                sp_J.append(np.full(nK * nJ, J,
                                                    dtype=np.int64))
                                sp_sgn.append(np.full(nK * nJ, sgn))

        pairMasks = _PatternMaskLookup(np.zeros(0, dtype=np.int64), C,
                                       dofs, dofNode, cellNodes)

        # ---- singular (id + vertex/edge-touching) pairs, processed once
        # globally with incidence masks (the union of the per-cluster-pair
        # exact masks; entries are disjoint across cluster pairs)
        from .panels import _cellAdjacency
        adj = _cellAdjacency(mesh.cells, mesh.num_vertices)
        pi = np.concatenate([np.arange(C, dtype=np.int64), adj[:, 0]])
        pj = np.concatenate([np.arange(C, dtype=np.int64), adj[:, 1]])
        info = self._makeRules(classifyPairList(
            dm, kernel, pi, pj,
            target_order=self.params.get('target_order')))
        adjKeysSorted = np.sort(adj[:, 0] * C + adj[:, 1]) if len(adj) \
            else np.zeros(0, dtype=np.int64)
        surf = None
        if sp_cell:
            surf = (np.concatenate(sp_cell),
                    np.concatenate(sp_fac, axis=0),
                    np.concatenate(sp_nrm, axis=0),
                    np.concatenate(sp_I),
                    np.concatenate(sp_J),
                    np.concatenate(sp_sgn))

        def makeAcc():
            # accumulator over the TREE-ordered pattern; global-dof host
            # contributions translate through treePos
            if _onAccelerator() or self.params.get('forceDeviceCSR'):
                return DeviceCSRAccumulator(S, C, pairMasks,
                                            dtype=self.params.get('dtype'),
                                            treePos=treePos)
            return CSRAccumulator(S, treePos=treePos,
                                  dtype=self.params.get('dtype'))

        def runAll(acc):
            self._runPairBuckets(acc, info, maskLookup=pairMasks)
            # distant near pairs: per-cluster-pair processing with exact
            # (I x J) masks -- no global dedup needed (pattern entries
            # belong to exactly one leaf pair), arithmetic device slots
            self._runNearDistantTree(
                acc, IJ, nodeRow, nNear, ncArr, ncOff, ordKeysS, blockOffS,
                treePos, dofNode, tStartOfNode, indptrT, info, pairMasks,
                adjKeysSorted)
            if surf is not None:
                self._runUnionSurface(acc, surf, nodeRow, nNear, ordKeysS,
                                      blockOffS, treePos, dofNode,
                                      tStartOfNode, indptrT)
            # regional operator: subtract the Omega x Omega^c part that the
            # union surfaces added (ref assembleClusters pxi:2110-2143)
            if not self.zeroExterior and not kernel.finiteHorizon:
                self._addZeroExterior(acc, sign=-1.0)

        sig = ('near', self.kernel, N, C, dm.polynomialOrder,
               str(self.params.get('dtype')), self.zeroExterior,
               mesh.vertices[0].tobytes(), mesh.vertices[-1].tobytes())
        if _parallelCompileWorthIt() and sig not in _HARVESTED:
            with _harvest():
                runAll(makeAcc())
            _HARVESTED.add(sig)
        acc = makeAcc()
        runAll(acc)

        At = acc.result()
        if self.params.get('nearFormat', 'blocks') == 'csr':
            return _treeCSRToGlobal(At, perm, tLen, rowLen, tStartRow,
                                    tmplAll, tmplStart, indptrT, N)
        # default: batched block-dense near field (the tree data never
        # leaves the device; a global CSR view materializes lazily)
        from .h2 import TreeNearOperator, _TreeNearMeta
        meta = _TreeNearMeta(indptrT, tmplAll, tmplStart, tStartRow, tLen,
                             rowLen, perm, N,
                             partners=(rjS, grpStart))
        return TreeNearOperator(At.data, meta,
                                dtype=self.params.get('dtype'))

    def _runNearDistantTree(self, acc, IJ, nodeRow, nNear, ncArr, ncOff,
                            ordKeysS, blockOffS, treePos, dofNode,
                            tStartOfNode, indptrT, info, pairMasks,
                            adjKeysSorted=None):
        """Distant bulk of the H2 near field (see _bucket_tree_csr_scan).

        Chunked over cluster pairs: enumerate cells(I) x cells(J), drop
        id/touching pairs (handled by the singular path), dedup WITHIN each
        cluster pair only, bucket by quadrature order, and launch the
        device scan with per-pair (I, J, blockOffsets).  Host cost is
        O(pairs) enumeration + order model; nothing per-entry."""
        from .panels import distantOrders, _cellDiameter
        dm, mesh = self.dm, self.mesh
        kernel = self.kernel
        C = mesh.num_cells
        cells = mesh.cells
        mp = {k: info[k] for k in ('target_order', 'H0', 'hmin', 'num_dofs',
                                   'smin', 'smax')}
        centers = mesh.vertices[cells].mean(axis=1)
        hs = _cellDiameter(mesh.vertices, cells)
        dtype = self.params.get('dtype') or REAL

        deviceAcc = isinstance(acc, DeviceCSRAccumulator)
        runner = _BucketRunner(mesh.vertices, kernel, dtype=dtype)
        if not kernel.symmetric or getattr(kernel, 'phi', None) is not None:
            # nonsym / phi-weighted kernels: globally-deduped pair list
            # through the per-pair entry-mask path (incidence masks +
            # pattern drop); correct for both orderings via _runPairBuckets
            self._runNearDistantLegacy(acc, IJ, nodeRow, ncArr, ncOff,
                                       pairMasks)
            return

        rIp = nodeRow[IJ[:, 0]]
        rJp = nodeRow[IJ[:, 1]]
        n1 = ncOff[rIp + 1] - ncOff[rIp]
        n2 = ncOff[rJp + 1] - ncOff[rJp]
        tot = n1 * n2
        cum = np.cumsum(tot)

        # native C++ enumerator scalars (see nearfield_native /
        # native/nearfield_enum.cpp -- mirrors distantOrders in f32)
        logh32 = np.log(hs).astype(np.float32)
        if mesh.manifold_dim == 1:
            svalN = float(max(mp['smin'], mp['smax']))
            s2N = 0.0
            cOrderN = float(np.float32(
                (mp['target_order'] + 2.0)
                * np.log(mp['num_dofs'] * mp['H0'])))
        else:
            svalN = 0.0
            s2N = float(max(-0.5 * (kernel.max_singularity + 2), 0.0))
            cOrderN = float(np.float32(
                (0.5 * mp['target_order'] + 0.5)
                * np.log(mp['num_dofs'] * mp['H0'] ** 2)))
        logH0N = float(np.float32(np.log(mp['H0'])))
        adjK = adjKeysSorted if adjKeysSorted is not None \
            else np.zeros(0, dtype=np.int64)

        if deviceAcc and not os.environ.get('PYNUCLEUS_TPU_HOST_ENUM'):
            # device-side enumeration: only per-CLUSTER-pair descriptors
            # cross the link (see _enum_phase1/_enum_phase2)
            consts = (svalN, cOrderN, logH0N) if mesh.manifold_dim == 1 \
                else (s2N, cOrderN, logH0N)
            self._runNearDistantDeviceEnum(
                acc, runner, IJ, rIp, rJp, tot, ncArr, ncOff, nodeRow,
                nNear, ordKeysS, blockOffS, treePos, dofNode, tStartOfNode,
                indptrT, consts, logh32, centers)
            return

        def emitChunk(p0, p1, totc):
            """(lo, hi, pidx, rounded orders) for cluster pairs [p0, p1)."""
            from ..nearfield_native import enumerateNearPairs
            try:
                res = enumerateNearPairs(
                    rIp, rJp, p0, p1, ncOff, ncArr, adjK, centers, logh32,
                    mesh.manifold_dim, svalN, s2N, cOrderN, logH0N,
                    cap=int(totc.sum()), C=C)
            except Exception:                                # noqa: BLE001
                res = None
            if res is not None:
                return res
            # numpy fallback (no native toolchain)
            T = int(totc.sum())
            pe = np.repeat(np.arange(p0, p1), totc)
            off = np.repeat(np.cumsum(totc) - totc, totc)
            loc = np.arange(T) - off
            aa = ncArr[ncOff[rIp[pe]] + loc // n2[pe]]
            bb = ncArr[ncOff[rJp[pe]] + loc % n2[pe]]
            lo = np.minimum(aa, bb)
            hi = np.maximum(aa, bb)
            keep = lo != hi
            # within-cluster-pair dedup (cells incident to both I and J
            # yield both orderings of the same unordered pair); two-key
            # lexsort -- packing (pe, lo, hi) into one int64 would overflow
            # for multi-million-cell meshes
            peK, loK, hiK = pe[keep], lo[keep], hi[keep]
            cellKey = loK * C + hiK
            srtD = np.lexsort((cellKey, peK))
            peK, cellKey = peK[srtD], cellKey[srtD]
            uniq = np.ones(len(peK), dtype=bool)
            uniq[1:] = (peK[1:] != peK[:-1]) | (cellKey[1:] != cellKey[:-1])
            pidx = peK[uniq]
            rem = cellKey[uniq]
            lo = rem // C
            hi = rem % C
            # exclude touching pairs (singular path handles them): one
            # binary search over the small sorted adjacency key set
            if len(adjK):
                kq = lo * C + hi
                pos = np.minimum(np.searchsorted(adjK, kq), len(adjK) - 1)
                sh = adjK[pos] == kq
            else:
                sh = (cells[lo][:, :, None] ==
                      cells[hi][:, None, :]).any(axis=(1, 2))
            lo, hi, pidx = lo[~sh], hi[~sh], pidx[~sh]
            if len(lo) == 0:
                return lo, hi, pidx, lo
            orders = distantOrders(dm, kernel, hs, centers, lo, hi, mp)
            orders = ((orders + 1) // 2) * 2
            # DETERMINISTIC bucket merge: (8,16] -> 16, >16 -> next multiple
            # of 8.  A chunk-max snap would make a pair's quadrature order
            # depend on its chunk-mates, breaking parity between full and
            # device-restricted assemblies (DistributedH2Matrix.assemble).
            orders = np.where(orders > 16, ((orders + 7) // 8) * 8, orders)
            orders = np.where((orders > 8) & (orders <= 16), 16, orders)
            return lo, hi, pidx, orders

        CHUNK = 1 << 23
        p0 = 0
        nLaunched = 0
        while p0 < len(IJ):
            p1 = min(int(np.searchsorted(cum, (cum[p0 - 1] if p0 else 0)
                                         + CHUNK)) + 1, len(IJ))
            p1 = max(p1, p0 + 1)
            totc = tot[p0:p1]
            if int(totc.sum()) == 0:
                p0 = p1
                continue
            lo, hi, pidx, orders = emitChunk(p0, p1, totc)
            if len(lo) == 0:
                p0 = p1
                continue
            # BACKPRESSURE: async dispatch can run ahead of execution, and
            # every in-flight launch pins its staged [nCh, chunk] argument
            # buffers in host RAM.  Syncing on the accumulator each chunk
            # bounds in-flight memory to one chunk's worth; what it costs
            # on the H100 is not yet measured.
            if deviceAcc and nLaunched:
                jax.block_until_ready(acc.data)
            nLaunched += 1
            # one stable sort by order -> contiguous per-bucket slices
            # (beats per-order boolean selects over the 6 full arrays)
            srt = np.argsort(orders, kind='stable')
            lo, hi, pidx, orders = lo[srt], hi[srt], pidx[srt], orders[srt]
            Inid = IJ[pidx, 0]
            Jnid = IJ[pidx, 1]
            rIn = nodeRow[Inid]
            rJn = nodeRow[Jnid]
            offF = blockOffS[np.searchsorted(ordKeysS, rIn * nNear + rJn)]
            offB = blockOffS[np.searchsorted(ordKeysS, rJn * nNear + rIn)]
            uniq = np.unique(orders)
            bounds = np.searchsorted(orders, uniq)
            bounds = np.append(bounds, len(orders))
            for k_, o in enumerate(uniq):
                sl = slice(int(bounds[k_]), int(bounds[k_ + 1]))
                self._launchTreeBucket(
                    acc, runner, int(o), lo[sl], hi[sl], Inid[sl],
                    Jnid[sl], offF[sl], offB[sl], treePos, dofNode,
                    tStartOfNode, indptrT, deviceAcc)
            p0 = p1

    def _runNearDistantDeviceEnum(self, acc, runner, IJ, rIp, rJp, tot,
                                  ncArr, ncOff, nodeRow, nNear, ordKeysS,
                                  blockOffS, treePos, dofNode, tStartOfNode,
                                  indptrT, consts, logh32, centers):
        """Distant near-field bulk with DEVICE-side enumeration.

        Host cost and host->device traffic are O(|Pnear|) cluster-pair
        descriptors; everything per cell pair (enumeration, dedup, the f32
        order model, masks, slots, quadrature) happens on device (see
        _enum_phase1/_enum_phase2 above; ref assembleClusters
        nonlocalAssembly pxi:1663 runs the same loop per-pair on the host).
        """
        dm, mesh = self.dm, self.mesh
        kernel = self.kernel
        dtype = runner.dtype
        dofs = dm.dofs
        mdim = mesh.manifold_dim

        if not hasattr(acc, '_treeDev'):
            acc._treeDev = (
                _jd(mesh.cells, INDEX),
                _jd(mesh.simplexVolumes(), dtype),
                _jd(dofs, INDEX),
                _jd(treePos, INDEX),
                _jd(dofNode, INDEX),
                _jd(indptrT, jnp.int32),
                _jd(tStartOfNode, jnp.int32))
        cellsD, volsD, dofsD, treePosD, dofNodeD, indptrD, tStartD = \
            acc._treeDev
        if not hasattr(acc, '_enumDev'):
            cellNodes = np.where(dofs >= 0,
                                 dofNode[np.where(dofs >= 0, dofs, 0)], -1)
            acc._enumDev = (
                _jd(ncArr.astype(np.int32), jnp.int32),
                _jd(cellNodes.astype(np.int32), jnp.int32),
                _jd(np.ascontiguousarray(centers.T.astype(np.float32)),
                    jnp.float32),
                _jd(logh32, jnp.float32))
        ncArrD, cellNodesD, centersD, loghD = acc._enumDev
        cA = jnp.float32(consts[0])
        cB = jnp.float32(consts[1])
        cC = jnp.float32(consts[2])

        minOrder = 0
        if os.environ.get('PYNUCLEUS_TPU_BLOCK_NEAR', '1') != '0':
            # block path handles all low orders; the flat loop below runs
            # only the high orders of the few pairs that contain them
            highSel = self._runNearBlocks(
                acc, runner, IJ, rIp, rJp, ncArr, ncOff, nodeRow, nNear,
                ordKeysS, blockOffS, tStartOfNode, indptrT, consts)
            if not highSel.any():
                return
            IJ = IJ[highSel]
            rIp = rIp[highSel]
            rJp = rJp[highSel]
            tot = tot[highSel]
            minOrder = _LOW_ORDER_MAX + 1

        # per-cluster-pair descriptors (int32; a few MB at any ladder size)
        offI = ncOff[rIp].astype(np.int32)
        offJ = ncOff[rJp].astype(np.int32)
        n2v = (ncOff[rJp + 1] - ncOff[rJp]).astype(np.int32)
        IA = IJ[:, 0].astype(np.int32)
        JA = IJ[:, 1].astype(np.int32)
        rI = nodeRow[IJ[:, 0]]
        rJ = nodeRow[IJ[:, 1]]
        offF = blockOffS[np.searchsorted(
            ordKeysS, rI * nNear + rJ)].astype(np.int32)
        offB = blockOffS[np.searchsorted(
            ordKeysS, rJ * nNear + rI)].astype(np.int32)

        cumTot = np.zeros(len(tot) + 1, dtype=np.int64)
        cumTot[1:] = np.cumsum(tot)
        SEG = 1 << int(os.environ.get('PYNUCLEUS_TPU_ENUM_SEG', '25'))
        prof = os.environ.get('PYNUCLEUS_TPU_ENUM_PROF')
        import time as _time
        q0 = 0
        while q0 < len(IJ):
            # largest q1 with segment total <= SEG (at least one pair)
            q1 = int(np.searchsorted(cumTot, cumTot[q0] + SEG,
                                     side='right')) - 1
            q1 = min(max(q1, q0 + 1), len(IJ))
            Treal = int(cumTot[q1] - cumTot[q0])
            if Treal == 0:
                q0 = q1
                continue
            nP = q1 - q0
            nPpad = _nch_pad(nP)
            cumP = np.full(nPpad + 1, Treal, dtype=np.int32)
            cumP[:nP + 1] = (cumTot[q0:q1 + 1] - cumTot[q0]).astype(np.int32)

            def padP(a, fill=0):
                out = np.full(nPpad, fill, dtype=np.int32)
                out[:nP] = a[q0:q1]
                return _jd(out, jnp.int32)

            cumD = _jd(cumP, jnp.int32)
            offID, offJD = padP(offI), padP(offJ)
            n2D = padP(n2v, fill=1)
            IAD, JAD = padP(IA, fill=-1), padP(JA, fill=-1)
            offFD, offBD = padP(offF), padP(offB)
            Tpad = _nch_pad(Treal)
            t0p = _time.perf_counter()
            keys, pT, hist = _launch(
                _enum_phase1, cumD, offID, offJD, n2D, IAD, JAD, ncArrD,
                cellsD, cellNodesD, centersD, loghD, cA, cB, cC,
                jnp.int32(Treal), _statics=dict(Tpad=Tpad, mdim=mdim),
                _force=True)
            hist = np.asarray(hist)
            if prof:
                jax.block_until_ready(keys)
                print(f'  [enum seg q={q0}:{q1} T={Treal} '
                      f'phase1={_time.perf_counter()-t0p:.2f}s]', flush=True)
            for o in np.nonzero(hist[:_ENUM_SENTINEL])[0]:
                o = int(o)
                if o < minOrder:
                    continue
                count = int(hist[o])
                rule = distantRule(o, mdim)
                PSI = rule.buildPSI(dm, nSharedVertices=0)
                PSIP = _jd(_psi_prod(PSI), dtype)
                bary_x = _jd(rule.bary_x, dtype)
                bary_y = _jd(rule.bary_y, dtype)
                w = _jd(rule.w, dtype)
                Q = rule.num_nodes
                maxP = max(min(MAX_PAIRS_PER_LAUNCH,
                               (1 << 25) // max(Q, 1)), 256)
                chunk = _chunk_size(min(maxP, count))
                nCh = _nch_pad((count + chunk - 1) // chunk)
                t0p = _time.perf_counter()
                acc.data = _launch(
                    _enum_phase2, acc.data, keys, pT, cumD, offID, offJD,
                    n2D, IAD, JAD, offFD, offBD, ncArrD, runner.vertices,
                    cellsD, volsD, dofsD, treePosD, dofNodeD, indptrD,
                    tStartD, jnp.int32(o), jnp.int32(count), bary_x,
                    bary_y, w, PSIP,
                    _statics=dict(chunk=chunk, nCh=nCh, kernel=kernel))
                if prof:
                    jax.block_until_ready(acc.data)
                    print(f'    [o={o} count={count} Q={Q} chunk={chunk} '
                          f'nCh={nCh} {_time.perf_counter()-t0p:.2f}s]',
                          flush=True)
            keys = pT = None
            q0 = q1

    def _runNearBlocks(self, acc, runner, IJ, rIp, rJp, ncArr, ncOff,
                       nodeRow, nNear, ordKeysS, blockOffS, tStartOfNode,
                       indptrT, consts):
        """Low-order bulk of the near field as dense cluster-pair blocks
        (see the _block_near_quad section comment).  Returns the boolean
        per-pair mask of pairs containing order > _LOW_ORDER_MAX elements
        (those few run through the flat per-element path afterwards)."""
        from ..fem.quadrature import simplexCompact
        dm, mesh = self.dm, self.mesh
        kernel = self.kernel
        dtype = runner.dtype
        mdim = mesh.manifold_dim
        cellsD, volsD, dofsD, treePosD, dofNodeD, indptrD, tStartD = \
            acc._treeDev
        ncArrD, cellNodesD, centersD, loghD = acc._enumDev
        cA = jnp.float32(consts[0])
        cB = jnp.float32(consts[1])
        cC = jnp.float32(consts[2])
        nnz = int(indptrT[-1])
        nP = len(IJ)

        n1v = (ncOff[rIp + 1] - ncOff[rIp]).astype(np.int32)
        n2v = (ncOff[rJp + 1] - ncOff[rJp]).astype(np.int32)
        offI = ncOff[rIp].astype(np.int32)
        offJ = ncOff[rJp].astype(np.int32)
        IA = IJ[:, 0].astype(np.int32)
        JA = IJ[:, 1].astype(np.int32)
        offF = blockOffS[np.searchsorted(
            ordKeysS, nodeRow[IJ[:, 0]] * nNear + nodeRow[IJ[:, 1]])]
        offB = blockOffS[np.searchsorted(
            ordKeysS, nodeRow[IJ[:, 1]] * nNear + nodeRow[IJ[:, 0]])]
        tSI = tStartOfNode[IJ[:, 0]].astype(np.int32)
        tSJ = tStartOfNode[IJ[:, 1]].astype(np.int32)
        baseF = (indptrT[tSI] + offF).astype(np.int32)
        baseB = (indptrT[tSJ] + offB).astype(np.int32)
        LI = (indptrT[tSI + 1] - indptrT[tSI]).astype(np.int32)
        LJ = (indptrT[tSJ + 1] - indptrT[tSJ]).astype(np.int32)

        # global padded tree-block width (static per problem)
        tStarts = np.sort(tStartOfNode[tStartOfNode >= 0])
        Nt = len(indptrT) - 1
        tLens = np.diff(np.append(tStarts, Nt))
        nbar = _nch_pad(int(tLens.max()) if len(tLens) else 1)

        # bucket pairs by pow2-padded cell-list sizes
        def p2v(x):
            out = np.maximum(x, 1)
            p = np.full(len(out), 8, dtype=np.int64)
            while True:
                over = out > p
                if not over.any():
                    break
                p[over] *= 2
            return p

        b1s = p2v(n1v)
        b2s = p2v(n2v)
        bkey = b1s * (1 << 32) + b2s
        buckets = {}
        for key in np.unique(bkey):
            buckets[(int(key >> 32), int(key & 0xffffffff))] = \
                np.nonzero(bkey == key)[0]

        def padXs(idxs, arrs, Bc, nCh, fills):
            tot_ = nCh * Bc
            out = []
            for a, fill in zip(arrs, fills):
                v = np.full(tot_, fill, dtype=np.int32)
                v[:len(idxs)] = a[idxs]
                out.append(_jd(v.reshape(nCh, Bc), jnp.int32))
            return tuple(out)

        prof = os.environ.get('PYNUCLEUS_TPU_ENUM_PROF')
        import time as _time

        # ---- counting pass: per (pair, order class) element counts
        pairCnt = np.zeros((nP, 5), dtype=np.int64)
        for (n1p, n2p), idxs in sorted(buckets.items()):
            Bc = int(max(1, min((1 << 24) // (n1p * n2p), 1024)))
            nCh = _nch_pad((len(idxs) + Bc - 1) // Bc)
            xs = padXs(idxs, (offI, offJ, n1v, n2v, IA, JA), Bc, nCh,
                       (0, 0, 0, 0, -1, -1))
            t0p = _time.perf_counter()
            counts = _launch(
                _block_near_count, *xs, cellsD, dofsD, dofNodeD, ncArrD,
                centersD, loghD, cA, cB, cC,
                _statics=dict(n1p=n1p, n2p=n2p, mdim=mdim), _force=True)
            counts = np.asarray(counts).reshape(nCh * Bc, 5)[:len(idxs)]
            pairCnt[idxs] = counts
            if prof:
                print(f'  [blkcnt {n1p}x{n2p} pairs={len(idxs)} Bc={Bc} '
                      f'nCh={nCh} {_time.perf_counter()-t0p:.2f}s]',
                      flush=True)

        # ---- quadrature passes per (low order, size bucket)
        for k, o in enumerate((2, 4, 6, 8)):
            selo = pairCnt[:, k] > 0
            if not selo.any():
                continue
            b1q, w1q = simplexCompact(o, mdim)
            Q1 = len(w1q)
            PHI1 = dm.evalPhi(b1q)
            PHI1D = _jd(PHI1, dtype)
            B1D = _jd(b1q, dtype)
            W1D = _jd(w1q, dtype)
            for (n1p, n2p), idxs in sorted(buckets.items()):
                sel = idxs[selo[idxs]]
                if len(sel) == 0:
                    continue
                Bc = int(max(1, min(
                    (1 << 25) // (n1p * n2p * Q1 * Q1),
                    (1 << 23) // (max(n1p, n2p) * Q1 * nbar), 512)))
                nCh = _nch_pad((len(sel) + Bc - 1) // Bc)
                xs = padXs(sel, (offI, offJ, n1v, n2v, IA, JA, tSI, tSJ,
                                 baseF, baseB, LI, LJ), Bc, nCh,
                           (0, 0, 0, 0, -1, -1, 0, 0, nnz, nnz, 0, 0))
                t0p = _time.perf_counter()
                acc.data = _launch(
                    _block_near_quad, acc.data, runner.vertices, cellsD,
                    volsD, dofsD, treePosD, dofNodeD, ncArrD, centersD,
                    loghD, *xs, cA, cB, cC, PHI1D, PHI1D, B1D, B1D, W1D,
                    W1D,
                    _statics=dict(kernel=kernel, n1p=n1p, n2p=n2p,
                                  nbar=nbar, order=o, mdim=mdim))
                if prof:
                    jax.block_until_ready(acc.data)
                    print(f'  [blkquad o={o} {n1p}x{n2p} pairs={len(sel)} '
                          f'Bc={Bc} nCh={nCh} '
                          f'{_time.perf_counter()-t0p:.2f}s]', flush=True)
        return pairCnt[:, 4] > 0

    def _runNearDistantLegacy(self, acc, IJ, nodeRow, ncArr, ncOff,
                              pairMasks):
        """Nonsym/phi fallback: globally-deduped distant pairs through the
        per-pair entry-mask bucket path (id/touching already ran)."""
        from .panels import classifyPairList
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        C = mesh.num_cells
        rIp = nodeRow[IJ[:, 0]]
        rJp = nodeRow[IJ[:, 1]]
        n1 = ncOff[rIp + 1] - ncOff[rIp]
        n2 = ncOff[rJp + 1] - ncOff[rJp]
        tot = n1 * n2
        cum = np.cumsum(tot)
        keyChunks = []
        CHUNK = 1 << 25
        p0 = 0
        while p0 < len(IJ):
            p1 = min(int(np.searchsorted(cum, (cum[p0 - 1] if p0 else 0)
                                         + CHUNK)) + 1, len(IJ))
            p1 = max(p1, p0 + 1)
            totc = tot[p0:p1]
            T = int(totc.sum())
            if T:
                pe = np.repeat(np.arange(p0, p1), totc)
                off = np.repeat(np.cumsum(totc) - totc, totc)
                loc = np.arange(T) - off
                aa = ncArr[ncOff[rIp[pe]] + loc // n2[pe]]
                bb = ncArr[ncOff[rJp[pe]] + loc % n2[pe]]
                keyChunks.append(np.unique(
                    np.minimum(aa, bb) * C + np.maximum(aa, bb)))
            p0 = p1
        allKeys = np.unique(np.concatenate(keyChunks)) if keyChunks \
            else np.zeros(0, dtype=np.int64)
        info2 = classifyPairList(
            dm, kernel, allKeys // C, allKeys % C,
            target_order=self.params.get('target_order'))
        info2['id'] = np.zeros(0, dtype=np.int64)
        info2['touching'] = (np.zeros((0, 2), dtype=np.int64), [])
        info2 = self._makeRules(info2)
        self._runPairBuckets(acc, info2, maskLookup=pairMasks)

    def _launchTreeBucket(self, acc, runner, order, lo, hi, Inid, Jnid,
                          offF, offB, treePos, dofNode, tStartOfNode,
                          indptrT, deviceAcc):
        """One (chunk, order) bucket of the tree-slot near field."""
        dm, mesh = self.dm, self.mesh
        kernel = self.kernel
        dofs = dm.dofs
        mdim = mesh.manifold_dim
        rule = distantRule(order, mdim)
        PSI = rule.buildPSI(dm, nSharedVertices=0)
        P = len(lo)
        if P == 0:
            return
        if deviceAcc:
            dtype = runner.dtype
            PSIP = _jd(_psi_prod(PSI), dtype)
            bary_x = _jd(rule.bary_x, dtype)
            bary_y = _jd(rule.bary_y, dtype)
            w = _jd(rule.w, dtype)
            Q = rule.num_nodes
            maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1)),
                       256)
            chunk = _chunk_size(min(maxP, P))  # pow2 ladder: no 8192 floor
            nCh = _nch_pad((P + chunk - 1) // chunk)
            totP = nCh * chunk

            def padI(a, fill=0):
                return _jd(_pad(np.asarray(a), totP, fill=fill)
                                   .reshape(nCh, chunk), INDEX)

            sf = np.full(totP, 2.0)
            sf[P:] = 0.0
            if not hasattr(acc, '_treeDev'):
                acc._treeDev = (
                    _jd(mesh.cells, INDEX),
                    _jd(mesh.simplexVolumes(), runner.dtype),
                    _jd(dofs, INDEX),
                    _jd(treePos, INDEX),
                    _jd(dofNode, INDEX),
                    _jd(indptrT, jnp.int32),
                    _jd(tStartOfNode, jnp.int32))
            cellsD, volsD, dofsD, treePosD, dofNodeD, indptrD, tStartD = \
                acc._treeDev
            acc.data = _launch(
                _bucket_tree_csr_scan,
                acc.data, runner.vertices, cellsD, volsD, dofsD,
                treePosD, dofNodeD, indptrD, tStartD,
                padI(lo), padI(hi), padI(Inid), padI(Jnid),
                padI(offF), padI(offB),
                _jd(sf.reshape(nCh, chunk), runner.dtype),
                bary_x, bary_y, w, PSIP, _statics=dict(kernel=kernel))
        else:
            # host scatter path (CPU runs): same arithmetic slots, numpy
            nnz = acc.pattern.nnz
            vols = mesh.simplexVolumes()
            bx = _jd(rule.bary_x, runner.dtype)
            by = _jd(rule.bary_y, runner.dtype)
            wD = _jd(rule.w, runner.dtype)
            PSIP = _jd(_psi_prod(PSI), runner.dtype)
            step = max((1 << 23) // max(rule.num_nodes, 1), 1024)
            for s0 in range(0, P, step):
                sl = slice(s0, s0 + step)
                loS, hiS = lo[sl], hi[sl]
                dr = np.concatenate([dofs[loS], dofs[hiS]], axis=1)
                valid = dr >= 0
                drs = np.where(valid, dr, 0)
                nr = np.where(valid, dofNode[drs], -1)
                ta = treePos[drs]
                inI = nr == Inid[sl][:, None]
                inJ = nr == Jnid[sl][:, None]
                mF = inI[:, :, None] & inJ[:, None, :]
                mB = inJ[:, :, None] & inI[:, None, :]
                rowStart = indptrT[ta]
                colF = ta[:, None, :] - tStartOfNode[Jnid[sl]][:, None, None]
                colB = ta[:, None, :] - tStartOfNode[Inid[sl]][:, None, None]
                slot = np.where(
                    mF, rowStart[:, :, None] + offF[sl][:, None, None] + colF,
                    np.where(mB, rowStart[:, :, None]
                             + offB[sl][:, None, None] + colB, nnz))
                M = np.asarray(_launch(
                    _bucket_contrib,
                    runner.vertices, _jd(mesh.cells[loS], INDEX),
                    _jd(mesh.cells[hiS], INDEX),
                    _jd(vols[loS] * vols[hiS] * 2.0, runner.dtype),
                    bx, by, wD, PSIP, _statics=dict(kernel=kernel)))
                np.add.at(acc.data, slot.reshape(len(loS), -1), M)

    def _launchSurfaceBucket(self, acc, runner, rule, PHI, vi1, vi2, dr,
                             vs, nm, yOff, Inid, Jnid, offF, offB,
                             treePos, dofNode, tStartOfNode, indptrT):
        """One union-surface bucket into device CSR data (arithmetic tree
        slots; see `_bucket_surface_tree_scan`)."""
        mesh = self.mesh
        P = len(vi1)
        if P == 0:
            return
        dtype = runner.dtype
        dim = mesh.vertices.shape[1]
        PSIP = _jd(_psi_prod(PHI), dtype)
        bary_x = _jd(rule.bary_x, dtype)
        bary_y = _jd(rule.bary_y, dtype)
        w = _jd(rule.w, dtype)
        Q = rule.num_nodes
        maxP = max(min(MAX_PAIRS_PER_LAUNCH, (1 << 25) // max(Q, 1)), 256)
        chunk = _chunk_size(min(maxP, P))     # pow2 ladder: no 8192 floor
        nCh = _nch_pad((P + chunk - 1) // chunk)
        totP = nCh * chunk

        def padI(a, fill=0):
            return _jd(_pad(np.asarray(a), totP, fill=fill)
                       .reshape((nCh, chunk) + np.asarray(a).shape[1:]),
                       INDEX)

        def padF(a, width=None):
            if a is None:
                a = np.zeros((totP, width))
            out = _pad(np.asarray(a), totP, fill=0.0)
            return _jd(out.reshape((nCh, chunk) + out.shape[1:]), dtype)

        vsP = np.zeros(totP)
        vsP[:P] = vs
        if not hasattr(acc, '_surfDev'):
            acc._surfDev = (
                _jd(treePos, INDEX),
                _jd(dofNode, INDEX),
                _jd(indptrT, jnp.int32),
                _jd(tStartOfNode, jnp.int32))
        treePosD, dofNodeD, indptrD, tStartD = acc._surfDev
        acc.data = _launch(
            _bucket_surface_tree_scan,
            acc.data, runner.vertices, dofNodeD, treePosD, indptrD, tStartD,
            padI(vi1), padI(vi2), padI(dr, fill=-1),
            _jd(vsP.reshape(nCh, chunk), dtype),
            padF(nm, dim), padF(yOff, dim),
            padI(Inid), padI(Jnid), padI(offF), padI(offB),
            bary_x, bary_y, w, PSIP,
            _statics=dict(kernel=runner.kernel,
                          useNormals=runner.useNormals,
                          useYShift=yOff is not None))

    def _getComplementCross(self):
        """Pure cross operator of the complement kernel:
        Cross_ij = -2 int int psi_i(x) psi_j(y) gamma(x,y) 1_{|x-y|>delta}
        (the correction operator of ref horizonCorrected,
        nonlocalAssembly.pyx:243-247; gamma_c is bounded and vanishes inside
        the horizon, so every pair uses smooth tensor quadrature with the
        complement indicator on ring-cut pairs)."""
        from .panels import (_pairMinDistance, _pairMaxDistance,
                             orderModelParams, distantOrders, _cellDiameter)
        kernel = self.kernel
        assert kernel.complement
        dm, mesh = self.dm, self.mesh
        N = dm.num_dofs
        cells = mesh.cells
        verts = mesh.vertices
        dofs = dm.dofs
        dpe = dm.dofs_per_element
        hv = kernel.horizonValue
        C = mesh.num_cells
        iu, ju = np.triu_indices(C, k=0)
        dmin = _pairMinDistance(verts, cells, iu, ju)
        dmax = _pairMaxDistance(verts, cells, iu, ju)
        keep = dmax > hv
        iu, ju, dmin = iu[keep], ju[keep], dmin[keep]
        cut = dmin < hv
        mp = orderModelParams(dm, kernel, self.params.get('target_order'))
        centers = verts[cells].mean(axis=1)
        hs = _cellDiameter(verts, cells)
        acc = DenseAccumulator(N)
        runner = _BucketRunner(verts, kernel,
                               dtype=self.params.get('dtype'))
        emBlock = np.zeros((2 * dpe, 2 * dpe), dtype=bool)
        emBlock[:dpe, dpe:] = True
        emBlock[dpe:, :dpe] = True
        for isCut in (False, True):
            sel = cut == isCut
            ii, jj = iu[sel], ju[sel]
            if len(ii) == 0:
                continue
            orders = distantOrders(dm, kernel, hs, centers, ii, jj, mp) \
                if len(ii) else np.zeros(0, dtype=np.int64)
            orders = ((orders + 1) // 2) * 2
            if isCut:
                orders = np.minimum(orders + 4, 20)
            else:
                orders = np.minimum(orders, 16)
            for order in np.unique(orders):
                osel = orders == order
                oi, oj = ii[osel], jj[osel]
                # cut pairs sample the horizon indicator: dense Duffy grid
                rule = distantRule(int(order), mesh.manifold_dim,
                                   compact=not isCut)
                PSI = rule.buildPSI(dm, nSharedVertices=0)
                vols = mesh.simplexVolumes()
                dr = np.concatenate([dofs[oi], dofs[oj]], axis=1)
                vs = vols[oi] * vols[oj] * 2.0
                em = np.broadcast_to(emBlock, (len(oi),) + emBlock.shape)
                runner.run(acc, rule, PSI, cells[oi], cells[oj], dr, vs,
                           entryMask=em)
        return acc.result()

    def getH2FiniteHorizon(self):
        """Finite-horizon operator as infinite-horizon H2 + corrections
        (ref getH2FiniteHorizon pxi:3221 -> horizonCorrected
        nonlocalAssembly.pyx:182-260):
            A_delta = A_inf - Cross(gamma_c) - c_tot * Mass
        with Cross the complement cross operator and
        c_tot = 2 int_{|z|>delta} gamma(z) dz (the diagonal of the
        complement form; constant for constant s)."""
        kernel = self.kernel
        assert kernel.finiteHorizon
        assert hasattr(kernel.s, 'value'), \
            'H2corrected requires a constant fractional order'
        from .kernels import getFractionalKernel
        from ..fem.assembly import assembleMass
        infKernel = getFractionalKernel(self.dm.mesh.dim, kernel.s.value,
                                        horizon=np.inf, scaling=0.5)
        Sinf = nonlocalBuilder(self.dm, infKernel, params=self.params,
                               zeroExterior=True).getH2()
        mass = assembleMass(self.dm)
        A = horizonCorrected(self.dm, Sinf, mass)
        A.setKernel(kernel, params=self.params)
        return A

    def _getKernelJumps(self):
        """Interior facets where the cell-centered kernel order jumps:
        [(facetVerts, unitNormal, cell1, cell2)]
        (ref getKernelBlocksAndJumps pxi:2352-2384)."""
        if hasattr(self, '_jumps'):
            return self._jumps
        mesh, kernel = self.mesh, self.kernel
        centers = mesh.vertices[mesh.cells].mean(axis=1)
        sDiag = np.asarray(kernel.s(centers, centers)).reshape(-1)
        mdim = mesh.manifold_dim
        cells = mesh.cells
        out = []
        if mdim == 1:
            order = np.argsort(centers[:, 0])
            # facet between consecutive cells sharing a vertex
            vertSets = [set(int(v) for v in cells[c]) for c in range(len(cells))]
            for a, b in zip(order[:-1], order[1:]):
                shared = vertSets[a] & vertSets[b]
                if shared and abs(sDiag[a] - sDiag[b]) > 1e-12:
                    v = shared.pop()
                    out.append((np.array([v], dtype=np.int64),
                                np.array([1.0]), int(a), int(b)))
        elif mdim == 2:
            edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                    cells[:, [2, 0]]], axis=0)
            owner = np.tile(np.arange(len(cells)), 3)
            se = np.sort(edges, axis=1)
            uniq, inv = np.unique(se, axis=0, return_inverse=True)
            byEdge = {}
            for k in range(len(se)):
                byEdge.setdefault(int(inv[k]), []).append(int(owner[k]))
            verts = mesh.vertices
            for ei, owners in byEdge.items():
                if len(owners) != 2:
                    continue
                c1, c2 = owners
                if abs(sDiag[c1] - sDiag[c2]) <= 1e-12:
                    continue
                e = uniq[ei]
                t = verts[e[1]] - verts[e[0]]
                n = np.array([t[1], -t[0]])
                n /= np.linalg.norm(n)
                out.append((e.astype(np.int64), n, c1, c2))
        else:
            raise NotImplementedError(mdim)
        self._jumps = out
        return out

    def _runUnionSurface(self, acc, surfPairs, nodeRow, nNear, ordKeysS,
                         blockOffS, treePos, dofNode, tStartOfNode, indptrT):
        """Batched boundary-kernel quadrature for per-cluster-pair union
        surfaces, masked per pair.

        Each item carries its owning cluster pair (I, J); the
        (I x J) u (J x I) entry mask is re-derived from dofNode at run
        time — on device with arithmetic tree slots
        (`_bucket_surface_tree_scan`) for a DeviceCSRAccumulator, on host
        otherwise.

        Each item also carries sgn in {+1, -1}: the y quadrature points are
        nudged by sgn*eps*normal to pick the fractional-order side, and the
        contribution is weighted by sgn (for constant-order kernels the
        nudge is a no-op and sgn is always +1).  In 1D the n.(y-x)/|y-x|
        orientation factor of the boundary kernel is folded into the weight
        (2D evaluates it per quadrature point)."""
        dm, mesh, kernel = self.dm, self.mesh, self.kernel
        dofs = dm.dofs
        dpe = dm.dofs_per_element
        mdim = mesh.manifold_dim
        cells = mesh.cells
        vols = mesh.simplexVolumes()
        verts = mesh.vertices
        detfac = {1: 1.0, 2: 2.0, 3: 6.0}[mdim]
        bkernel = kernel.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
        useNormals = mdim >= 2
        runner = _BucketRunner(verts, bkernel, useNormals=useNormals,
                               dtype=self.params.get('dtype'))
        from .panels import boundaryOrderModelParams
        # MUST match _addZeroExterior's rules exactly: for the regional
        # operator the (cell, own-boundary-facet) integrals of the union
        # surface (+) and the global subtraction (-) each diverge for
        # s > 1/2 on Neumann dofs; only identical quadrature makes the
        # difference exact (ref reuses one local_matrix_zeroExterior)
        mpb = boundaryOrderModelParams(dm, bkernel,
                                       self.params.get('target_order'))
        qd = mpb['quad_order_diagonal']
        sigb = bkernel.getSingularityValue()

        cellNos, facets, normals, Iids, Jids, sgns = surfPairs
        # per-item forward/backward block offsets in the tree-ordered CSR
        rIs = nodeRow[Iids]
        rJs = nodeRow[Jids]
        offFall = blockOffS[np.searchsorted(ordKeysS, rIs * nNear + rJs)]
        offBall = blockOffS[np.searchsorted(ordKeysS, rJs * nNear + rIs)]
        deviceAcc = isinstance(acc, DeviceCSRAccumulator)
        cellNos = np.asarray(cellNos, dtype=np.int64)
        facets = np.asarray(facets, dtype=np.int64)
        S = len(cellNos)
        nvS = facets.shape[1]
        nv = mdim + 1

        needShift = self.kernel.variable
        epsShift = 1e-9

        facCenters = verts[facets].mean(axis=1) if nvS > 1 \
            else verts[facets[:, 0]]
        cellCenters = verts[cells[cellNos]].mean(axis=1)
        if nvS >= 2:
            svols = np.linalg.norm(verts[facets[:, 1]]
                                   - verts[facets[:, 0]], axis=1)
        else:
            svols = np.ones(S)

        # per-item boundary singularity: variable kernels freeze s at
        # (cell center, shifted facet center) like the reference surface
        # local matrices (nonlocalOperator evalParams)
        if kernel.variable:
            yc = facCenters + sgns[:, None] * epsShift * normals
            sv = np.asarray(kernel.s(cellCenters, yc)).reshape(-1)
            sings = np.round(1.0 - mesh.dim - 2.0 * sv, 12)
        else:
            sings = np.full(S, sigb)

        # vectorized shared-vertex classification via match signatures
        eq = cells[cellNos][:, :, None] == facets[:, None, :]   # [S, nv, nvS]
        sigBits = np.packbits(eq.reshape(S, -1), axis=1)
        uniqSig, sigInv = np.unique(sigBits, axis=0, return_inverse=True)
        permLut = []
        for u in range(uniqSig.shape[0]):
            k = int(np.argmax(sigInv == u))
            permLut.append(_sharedPermFromEq(eq[k]))
        nSharedArr = np.array([permLut[u][0]
                               for u in range(uniqSig.shape[0])],
                              dtype=np.int64)[sigInv]

        def runBucketV(rule, sel, perm1=None, perm2=None, useDet=True):
            # singular (collapsed-parametrization) rules are normalized to
            # simplex determinants; distant Sum(w)=1 rules to plain volumes
            if len(sel) == 0:
                return
            PHI = rule.buildPSI(dm, boundary=True)
            cs = cellNos[sel]
            if perm1 is not None:
                vi1 = cells[cs][:, perm1]
                vi2 = facets[sel][:, perm2]
                ld1 = permuteLocalDofs(dm, perm1)
                dr = dofs[cs][:, ld1]
            else:
                vi1 = cells[cs]
                vi2 = facets[sel]
                dr = dofs[cs]
            vs = (detfac * vols[cs] if useDet else vols[cs]) \
                * svols[sel] * sgns[sel]
            if mdim == 1:
                # fold the n.(y-x)/|y-x| orientation factor into the
                # weight (2D evaluates it per quadrature point)
                p0 = verts[facets[sel, 0], 0]
                c0 = verts[cells[cs], 0].mean(axis=1)
                vs = vs * np.sign(normals[sel, 0] * (p0 - c0))
            nm = normals[sel] if useNormals else None
            yOff = sgns[sel, None] * epsShift * normals[sel] \
                if needShift else None
            if deviceAcc:
                self._launchSurfaceBucket(
                    acc, runner, rule, PHI, vi1, vi2, dr, vs, nm, yOff,
                    Iids[sel], Jids[sel], offFall[sel], offBall[sel],
                    treePos, dofNode, tStartOfNode, indptrT)
                return
            # host accumulator: rebuild the (I x J) u (J x I) mask in the
            # (possibly permuted) local dof order
            valid = dr >= 0
            nr = np.where(valid, dofNode[np.where(valid, dr, 0)], -1)
            rI = nr == Iids[sel, None]
            rJ = nr == Jids[sel, None]
            mk = (rI[:, :, None] & rJ[:, None, :]) \
                | (rJ[:, :, None] & rI[:, None, :])
            runner.run(acc, rule, PHI, vi1, vi2, dr, vs, normals=nm,
                       entryMask=mk, yOffset=yOff)

        # touching items: group by (perm signature, singularity)
        touchSel = np.nonzero(nSharedArr > 0)[0]
        if len(touchSel):
            groups = {}
            for k in touchSel:
                groups.setdefault((int(sigInv[k]), sings[k]), []).append(k)
            from .quad_singular_2d import (boundaryEdgeRule2DSS,
                                           boundaryVertexRule2DSS)
            for (g, sig), idxs in groups.items():
                nS, perm1, perm2 = permLut[g]
                if mdim == 1:
                    rule = boundaryVertexRule1D(sig, qd)
                elif nS == 2:
                    sig_eff = sig if sig > -1 + 1e-3 else 2.0 + sig
                    rule = boundaryEdgeRule2DSS(sig_eff, qd, qd)
                else:
                    rule = boundaryVertexRule2DSS(sig, qd, qd)
                runBucketV(rule, np.asarray(idxs), perm1, perm2)

        # distant items: per-pair order via the boundary model
        distSel = np.nonzero(nSharedArr == 0)[0]
        if len(distSel):
            d = np.linalg.norm(cellCenters[distSel] - facCenters[distSel],
                               axis=1)
            h1 = np.zeros(len(distSel))
            V1 = verts[cells[cellNos[distSel]]]
            for a in range(mdim + 1):
                for bb in range(a + 1, mdim + 1):
                    h1 = np.maximum(h1, np.linalg.norm(V1[:, a] - V1[:, bb],
                                                       axis=1))
            h2 = svols[distSel] if mdim >= 2 \
                else np.full(len(distSel), mpb['hmin'])
            sv = max(0.5 * (-bkernel.min_singularity), 0.0)
            lognH = np.log(mpb['num_dofs'] * mpb['H0'])
            c0 = (mpb['target_order'] + 1.0) * lognH
            logdh1 = np.maximum(np.log(d / h1), 0.0)
            logdh2 = np.maximum(np.log(d / h2), 0.0)
            o1 = np.ceil((c0 + (2 * sv - 1) * np.abs(np.log(h2 / mpb['H0'])) -
                          2 * sv * np.log(d / h2)) / (logdh1 + 0.8))
            o2 = np.ceil((c0 + (2 * sv - 1) * np.abs(np.log(h1 / mpb['H0'])) -
                          2 * sv * np.log(d / h1)) / (logdh2 + 0.8))
            orders = np.maximum(np.maximum(o1, o2), 2).astype(np.int64)
            orders = ((orders + 1) // 2) * 2
            orders = np.minimum(orders, 24)
            # distant rules are plain tensor products (the kernel is
            # evaluated exactly per point) -> group by order only
            for order in np.unique(orders):
                sel = distSel[orders == order]
                rule = boundaryDistantRule(int(order), mdim, mdim - 1)
                runBucketV(rule, sel, None, None, useDet=False)

    def getDenseCross(self):
        """A_BC: interior x boundary coupling for inhomogeneous Dirichlet
        volume constraints (ref buildBCoperator discretizedProblems.py:511 ->
        getFracLapl(dmInterior, dm2=dmBC)).  Runs the same panel machinery;
        the accumulator keeps (interior row, boundary col) entries."""
        from .panels import classifyPairsDense
        dm = self.dm
        info = self._makeRules(classifyPairsDense(
            dm, self.kernel, target_order=self.params.get('target_order')))
        acc = BCAccumulator(dm.num_dofs, dm.num_boundary_dofs)
        self._runPairBuckets(acc, info)
        if self.zeroExterior:
            self._addZeroExterior(acc)
        return acc.result()

    def _addZeroExterior(self, acc, sign=1.0):
        """Surface (Gauss-theorem) term into an accumulator."""
        dm, mesh = self.dm, self.mesh
        kernel = self.kernel
        surface = mesh.get_surface_mesh()
        bkernel = kernel.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
        deviceAcc = isinstance(acc, DeviceDenseAccumulator)
        csrAcc = isinstance(acc, (CSRAccumulator, DeviceCSRAccumulator))
        gridOK = (deviceAcc or csrAcc) and not bkernel.variable \
            and getattr(bkernel, 'phi', None) is None
        binfo = classifyBoundaryPairs(dm, surface, bkernel,
                                      target_order=self.params.get('target_order'),
                                      correctionsOnly=gridOK)
        vols = mesh.simplexVolumes()
        svols = surface.simplexVolumes()
        cells = mesh.cells
        scells = surface.cells
        dofs = dm.dofs
        dpe = dm.dofs_per_element
        mdim = mesh.manifold_dim
        useNormals = mdim >= 2
        detfac = {1: 1.0, 2: 2.0, 3: 6.0}[mdim]
        sdetfac = {1: 1.0, 2: 1.0, 3: 2.0}[mdim]  # (m-1)! for surface simplex
        runner = _BucketRunner(mesh.vertices, bkernel, useNormals=useNormals,
                               dtype=self.params.get('dtype'))

        # touching (cell shares vertex/edge with surface simplex), grouped by
        # number of shared vertices (2D: vertex vs edge panels)
        tpairs, perms = binfo['touching']
        if len(tpairs):
            qd = binfo['quad_order_diagonal']
            if bkernel.variable:
                # per-pair singularity from the order at (cell center,
                # surface center) — variable-order boundary panels must use
                # a rule matched to the LOCAL exponent (cf. the interior
                # touching-panel grouping)
                ccen = mesh.vertices[cells].mean(axis=1)
                scen = mesh.vertices[scells].reshape(
                    len(scells), -1, mesh.dim).mean(axis=1)
                sv = np.asarray(bkernel.s(ccen[tpairs[:, 0]],
                                          scen[tpairs[:, 1]]))
                sigbs = 1.0 - bkernel.dim - 2.0 * sv
            else:
                sigbs = np.full(len(tpairs), bkernel.getSingularityValue())
            byShared = {}
            for k in range(len(tpairs)):
                byShared.setdefault((perms[k][0],
                                     round(float(sigbs[k]), 12)),
                                    []).append(k)
            for (nS, sigb), idxs in byShared.items():
                if mdim == 1:
                    rule = boundaryVertexRule1D(sigb, qd)
                else:
                    from .quad_singular_2d import (boundaryEdgeRule2DSS,
                                                   boundaryVertexRule2DSS)
                    if nS == 2:
                        sig_eff = sigb if sigb > -1 + 1e-3 else 2.0 + sigb
                        rule = boundaryEdgeRule2DSS(sig_eff, qd, qd)
                    else:
                        rule = boundaryVertexRule2DSS(sigb, qd, qd)
                PHI = rule.buildPSI(dm, boundary=True)
                P = len(idxs)
                vi1 = np.zeros((P, mdim + 1), dtype=np.int64)
                vi2 = np.zeros((P, mdim), dtype=np.int64) if mdim >= 2 else \
                    np.zeros((P, 1), dtype=np.int64)
                dr = np.zeros((P, dpe), dtype=np.int64)
                vs = np.zeros(P)
                nm = np.zeros((P, mesh.dim)) if useNormals else None
                for out_k, k in enumerate(idxs):
                    i, j = tpairs[k]
                    _, perm1, perm2 = perms[k]
                    vi1[out_k] = cells[i][perm1]
                    vi2[out_k] = scells[j][perm2]
                    ld1 = permuteLocalDofs(dm, perm1)
                    dr[out_k] = dofs[i][ld1]
                    vs[out_k] = (detfac * vols[i]) * \
                        (sdetfac * svols[j] if mdim >= 2 else 1.0) * sign
                    if useNormals:
                        nm[out_k] = surface.normals[j]
                runner.run(acc, rule, PHI, vi1, vi2, dr, vs, normals=nm)

        # distant surface pairs; in grid mode binfo['distant'] holds only
        # the order>4 corrections (classifyBoundaryPairs correctionsOnly)
        di, dj, orders = binfo['distant']
        if gridOK:
            touchPairs = binfo['touching'][0]
            di, dj, orders = self._runBoundaryGrid(
                acc, runner, surface, bkernel, di, dj, orders, touchPairs,
                sign)
        for order in np.unique(orders):
            sel = orders == order
            ii, jj = di[sel], dj[sel]
            rule = boundaryDistantRule(int(order), mdim, mdim - 1)
            PHI = rule.buildPSI(dm, boundary=True)
            dr = dofs[ii]
            vs = vols[ii] * (svols[jj] if mdim >= 2 else 1.0) * sign
            vi2 = scells[jj] if mdim >= 2 else scells[jj].reshape(-1, 1)
            nm = surface.normals[jj] if useNormals else None
            if deviceAcc:
                runner.runRowsScan(acc, rule, PHI, cells[ii], vi2, dr, vs,
                                   normals=nm)
            else:
                runner.run(acc, rule, PHI, cells[ii], vi2, dr, vs,
                           normals=nm)

    def _runBoundaryGrid(self, acc, runner, surface, bkernel, di, dj,
                         orders, touchPairs, sign=1.0):
        """One order-4 grid pass over the full (cell x surface) grid
        (see _grid_boundary_blocks), excluding the touching pairs and the
        supplied order>4 corrections; returns the correction subset for the
        scan path.  The caller provides ONLY the corrections
        (classifyBoundaryPairs correctionsOnly contract), so no O(C*S)
        enumeration ever exists.  Per-cell blocks scatter densely on a
        device-dense accumulator, or as C*dpe^2 slot adds on a CSR one (the
        H2 near field's regional subtraction, sign=-1)."""
        from ..fem.quadrature import simplexCompact
        dm, mesh = self.dm, self.mesh
        dtype = runner.dtype
        mdim = mesh.manifold_dim
        C = mesh.num_cells
        S = surface.num_cells
        N = dm.num_dofs
        useNormals = mdim >= 2
        vols = _jd(mesh.simplexVolumes(), dtype)
        svols = surface.simplexVolumes() if mdim >= 2 else np.ones(S)
        rowDofPad = _jd(dm.dofs, INDEX)
        V = mesh.vertices[mesh.cells]
        SV = mesh.vertices[surface.cells].reshape(S, max(mdim, 1), -1) \
            if mdim >= 2 else mesh.vertices[surface.cells.reshape(S, 1)]
        normals = _jd(surface.normals, dtype) if useNormals \
            else jnp.zeros((S, mesh.dim), dtype=dtype)

        # one pass at order 4 covers every pair requiring order <= 4 (the
        # vast majority; computing order-2 pairs at order 4 only adds
        # accuracy); exclusions = touching + order>4 corrections
        for o, maskIn in ((4, False),):
            mi = np.concatenate([di, touchPairs[:, 0]]) \
                if len(touchPairs) else di
            mj = np.concatenate([dj, touchPairs[:, 1]]) \
                if len(touchPairs) else dj
            b1, w1 = simplexCompact(o, mdim)
            Q1 = len(w1)
            if mdim >= 2:
                b2, w2 = simplexCompact(o, mdim - 1)
            else:
                b2, w2 = np.ones((1, 1)), np.ones(1)
            Q2 = len(w2)
            X = _jd(np.einsum('qk,ckd->cqd', b1, V), dtype)
            Ysurf = _jd(np.einsum('qk,skd->sqd', b2, SV), dtype)
            Phi = dm.evalPhi(b1)
            PhiX = _jd(Phi, dtype)
            PhiXw = _jd(Phi * w1[None, :], dtype)
            svolw2 = _jd(svols[:, None] * w2[None, :], dtype)
            Ct = int(max(8, min(C, (1 << 24) // max(S * Q1 * Q2, 1))))
            nTiles = -(-C // Ct)
            # per-tile mask pair lists (vectorized fill)
            tOf = mi // Ct
            perTile = np.bincount(tOf, minlength=nTiles) if len(mi) else \
                np.zeros(nTiles, dtype=np.int64)
            maxM = max(int(perTile.max()) if len(mi) else 0, 1)
            mR = np.full((nTiles, maxM), -1, dtype=np.int64)
            mC = np.zeros((nTiles, maxM), dtype=np.int64)
            if len(mi):
                srt = np.argsort(tOf, kind='stable')
                ts = tOf[srt]
                starts = np.searchsorted(ts, np.arange(nTiles))
                pos = np.arange(len(mi)) - starts[ts]
                mR[ts, pos] = mi[srt] - ts * Ct
                mC[ts, pos] = mj[srt]
            Bxx = _launch(
                _grid_boundary_blocks,
                X, Ysurf, svolw2, vols, normals,
                PhiXw, PhiX, _jd(w1, dtype),
                _jd(mR, INDEX), _jd(mC, INDEX),
                _statics=dict(kernel=bkernel, nTiles=nTiles, Ct=Ct,
                              useNormals=useNormals, maskIn=maskIn,
                              dtype=dtype))
            if sign != 1.0:
                Bxx = Bxx * sign
            if isinstance(acc, DeviceDenseAccumulator):
                acc.A = _launch(_scatter_cell_blocks, acc.A, rowDofPad, Bxx)
            else:
                dpe = dm.dofs_per_element
                dA = dm.dofs
                rb = np.broadcast_to(dA[:, :, None], (C, dpe, dpe))
                cb = np.broadcast_to(dA[:, None, :], (C, dpe, dpe))
                acc.add(rb.reshape(-1), cb.reshape(-1),
                        np.asarray(Bxx, dtype=REAL).reshape(-1))
        return di, dj, orders




class horizonCorrected:
    """Finite-horizon fractional operator represented as
    A(delta) = 2 C(delta) * S_inf - Cross - c_tot * Mass
    (ref nonlocalAssembly.pyx:182-260 horizonCorrected).  `setKernel`
    switches delta/C cheaply: S_inf is reused, only the complement cross
    operator is reassembled."""

    def __init__(self, dm, Sinf, mass):
        self.dm = dm
        self.Sinf = Sinf        # UNSCALED (scaling=1/2) infinite-horizon H2
        self.mass = mass
        self.kernel = None
        self.num_rows = self.num_columns = dm.num_dofs
        self._crossCache = {}

    def setKernel(self, kernel, params=None):
        assert hasattr(kernel.s, 'value')
        self.kernel = kernel
        hv = kernel.horizonValue
        C = kernel.scalingValue
        s = kernel.s.value
        d = self.dm.mesh.dim
        key = (round(hv, 14), round(C, 14), round(s, 14))
        if key not in self._crossCache:
            complementKernel = kernel.getComplementKernel()
            b = nonlocalBuilder(self.dm, complementKernel, params=params,
                                zeroExterior=False)
            self._crossCache[key] = b._getComplementCross()
        self.Cross = self._crossCache[key]
        surf = {1: 2.0, 2: 2.0 * np.pi, 3: 4.0 * np.pi}[d]
        # c_tot = 2 * int_{|z|>delta} C |z|^{-d-2s} dz
        self.c_tot = C * surf * hv ** (-2.0 * s) / s
        self.facS = 2.0 * C

    def matvec(self, x):
        x = jnp.asarray(x)
        return (self.facS * (self.Sinf @ x) - (self.Cross @ x)
                - self.c_tot * (self.mass @ x))

    def __matmul__(self, x):
        return self.matvec(x)

    def __mul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        return (self.facS * jnp.asarray(self.Sinf.diagonal)
                - jnp.asarray(self.Cross.diagonal)
                - self.c_tot * jnp.asarray(self.mass.diagonal))

    def toarray(self):
        return (self.facS * np.asarray(self.Sinf.toarray())
                - np.asarray(self.Cross.toarray())
                - self.c_tot * np.asarray(self.mass.toarray()))

    def __repr__(self):
        return '<horizonCorrected {}x{} delta={}>'.format(
            self.num_rows, self.num_rows,
            self.kernel.horizonValue if self.kernel else None)


jax.tree_util.register_pytree_node(
    horizonCorrected,
    lambda op: ((op.Sinf, op.Cross, op.mass, op.facS, op.c_tot), None),
    lambda aux, ch: _horizonCorrectedFromParts(*ch))


def _horizonCorrectedFromParts(Sinf, Cross, mass, facS, c_tot):
    obj = object.__new__(horizonCorrected)
    obj.Sinf = Sinf
    obj.Cross = Cross
    obj.mass = mass
    obj.facS = facS
    obj.c_tot = c_tot
    obj.kernel = None
    return obj


def _cellSetBoundary(mesh, cellSet):
    """Facets of the boundary of a cell subset, with outward normals
    (ref nonlocalAssembly boundaryVertices/boundaryEdges helpers).
    Returns (facets [F, mdim], normals [F, dim])."""
    cells = mesh.cells[np.asarray(cellSet)]
    mdim = mesh.manifold_dim
    verts = mesh.vertices
    if mdim == 1:
        f = cells.ravel()
        uniq, counts = np.unique(f, return_counts=True)
        bnd = uniq[counts == 1]
        facets = bnd.reshape(-1, 1)
        normals = np.zeros((len(bnd), mesh.dim))
        centers = verts[cells].mean(axis=(0, 1))
        for k, v in enumerate(bnd):
            # outward = away from the owning cell's center
            own = cells[(cells == v).any(axis=1)][0]
            other = own[own != v][0]
            d = verts[v] - verts[other]
            normals[k] = d / np.linalg.norm(d)
        return facets.astype(np.int64), normals
    elif mdim == 2:
        edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                cells[:, [2, 0]]], axis=0)
        owner = np.tile(np.arange(len(cells)), 3)
        se = np.sort(edges, axis=1)
        key = se[:, 0].astype(np.int64) * mesh.num_vertices + se[:, 1]
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        bmask = counts[inv] == 1
        bedges = edges[bmask]
        bowner = owner[bmask]
        t = verts[bedges[:, 1]] - verts[bedges[:, 0]]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        cc = verts[cells[bowner]].mean(axis=1)
        mid = 0.5 * (verts[bedges[:, 0]] + verts[bedges[:, 1]])
        flip = np.einsum('fd,fd->f', n, mid - cc) < 0
        n[flip] = -n[flip]
        return bedges.astype(np.int64), n
    raise NotImplementedError(mdim)


def assembleNonlocal(dm, kernel, matrixFormat='dense', zeroExterior=True,
                     comm=None, params=None, **kwargs):
    """Entry point (ref fem/PyNucleus_fem/DoFMaps.pyx:808 assembleNonlocal)."""
    from .operator_interpolation import (RangedFractionalKernel,
                                         assembleRangedNonlocal)
    if isinstance(kernel, RangedFractionalKernel):
        return assembleRangedNonlocal(dm, kernel, matrixFormat=matrixFormat,
                                      zeroExterior=zeroExterior,
                                      params=params, **kwargs)
    builder = nonlocalBuilder(dm, kernel, params=params,
                              zeroExterior=zeroExterior, comm=comm, **kwargs)
    fmt = matrixFormat.lower()
    if fmt == 'dense':
        return builder.getDense()
    if fmt == 'sparsified':
        return builder.getDense(trySparsification=True)
    if fmt == 'diagonal':
        return builder.getDiagonal()
    if fmt == 'sparse':
        return builder.getSparse()
    if fmt == 'h2':
        return builder.getH2()
    if fmt == 'h2corrected':
        return builder.getH2FiniteHorizon()
    raise NotImplementedError(matrixFormat)
