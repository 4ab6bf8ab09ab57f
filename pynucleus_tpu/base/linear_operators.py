"""Linear operator algebra.

Counterpart of the reference's operator hierarchy
(/root/reference/base/PyNucleus_base/linear_operators.{pxd,pyx} and the
LinearOperator_{SCALAR}.pxi / CSR_.../ SSS_... templates).  Instead of Cython
classes with C matvec loops, operators here are pytree-registered dataclasses
whose ``matvec`` is pure JAX: dense matvecs are matmuls, sparse formats use
gather + segment-sum which XLA fuses, and every operator can flow through
``jax.jit`` as an argument.

Formats:
  - Dense_LinearOperator        dense jnp array               (ref: DenseLinearOperator_{SCALAR}.pxi)
  - Diagonal_LinearOperator     diagonal vector               (ref: DiagonalLinearOperator_{SCALAR}.pxi)
  - CSR_LinearOperator          CSR with precomputed row ids  (ref: CSR_LinearOperator_{SCALAR}.pxi)
  - SSS_LinearOperator          symmetric: diag + strict lower CSR (ref: SSS_LinearOperator_{SCALAR}.pxi)
  - arithmetic wrappers (+, *, @, transpose), identity/zero/null ops
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..config import REAL, INDEX, toDevice as _jd

__all__ = [
    'LinearOperator', 'Dense_LinearOperator', 'Diagonal_LinearOperator',
    'CSR_LinearOperator', 'SSS_LinearOperator', 'identityOperator',
    'nullOperator', 'TimeStepperLinearOperator', 'asOperator',
]


class LinearOperator:
    """Abstract linear operator with shape (num_rows, num_columns)."""

    num_rows: int
    num_columns: int

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    def matvec(self, x):
        raise NotImplementedError()

    def rmatvec(self, x):
        return self.T.matvec(x)

    def __call__(self, x):
        return self.matvec(x)

    def __mul__(self, x):
        if isinstance(x, LinearOperator):
            return ProductOperator(self, x)
        if np.isscalar(x):
            return ScaledOperator(self, x)
        return self.matvec(jnp.asarray(x))

    def __rmul__(self, x):
        if np.isscalar(x):
            return ScaledOperator(self, x)
        return NotImplemented

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return ProductOperator(self, x)
        return self.matvec(jnp.asarray(x))

    def __add__(self, other):
        return SumOperator(self, other, 1.0, 1.0)

    def __sub__(self, other):
        return SumOperator(self, other, 1.0, -1.0)

    def __neg__(self):
        return ScaledOperator(self, -1.0)

    @property
    def T(self):
        return TransposeOperator(self)

    def toarray(self):
        """Materialize as a dense numpy array (host)."""
        n = self.num_columns
        eye = jnp.eye(n, dtype=REAL)
        cols = jax.vmap(self.matvec, in_axes=1, out_axes=1)(eye)
        return np.asarray(cols)

    def to_dense(self):
        return Dense_LinearOperator(jnp.asarray(self.toarray()))

    @property
    def diagonal(self):
        return jnp.diagonal(jnp.asarray(self.toarray()))

    def getDenseData(self):
        return jnp.asarray(self.toarray())

    def __repr__(self):
        return f'<{self.num_rows}x{self.num_columns} {self.__class__.__name__}>'

    def astype(self, dtype):
        """Cast all floating-point leaves to dtype (works for any
        pytree-registered operator)."""
        def cast(a):
            if hasattr(a, 'dtype') and jnp.issubdtype(a.dtype, jnp.floating):
                return _jd(a, dtype)
            return a
        return jax.tree_util.tree_map(cast, self)

    # --- flattening helpers for pytree registration of subclasses ---
    def isSparse(self):
        return False


def _register(cls, data_fields, static_fields):
    def flatten(op):
        return tuple(getattr(op, f) for f in data_fields), \
               tuple(getattr(op, f) for f in static_fields)

    def unflatten(static, data):
        kw = dict(zip(static_fields, static))
        kw.update(dict(zip(data_fields, data)))
        return cls(**kw)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)


class VectorLinearOperator:
    """Operator with vector-valued entries: matvec maps x [M] to y [N, K]
    (ref base LinearOperator_{SCALAR}.pxi:648 {SCALAR_label}
    VectorLinearOperator; used for s-derivative assemblies A'(s)·x whose
    per-entry values have kernel.valueSize components)."""

    def __init__(self, num_rows, num_columns, vectorSize):
        self.num_rows = num_rows
        self.num_columns = num_columns
        self.vectorSize = vectorSize

    def __call__(self, x, trans=False):
        return self.matvecTrans(x) if trans else self.matvec(x)


class Dense_VectorLinearOperator(VectorLinearOperator):
    """data [N, M, K] (ref Dense_VectorLinearOperator, nonlocalAssembly
    pxi:1354)."""

    def __init__(self, data):
        self.data = data if isinstance(data, jax.Array) else jnp.asarray(data)
        super().__init__(data.shape[0], data.shape[1], data.shape[2])

    def matvec(self, x):
        return jnp.einsum('nmk,m->nk', self.data, x)

    def matvecTrans(self, x):
        return jnp.einsum('nmk,n->mk', self.data, x)

    def toarray(self):
        return np.asarray(self.data)

    def __add__(self, other):
        return Dense_VectorLinearOperator(self.data + other.data)

    def __mul__(self, fac):
        return Dense_VectorLinearOperator(fac * self.data)

    __rmul__ = __mul__

    def __repr__(self):
        return (f'<Dense_VectorLinearOperator {self.num_rows}x'
                f'{self.num_columns}x{self.vectorSize}>')


jax.tree_util.register_pytree_node(
    Dense_VectorLinearOperator,
    lambda op: ((op.data,), ()),
    lambda aux, ch: Dense_VectorLinearOperator(ch[0]))


class H2_VectorLinearOperator(VectorLinearOperator):
    """Vector-valued H2: one level-major H2 operator per value component
    (ref VectorH2Matrix, clusterMethodCy.pyx:2670 — the reference threads
    valueSize through coefficientsUp/DownVec; component-wise H2 apply is
    the batched equivalent)."""

    def __init__(self, components):
        self.components = list(components)
        c0 = self.components[0]
        super().__init__(c0.num_rows, c0.num_columns, len(self.components))

    def matvec(self, x):
        return jnp.stack([c.matvec(x) for c in self.components], axis=1)

    def matvecTrans(self, x):
        return jnp.stack([c.T.matvec(x) for c in self.components], axis=1)


class Dense_LinearOperator(LinearOperator):
    def __init__(self, data):
        self.data = data if isinstance(data, jax.Array) else jnp.asarray(data)
        self.num_rows, self.num_columns = data.shape

    def matvec(self, x):
        return self.data @ x

    def rmatvec(self, x):
        return self.data.T @ x

    def toarray(self):
        return np.asarray(self.data)

    @property
    def diagonal(self):
        return jnp.diagonal(self.data)

    @property
    def T(self):
        return Dense_LinearOperator(self.data.T)

    @staticmethod
    def zeros(num_rows, num_columns, dtype=REAL):
        return Dense_LinearOperator(jnp.zeros((num_rows, num_columns), dtype=dtype))

    def __add__(self, other):
        if isinstance(other, Dense_LinearOperator):
            assert self.shape == other.shape, (self.shape, other.shape)
            return Dense_LinearOperator(self.data + other.data)
        return super().__add__(other)

    def __sub__(self, other):
        if isinstance(other, Dense_LinearOperator):
            assert self.shape == other.shape, (self.shape, other.shape)
            return Dense_LinearOperator(self.data - other.data)
        return super().__sub__(other)

    def __mul__(self, x):
        if np.isscalar(x):
            return Dense_LinearOperator(self.data * x)
        return super().__mul__(x)

    def __rmul__(self, x):
        if np.isscalar(x):
            return Dense_LinearOperator(self.data * x)
        return NotImplemented


_register(Dense_LinearOperator, ('data',), ())


class Diagonal_LinearOperator(LinearOperator):
    def __init__(self, data):
        self.data = jnp.asarray(data)
        self.num_rows = self.num_columns = self.data.shape[0]

    def matvec(self, x):
        if x.ndim == 1:
            return self.data * x
        return self.data[:, None] * x

    @property
    def T(self):
        return self

    @property
    def diagonal(self):
        return self.data

    def toarray(self):
        return np.diag(np.asarray(self.data))

    @property
    def inv(self):
        return Diagonal_LinearOperator(1.0 / self.data)


_register(Diagonal_LinearOperator, ('data',), ())


class CSR_LinearOperator(LinearOperator):
    """CSR operator.  Keeps indptr/indices on host (numpy) for setup logic and
    a flat (rowids, indices, data) device triple for the matvec, which XLA
    compiles to gather + segment-sum.
    """

    def __init__(self, indices, indptr=None, data=None, *, rowids=None,
                 num_rows=None, num_columns=None):
        if indptr is not None:
            indptr = np.asarray(indptr)
            nr = indptr.shape[0] - 1
            rowids = np.repeat(np.arange(nr, dtype=INDEX), np.diff(indptr))
            self.indptr = indptr
        else:
            assert rowids is not None and num_rows is not None
            nr = num_rows
            self.indptr = None
        self.rowids = _jd(rowids, INDEX)
        self.indices = _jd(indices, INDEX)
        self.data = jnp.asarray(data)
        self.num_rows = int(nr)
        self.num_columns = int(num_columns) if num_columns is not None else int(nr)

    @property
    def nnz(self):
        return self.indices.shape[0]

    def matvec(self, x):
        prod = self.data * x[self.indices]
        return jax.ops.segment_sum(prod, self.rowids, num_segments=self.num_rows)

    def rmatvec(self, x):
        prod = self.data * x[self.rowids]
        return jax.ops.segment_sum(prod, self.indices, num_segments=self.num_columns)

    @property
    def T(self):
        return _CSRTranspose(self)

    def toarray(self):
        A = np.zeros((self.num_rows, self.num_columns), dtype=np.asarray(self.data).dtype)
        np.add.at(A, (np.asarray(self.rowids), np.asarray(self.indices)),
                  np.asarray(self.data))
        return A

    @property
    def diagonal(self):
        mask = self.rowids == self.indices
        return jax.ops.segment_sum(jnp.where(mask, self.data, 0.0), self.rowids,
                                   num_segments=self.num_rows)

    @staticmethod
    def from_scipy(A):
        A = A.tocsr()
        return CSR_LinearOperator(A.indices, A.indptr, A.data,
                                  num_columns=A.shape[1])

    @staticmethod
    def from_dense(data, tol=0.0):
        import scipy.sparse as sp
        A = sp.csr_matrix(np.asarray(data))
        A.eliminate_zeros()
        return CSR_LinearOperator.from_scipy(A)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix(
            (np.asarray(self.data),
             (np.asarray(self.rowids), np.asarray(self.indices))),
            shape=self.shape).tocsr()

    def isSparse(self):
        return True

    def sort_indices(self):
        pass

    def __mul__(self, x):
        if np.isscalar(x):
            op = CSR_LinearOperator(self.indices, data=self.data * x,
                                    rowids=self.rowids, num_rows=self.num_rows,
                                    num_columns=self.num_columns)
            op.indptr = self.indptr
            return op
        return super().__mul__(x)


def _csr_flatten(op):
    # indptr is host-only metadata and must not enter the pytree aux (numpy
    # arrays are unhashable there); it is dropped on unflatten.
    return (op.rowids, op.indices, op.data), (op.num_rows, op.num_columns)


def _csr_unflatten(static, data):
    rowids, indices, vals = data
    op = object.__new__(CSR_LinearOperator)
    op.rowids, op.indices, op.data = rowids, indices, vals
    op.num_rows, op.num_columns = static
    op.indptr = None
    return op


jax.tree_util.register_pytree_node(CSR_LinearOperator, _csr_flatten, _csr_unflatten)


class _CSRTranspose(LinearOperator):
    def __init__(self, A):
        self.A = A
        self.num_rows = A.num_columns
        self.num_columns = A.num_rows

    def matvec(self, x):
        return self.A.rmatvec(x)

    @property
    def T(self):
        return self.A

    def toarray(self):
        return self.A.toarray().T


_register(_CSRTranspose, ('A',), ())


class SSS_LinearOperator(LinearOperator):
    """Symmetric sparse skyline: diagonal + strictly-lower CSR.
    matvec(x) = diag*x + L x + L^T x.
    """

    def __init__(self, indices, indptr=None, data=None, diagonal=None, *,
                 rowids=None, num_rows=None):
        if indptr is not None:
            indptr = np.asarray(indptr)
            nr = indptr.shape[0] - 1
            rowids = np.repeat(np.arange(nr, dtype=INDEX), np.diff(indptr))
            self.indptr = indptr
        else:
            assert rowids is not None and num_rows is not None
            nr = num_rows
            self.indptr = None
        self.rowids = _jd(rowids, INDEX)
        self.indices = _jd(indices, INDEX)
        self.data = jnp.asarray(data)
        self.diag = jnp.asarray(diagonal)
        self.num_rows = self.num_columns = int(nr)

    @property
    def nnz(self):
        return self.indices.shape[0] + self.num_rows

    def matvec(self, x):
        y = self.diag * x
        prod = self.data * x[self.indices]
        y = y + jax.ops.segment_sum(prod, self.rowids, num_segments=self.num_rows)
        prodT = self.data * x[self.rowids]
        y = y + jax.ops.segment_sum(prodT, self.indices, num_segments=self.num_rows)
        return y

    @property
    def T(self):
        return self

    @property
    def diagonal(self):
        return self.diag

    def toarray(self):
        A = np.diag(np.asarray(self.diag))
        r, c, d = (np.asarray(self.rowids), np.asarray(self.indices),
                   np.asarray(self.data))
        np.add.at(A, (r, c), d)
        np.add.at(A, (c, r), d)
        return A

    def to_csr(self):
        import scipy.sparse as sp
        r = np.asarray(self.rowids)
        c = np.asarray(self.indices)
        d = np.asarray(self.data)
        n = self.num_rows
        rows = np.concatenate([r, c, np.arange(n)])
        cols = np.concatenate([c, r, np.arange(n)])
        vals = np.concatenate([d, d, np.asarray(self.diag)])
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        return CSR_LinearOperator.from_scipy(A)

    def isSparse(self):
        return True


def _sss_flatten(op):
    return (op.rowids, op.indices, op.data, op.diag), (op.num_rows,)


def _sss_unflatten(static, data):
    op = object.__new__(SSS_LinearOperator)
    op.rowids, op.indices, op.data, op.diag = data
    op.num_rows, = static
    op.indptr = None
    op.num_columns = op.num_rows
    return op


jax.tree_util.register_pytree_node(SSS_LinearOperator, _sss_flatten, _sss_unflatten)


class identityOperator(LinearOperator):
    def __init__(self, num_rows, alpha=1.0):
        self.num_rows = self.num_columns = num_rows
        self.alpha = alpha

    def matvec(self, x):
        return self.alpha * x

    @property
    def T(self):
        return self

    def toarray(self):
        return self.alpha * np.eye(self.num_rows)


_register(identityOperator, (), ('num_rows', 'alpha'))


class nullOperator(LinearOperator):
    def __init__(self, num_rows, num_columns):
        self.num_rows = num_rows
        self.num_columns = num_columns

    def matvec(self, x):
        return jnp.zeros(x.shape[:0] + (self.num_rows,) + x.shape[1:],
                         dtype=x.dtype)

    def toarray(self):
        return np.zeros((self.num_rows, self.num_columns))


_register(nullOperator, (), ('num_rows', 'num_columns'))


class ScaledOperator(LinearOperator):
    def __init__(self, A, alpha):
        self.A = A
        self.alpha = alpha
        self.num_rows = A.num_rows
        self.num_columns = A.num_columns

    def matvec(self, x):
        return self.alpha * self.A.matvec(x)

    @property
    def T(self):
        return ScaledOperator(self.A.T, self.alpha)

    @property
    def diagonal(self):
        return self.alpha * self.A.diagonal


_register(ScaledOperator, ('A', 'alpha'), ())


class SumOperator(LinearOperator):
    def __init__(self, A, B, facA=1.0, facB=1.0):
        assert A.shape == B.shape, (A.shape, B.shape)
        self.A, self.B = A, B
        self.facA, self.facB = facA, facB
        self.num_rows = A.num_rows
        self.num_columns = A.num_columns

    def matvec(self, x):
        return self.facA * self.A.matvec(x) + self.facB * self.B.matvec(x)

    @property
    def T(self):
        return SumOperator(self.A.T, self.B.T, self.facA, self.facB)

    @property
    def diagonal(self):
        return self.facA * self.A.diagonal + self.facB * self.B.diagonal

    def toarray(self):
        return (self.facA * self.A.toarray()
                + self.facB * self.B.toarray())


_register(SumOperator, ('A', 'B', 'facA', 'facB'), ())


# Reference: TimeStepperLinearOperator (LinearOperator_decl_{SCALAR}.pxi:56)
# represents  facM*M + facS*S for timestepping systems.
class TimeStepperLinearOperator(SumOperator):
    def __init__(self, M, S, facS=1.0, facM=1.0):
        super().__init__(M, S, facM, facS)
        self.M, self.S = M, S
        self.facM, self.facS = facM, facS


_register(TimeStepperLinearOperator, ('M', 'S', 'facS', 'facM'), ())


class ProductOperator(LinearOperator):
    def __init__(self, A, B):
        assert A.num_columns == B.num_rows, (A.shape, B.shape)
        self.A, self.B = A, B
        self.num_rows = A.num_rows
        self.num_columns = B.num_columns

    def matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    @property
    def T(self):
        return ProductOperator(self.B.T, self.A.T)


_register(ProductOperator, ('A', 'B'), ())


class TransposeOperator(LinearOperator):
    def __init__(self, A):
        self.A = A
        self.num_rows = A.num_columns
        self.num_columns = A.num_rows

    def matvec(self, x):
        return self.A.rmatvec(x)

    def rmatvec(self, x):
        return self.A.matvec(x)

    @property
    def T(self):
        return self.A

    def toarray(self):
        return self.A.toarray().T


_register(TransposeOperator, ('A',), ())


class blockOperator(LinearOperator):
    """Dense block layout of sub-operators; ref linear_operators.pxd:88."""

    def __init__(self, subblocks):
        self.subblocks = subblocks
        self.blockRows = len(subblocks)
        self.blockCols = len(subblocks[0])
        self.rowSizes = [subblocks[i][0].num_rows for i in range(self.blockRows)]
        self.colSizes = [subblocks[0][j].num_columns for j in range(self.blockCols)]
        self.num_rows = sum(self.rowSizes)
        self.num_columns = sum(self.colSizes)

    def matvec(self, x):
        xs = []
        off = 0
        for s in self.colSizes:
            xs.append(x[off:off + s])
            off += s
        ys = []
        for i in range(self.blockRows):
            yi = self.subblocks[i][0].matvec(xs[0])
            for j in range(1, self.blockCols):
                yi = yi + self.subblocks[i][j].matvec(xs[j])
            ys.append(yi)
        return jnp.concatenate(ys)


class blockDiagonalOperator(blockOperator):
    def __init__(self, diagonalBlocks):
        n = len(diagonalBlocks)
        blocks = [[diagonalBlocks[i] if i == j else
                   nullOperator(diagonalBlocks[i].num_rows,
                                diagonalBlocks[j].num_columns)
                   for j in range(n)] for i in range(n)]
        super().__init__(blocks)


class SchurComplement(LinearOperator):
    """S = A11 - A12 A22^{-1} A21 for the index split (indices, complement)
    (ref base/SchurComplement_{SCALAR}.pxi).  A22 is LU-factorized once;
    matvec runs fully on device."""

    def __init__(self, A, indices):
        arr = jnp.asarray(A.toarray())
        n = arr.shape[0]
        indices = np.asarray(indices, dtype=np.int64)
        comp = np.setdiff1d(np.arange(n), indices)
        self.indices = indices
        self.complement = comp
        self.A11 = arr[np.ix_(indices, indices)]
        self.A12 = arr[np.ix_(indices, comp)]
        self.A21 = arr[np.ix_(comp, indices)]
        self.A22 = arr[np.ix_(comp, comp)]
        self._lu = jax.scipy.linalg.lu_factor(self.A22)
        self.num_rows = self.num_columns = len(indices)

    def matvec(self, x):
        x = jnp.asarray(x)
        t = jax.scipy.linalg.lu_solve(self._lu, self.A21 @ x)
        return self.A11 @ x - self.A12 @ t

    def toarray(self):
        inv22 = np.linalg.inv(np.asarray(self.A22))
        return np.asarray(self.A11) - np.asarray(self.A12) @ inv22 \
            @ np.asarray(self.A21)

    def __repr__(self):
        return 'SchurComplement({}x{})'.format(self.num_rows, self.num_rows)


def invDiagonal(A):
    """Diagonal operator holding 1/diag(A) (ref base/linear_operators.pyx
    invDiagonal); the standard Jacobi preconditioner."""
    return Diagonal_LinearOperator(1.0 / jnp.asarray(A.diagonal))


def asOperator(A):
    if isinstance(A, LinearOperator):
        return A
    A = jnp.asarray(A)
    assert A.ndim == 2
    return Dense_LinearOperator(A)
