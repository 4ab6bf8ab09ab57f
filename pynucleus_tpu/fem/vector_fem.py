"""Vector-valued FEM: product (vector P1) spaces with elasticity/div-div
assembly, and lowest-order Nedelec (N1e) edge elements in 2D with
curl-curl/mass assembly.

Counterpart of /root/reference/fem/PyNucleus_fem/DoFMaps.pyx:904
(assembleElasticity, Product_DoFMap, N1e_DoFMap:2219) and
femCy.pyx:1318-1560 (div_div_2d, elasticity_{1,2,3}d_P1, curlcurl_2d).
Assembly is one batched einsum over all cells (matmul-friendly) + segment-sum
scatter, like the scalar layer.
"""
import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp

from ..config import REAL, INDEX
from ..base.linear_operators import CSR_LinearOperator
from .assembly import _geometry
from .dofmaps import fe_vector

__all__ = ['Product_DoFMap', 'assembleElasticity', 'assembleDivDiv',
           'N1e_DoFMap', 'assembleCurlCurl', 'assembleN1eMass']


class Product_DoFMap:
    """Vector FE space: numComponents copies of a scalar DoFMap with
    block numbering  vectorDof = comp * numScalarDofs + scalarDof
    (ref DoFMaps.pyx Product_DoFMap)."""

    def __init__(self, scalarDM, numComponents=None):
        self.scalarDM = scalarDM
        self.numComponents = (numComponents if numComponents is not None
                              else scalarDM.mesh.dim)
        self.mesh = scalarDM.mesh
        self.num_dofs = scalarDM.num_dofs * self.numComponents
        self.num_boundary_dofs = scalarDM.num_boundary_dofs \
            * self.numComponents
        dpe = scalarDM.dofs_per_element
        k = self.numComponents
        N = scalarDM.num_dofs
        d = scalarDM.dofs                       # [C, dpe]
        # local order: dof-major, component-minor: (l0 c0, l0 c1, l1 c0, ...)
        vdofs = np.full((d.shape[0], dpe * k), -1, dtype=np.int64)
        for l in range(dpe):
            for c in range(k):
                s = d[:, l]
                vdofs[:, l * k + c] = np.where(s >= 0, c * N + s, -1)
        self.dofs = vdofs
        self.dofs_per_element = dpe * k

    def zeros(self):
        return fe_vector(jnp.zeros(self.num_dofs), self)

    def interpolate(self, vecFun):
        """Interpolate a vector-valued function (callable X -> [..., k])."""
        coords = self.scalarDM.getDoFCoordinates()
        vals = np.asarray(vecFun(coords))       # [N, k]
        return fe_vector(jnp.asarray(vals.T.reshape(-1)), self)

    def getComponent(self, u, comp):
        N = self.scalarDM.num_dofs
        arr = np.asarray(u.data if hasattr(u, 'data') else u)
        return fe_vector(jnp.asarray(arr[comp * N:(comp + 1) * N]),
                         self.scalarDM)

    def __repr__(self):
        return '<Product_DoFMap {}x{!r}>'.format(self.numComponents,
                                                 self.scalarDM)


def _scatterVector(vdofs, Kloc, N):
    C, nd = vdofs.shape
    I = np.repeat(vdofs, nd, axis=1).reshape(C, nd, nd)
    J = np.tile(vdofs, (1, nd)).reshape(C, nd, nd)
    mask = (I >= 0) & (J >= 0)
    A = sp.coo_matrix((np.asarray(Kloc)[mask],
                       (I[mask], J[mask])), shape=(N, N)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return CSR_LinearOperator(A.indices.astype(INDEX), A.indptr,
                              jnp.asarray(A.data), num_columns=N)


def assembleElasticity(dm, lam=1.0, mu=1.0):
    """Linear elasticity  int sigma[u] : eps[v],
    sigma = lam div(u) I + 2 mu eps(u), eps = (grad u + grad u^T)/2
    (ref DoFMaps.assembleElasticity:904, femCy elasticity_*_P1).

    For P1 gradients G[c, a, :]:
      K[(a,c1),(b,c2)] = vol * ( lam G[a,c1] G[b,c2]
                                 + mu (G[a,c2] G[b,c1]
                                       + delta_{c1 c2} G[a,:].G[b,:]) )
    """
    if not isinstance(dm, Product_DoFMap):
        dm = Product_DoFMap(dm)
    sdm = dm.scalarDM
    assert sdm.polynomialOrder == 1, 'elasticity implemented for P1'
    mesh = dm.mesh
    k = dm.numComponents
    vol, G = _geometry(mesh)                    # [C], [C, m+1, dim]
    G = G[:, :, :k]
    lamT = np.einsum('c,cax,cby->caxby', vol, G, G)
    muT1 = np.einsum('c,cay,cbx->caxby', vol, G, G)
    gg = np.einsum('c,cad,cbd->cab', vol, G, G)
    eye = np.eye(k)
    Kloc = lam * lamT + mu * (muT1 + np.einsum('cab,xy->caxby', gg, eye))
    C = mesh.num_cells
    nd = dm.dofs_per_element
    Kloc = Kloc.reshape(C, nd, nd)
    return _scatterVector(dm.dofs, Kloc, dm.num_dofs)


def assembleDivDiv(dm, coefficient=1.0):
    """int coeff div(u) div(v) for vector P1 (ref femCy div_div_2d:1318)."""
    if not isinstance(dm, Product_DoFMap):
        dm = Product_DoFMap(dm)
    sdm = dm.scalarDM
    assert sdm.polynomialOrder == 1
    mesh = dm.mesh
    k = dm.numComponents
    vol, G = _geometry(mesh)
    G = G[:, :, :k]
    Kloc = coefficient * np.einsum('c,cax,cby->caxby', vol, G, G)
    C = mesh.num_cells
    nd = dm.dofs_per_element
    return _scatterVector(dm.dofs, Kloc.reshape(C, nd, nd), dm.num_dofs)


# ------------------------------------------------------------------ N1e ----

_LOCAL_EDGES_2D = [(0, 1), (1, 2), (2, 0)]


class N1e_DoFMap:
    """Lowest-order Nedelec edge elements in 2D
    (ref DoFMaps.pyx N1e_DoFMap:2219, shapeFunctionN1e).

    One dof per edge: u_e = int_e u . t with t from the lower to the higher
    global vertex id; basis W_(a,b) = lam_a grad lam_b - lam_b grad lam_a.
    Edges on tagged boundary get negative dofs (like the scalar spaces).
    """

    def __init__(self, mesh, tag=None):
        assert mesh.dim == 2 and mesh.manifold_dim == 2
        self.mesh = mesh
        self.polynomialOrder = 1
        cells = mesh.cells
        C = cells.shape[0]
        bEdges = set()
        if tag is None or (np.isscalar(tag) and tag >= 0):
            for e in mesh.boundaryEdges:
                bEdges.add(tuple(sorted(int(v) for v in e)))
        edgeDof = {}
        numDoFs = 0
        numBdofs = -1
        self.dofs = np.zeros((C, 3), dtype=np.int64)
        self.signs = np.zeros((C, 3), dtype=REAL)
        for c in range(C):
            for le, (a, b) in enumerate(_LOCAL_EDGES_2D):
                v1, v2 = int(cells[c, a]), int(cells[c, b])
                key = (min(v1, v2), max(v1, v2))
                if key not in edgeDof:
                    if key in bEdges:
                        edgeDof[key] = numBdofs
                        numBdofs -= 1
                    else:
                        edgeDof[key] = numDoFs
                        numDoFs += 1
                self.dofs[c, le] = edgeDof[key]
                self.signs[c, le] = 1.0 if v1 < v2 else -1.0
        self.num_dofs = numDoFs
        self.num_boundary_dofs = -numBdofs - 1
        self.dofs_per_element = 3

    def zeros(self):
        return fe_vector(jnp.zeros(self.num_dofs), self)

    def interpolate(self, vecFun):
        """Edge-tangential moments int_e u.t (midpoint rule is exact for the
        lowest-order space on affine meshes when u is linear)."""
        mesh = self.mesh
        vals = np.zeros(self.num_dofs)
        seen = np.zeros(self.num_dofs, dtype=bool)
        for c in range(mesh.num_cells):
            for le, (a, b) in enumerate(_LOCAL_EDGES_2D):
                i = self.dofs[c, le]
                if i < 0 or seen[i]:
                    continue
                v1 = mesh.vertices[mesh.cells[c, a]]
                v2 = mesh.vertices[mesh.cells[c, b]]
                if self.signs[c, le] < 0:
                    v1, v2 = v2, v1
                mid = 0.5 * (v1 + v2)
                u = np.asarray(vecFun(mid[None, :])).reshape(-1)
                vals[i] = float(u @ (v2 - v1))
                seen[i] = True
        return fe_vector(jnp.asarray(vals), self)

    def __repr__(self):
        return '<N1e_DoFMap N={} NB={}>'.format(self.num_dofs,
                                                self.num_boundary_dofs)


def _n1eScatter(dm, Kloc):
    return _scatterVector(dm.dofs, Kloc, dm.num_dofs)


def assembleCurlCurl(dm: N1e_DoFMap, coefficient=1.0):
    """int coeff curl(u) curl(v); curl W_(a,b) = 2 (grad lam_a x grad lam_b)
    is constant per cell (ref femCy curlcurl_2d)."""
    mesh = dm.mesh
    vol, G = _geometry(mesh)                    # [C, 3, 2]
    cross = lambda u, v: u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
    curls = np.zeros((mesh.num_cells, 3))
    for le, (a, b) in enumerate(_LOCAL_EDGES_2D):
        curls[:, le] = 2.0 * cross(G[:, a, :], G[:, b, :]) * dm.signs[:, le]
    Kloc = coefficient * np.einsum('c,ci,cj->cij', vol, curls, curls)
    return _n1eScatter(dm, Kloc)


def assembleN1eMass(dm: N1e_DoFMap, coefficient=1.0):
    """int coeff u . v for N1e (ref DoFMaps.assembleMass on N1e spaces).
    Exact 3-point edge-midpoint quadrature (degree 2)."""
    mesh = dm.mesh
    vol, G = _geometry(mesh)
    # quadrature at edge midpoints: barycentric coords
    bary = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    w = np.array([1.0, 1.0, 1.0]) / 3.0
    # W_(a,b)(x_q) = lam_a(q) grad lam_b - lam_b(q) grad lam_a   [C,3,Q,2]
    W = np.zeros((mesh.num_cells, 3, bary.shape[0], 2))
    for le, (a, b) in enumerate(_LOCAL_EDGES_2D):
        W[:, le] = (bary[None, :, a, None] * G[:, None, b, :]
                    - bary[None, :, b, None] * G[:, None, a, :]) \
            * dm.signs[:, le, None, None]
    Kloc = coefficient * np.einsum('c,q,ciqd,cjqd->cij', vol, w, W, W)
    return _n1eScatter(dm, Kloc)
