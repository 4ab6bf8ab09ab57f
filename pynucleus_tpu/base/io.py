"""Serialization: dict <-> HDF5, mesh/dofmap HDF5 checkpointing, and legacy
VTK export.

Counterpart of the reference's state save/load layer
(ref base/PyNucleus_base/utilsFem.py:246-370 saveDictToHDF5/loadDictFromHDF5,
fem/PyNucleus_fem/mesh.py:1826-1959 meshNd.HDF5write/HDF5read/exportVTK,
fem/PyNucleus_fem/DoFMaps.pyx DoFMap.HDF5write/HDF5read).  Assembled
operators and transient solutions are expensive; everything here makes them
checkpointable/resumable.
"""
import numpy as np


# ------------------------------------------------------------- dict <-> HDF5

def saveDictToHDF5(params, grp):
    """Recursively write a dict of scalars/strings/arrays/dicts/lists into an
    h5py group (ref utilsFem.py:246)."""
    for key, val in params.items():
        key = str(key)
        if isinstance(val, dict):
            saveDictToHDF5(val, grp.create_group(key))
        elif isinstance(val, str):
            grp.attrs[key] = val
        elif isinstance(val, (bool, np.bool_)):
            grp.attrs[key] = bool(val)
        elif isinstance(val, (int, np.integer, float, np.floating,
                              complex, np.complexfloating)):
            grp.attrs[key] = val
        elif val is None:
            grp.attrs[key] = '__None__'
        elif isinstance(val, np.ndarray):
            grp.create_dataset(key, data=val)
        elif isinstance(val, (list, tuple)):
            arr = np.asarray(val)
            if arr.dtype.kind in 'ifc':
                ds = grp.create_dataset(key, data=arr)
                ds.attrs['__seq__'] = type(val).__name__
            else:
                sub = grp.create_group(key)
                sub.attrs['__seq__'] = type(val).__name__
                for i, item in enumerate(val):
                    saveDictToHDF5({str(i): item}, sub)
        else:
            # jax arrays and anything array-like
            grp.create_dataset(key, data=np.asarray(val))


def loadDictFromHDF5(grp):
    """Inverse of saveDictToHDF5 (ref utilsFem.py:310)."""
    out = {}
    for key, val in grp.attrs.items():
        if key == '__seq__':
            continue
        out[key] = None if (isinstance(val, str) and val == '__None__') else val
    for key in grp:
        node = grp[key]
        if hasattr(node, 'keys'):  # group
            sub = loadDictFromHDF5(node)
            if '__seq__' in node.attrs:
                items = [sub[str(i)] for i in range(len(sub))]
                out[key] = tuple(items) if node.attrs['__seq__'] == 'tuple' \
                    else items
            else:
                out[key] = sub
        else:
            arr = np.asarray(node)
            if '__seq__' in node.attrs:
                seq = arr.tolist()
                out[key] = tuple(seq) if node.attrs['__seq__'] == 'tuple' \
                    else seq
            else:
                out[key] = arr
    return out


# ------------------------------------------------------- mesh/dofmap <-> HDF5

def meshHDF5write(mesh, grp):
    grp.attrs['type'] = 'simplexMesh'
    grp.attrs['dim'] = mesh.dim
    grp.create_dataset('vertices', data=mesh.vertices)
    grp.create_dataset('cells', data=mesh.cells)


def meshHDF5read(grp):
    from ..fem.meshes import simplexMesh
    return simplexMesh(np.asarray(grp['vertices']), np.asarray(grp['cells']),
                       dim=int(grp.attrs['dim']))


def dofmapHDF5write(dm, grp):
    """Store the dofmap with its mesh and explicit dof numbering (boundary
    indicators are not serializable, so the numbering itself is saved)."""
    grp.attrs['type'] = type(dm).__name__
    grp.attrs['element'] = 'P{}'.format(dm.polynomialOrder)
    grp.attrs['num_dofs'] = dm.num_dofs
    grp.attrs['num_boundary_dofs'] = dm.num_boundary_dofs
    grp.create_dataset('dofs', data=dm.dofs)
    meshHDF5write(dm.mesh, grp.create_group('mesh'))


def dofmapHDF5read(grp):
    from ..fem.dofmaps import dofmapFactory
    mesh = meshHDF5read(grp['mesh'])
    dm = dofmapFactory(grp.attrs['element'], mesh)
    dm.dofs = np.asarray(grp['dofs'])
    dm.num_dofs = int(grp.attrs['num_dofs'])
    dm.num_boundary_dofs = int(grp.attrs['num_boundary_dofs'])
    return dm


# ---------------------------------------------------------------- VTK export

_VTK_CELLTYPE = {0: 1,   # vertex
                 1: 3,   # line
                 2: 5,   # triangle
                 3: 10}  # tetrahedron


def exportVTK(mesh, filename, pointData=None, cellData=None):
    """Write a legacy ASCII .vtk file (ref mesh.py:1889 exportVTK; written
    directly since meshio is not available in this environment)."""
    pointData = pointData or {}
    cellData = cellData or {}
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    if verts.shape[1] < 3:
        verts = np.hstack([verts,
                           np.zeros((verts.shape[0], 3 - verts.shape[1]))])
    cells = np.asarray(mesh.cells)
    nC, nV = cells.shape
    with open(filename, 'w') as f:
        f.write('# vtk DataFile Version 3.0\n')
        f.write('pynucleus_tpu mesh\nASCII\nDATASET UNSTRUCTURED_GRID\n')
        f.write('POINTS {} double\n'.format(verts.shape[0]))
        np.savetxt(f, verts, fmt='%.16g')
        f.write('CELLS {} {}\n'.format(nC, nC * (nV + 1)))
        np.savetxt(f, np.hstack([np.full((nC, 1), nV), cells]), fmt='%d')
        f.write('CELL_TYPES {}\n'.format(nC))
        ct = _VTK_CELLTYPE[mesh.manifold_dim]
        np.savetxt(f, np.full(nC, ct), fmt='%d')
        if pointData:
            f.write('POINT_DATA {}\n'.format(verts.shape[0]))
            for name, vals in pointData.items():
                vals = np.asarray(vals, dtype=np.float64)
                f.write('SCALARS {} double 1\nLOOKUP_TABLE default\n'
                        .format(name))
                np.savetxt(f, vals, fmt='%.16g')
        if cellData:
            f.write('CELL_DATA {}\n'.format(nC))
            for name, vals in cellData.items():
                vals = np.asarray(vals, dtype=np.float64)
                f.write('SCALARS {} double 1\nLOOKUP_TABLE default\n'
                        .format(name))
                np.savetxt(f, vals, fmt='%.16g')


def vertexValues(dm, x):
    """Map a dof vector to per-vertex values for VTK/plot export (P1: direct;
    other orders: average over incident cells' vertex dofs; boundary dofs
    get 0)."""
    mesh = dm.mesh
    x = np.asarray(x)
    vals = np.zeros(mesh.num_vertices)
    counts = np.zeros(mesh.num_vertices)
    nVert = mesh.manifold_dim + 1
    for cellNo in range(mesh.num_cells):
        for k in range(nVert):
            dof = dm.dofs[cellNo, k] if dm.dofs_per_vertex > 0 else -1
            v = mesh.cells[cellNo, k]
            if dof >= 0:
                vals[v] += x[dof]
                counts[v] += 1
    if dm.dofs_per_vertex == 0 and dm.dofs_per_cell > 0:
        # P0: cell dof value at each of its vertices
        for cellNo in range(mesh.num_cells):
            dof = dm.dofs[cellNo, nVert * dm.dofs_per_vertex]
            for k in range(nVert):
                v = mesh.cells[cellNo, k]
                if dof >= 0:
                    vals[v] += x[dof]
                    counts[v] += 1
    np.divide(vals, counts, out=vals, where=counts > 0)
    return vals
