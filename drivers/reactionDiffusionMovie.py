#!/usr/bin/env python3
"""Render a movie (PNG frame sequence) from a saved reaction-diffusion run.

Reads the HDF5 output of drivers/brusselator.py (--hdf5Output) and writes one
PNG per stored timestep into reactionDiffusionMovie/<name>/; if ffmpeg is
available the frames are also encoded into an .mp4.

Counterpart of the reference's drivers/reactionDiffusionMovie.py.
"""
import os
import sys
from pathlib import Path
from shutil import rmtree, which
from subprocess import Popen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pynucleus_tpu.base import driver
from pynucleus_tpu.base.io import vertexValues
from pynucleus_tpu.fem.dofmaps import DoFMap


def main(argv=None):
    d = driver()
    d.add('inputFile', '')
    d.add('zoomIn', False)
    d.add('shading', acceptedValues=['gouraud', 'flat'])
    d.add('encode', True)
    d.process(argv=argv)

    import h5py
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    filename = d.inputFile
    assert filename, 'pass --inputFile <brusselator hdf5 output>'
    resultFile = h5py.File(str(filename), 'r')
    dm = DoFMap.HDF5read(resultFile['data']['dm'])
    mesh = dm.mesh

    folder = Path('reactionDiffusionMovie') / Path(filename).name
    if folder.exists():
        rmtree(str(folder))
    folder.mkdir(parents=True, exist_ok=True)

    steps = sorted(int(i) for i in resultFile['U'])
    uLast = np.asarray(resultFile['U'][str(steps[-1])])
    vmin, vmax = float(uLast.min()), float(uLast.max())
    vmin, vmax = vmin - 0.1 * (vmax - vmin), vmax + 0.1 * (vmax - vmin)

    fig, ax = plt.subplots()
    tri = None
    if mesh.dim == 2:
        import matplotlib.tri as mtri
        tri = mtri.Triangulation(mesh.vertices[:, 0], mesh.vertices[:, 1],
                                 mesh.cells)
    for frameNo, i in enumerate(steps):
        u = np.asarray(resultFile['U'][str(i)])
        vv = vertexValues(dm, u)
        print('ts={}: min={:.4g}, max={:.4g}'.format(i, u.min(), u.max()))
        ax.clear()
        if mesh.dim == 2:
            ax.tripcolor(tri, vv, vmin=vmin, vmax=vmax, shading=d.shading)
            ax.set_aspect('equal')
        else:
            order = np.argsort(mesh.vertices[:, 0])
            ax.plot(mesh.vertices[order, 0], vv[order])
            ax.set_ylim([vmin, vmax])
        if d.zoomIn:
            ax.set_xlim([-10, 10])
            ax.set_ylim([-10, 10])
        fig.savefig(folder / '{:05}.png'.format(frameNo), dpi=150)
    resultFile.close()

    if d.encode and which('ffmpeg') is not None:
        Popen(['ffmpeg', '-y', '-framerate', '10', '-i', '%05d.png',
               '-pix_fmt', 'yuv420p',
               '../{}.mp4'.format(Path(filename).stem)],
              cwd=folder).wait()
    d.finish()
    return d


if __name__ == '__main__':
    main()
