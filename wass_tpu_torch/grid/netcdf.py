"""The gridded.nc cube (netCDF-4), written through the port's own HDF5 writer.

The schema of the JAX package's wass_tpu/grid/netcdf.py, itself the
reference's gridded.nc (NetCDFOutput,
gridding/wassgridsurface/netcdfoutput.py:22-211): dims
X/Y/count; variables Z (mm), X_grid/Y_grid (mm), Kx/Ky, scale, time,
count, workdir, maskZ, VLEN uint8 cam0images/cam0masks; a "meta" group
carrying intrinsics and projection matrices; `units`/`long_name`
attributes; dimension scales attached to every variable.

The GPU host has no h5py, so the file is written by io/hdf5.py.  Two
differences from the JAX package's cube, both of layout: the frame count
is known when the writer is made, so `count` is a fixed dimension (not an
unlimited one), and every dataset is contiguous (not chunked).  Z, time,
count, workdir and the image descriptors are allocated at creation and
each push_Z writes its frame at its offset: no frame is held after its
push.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from wass_tpu_torch.io import hdf5

F4, F8 = hdf5.numeric(np.float32), hdf5.numeric(np.float64)


class NetCDFWriter:
    def __init__(self, filename, M: int, N: int, count: int):
        self._h5 = w = hdf5.Writer(filename)
        self.M = M
        self.N = N
        self.n_frames = count
        self._count = 0
        self._scale = None
        root = w.root

        def var(name, shape, dtype, data=None):
            return w.create_dataset(root, name, shape, dtype, data)

        # Dimension scales (netCDF dimensions).
        self.dimX = var("X", (N,), F8, np.zeros(N))
        w.make_scale(self.dimX, "X")
        self.dimY = var("Y", (M,), F8, np.zeros(M))
        w.make_scale(self.dimY, "Y")

        self.scale_ds = var("scale", (), F8)
        self.count_ds = var("count", (count,), hdf5.numeric(np.uint32))
        self.time_ds = var("time", (count,), F4)
        self.workdir_ds = var("workdir", (count,), hdf5.numeric(np.uint64))
        self.xgrid = var("X_grid", (N, M), F8)
        self.ygrid = var("Y_grid", (N, M), F8)
        self.kx = var("Kx", (N, M), F8)
        self.ky = var("Ky", (N, M), F8)
        self.Z = var("Z", (count, N, M), F4)
        self.maskZ = var("maskZ", (N, M), F4)
        self.cam0images = var("cam0images", (count,), hdf5.VLEN_U8)
        self.cam0masks = var("cam0masks", (count,), hdf5.VLEN_U8)

        # netCDF-4 dimension wiring, attached in the JAX writer's order so
        # that each scale's REFERENCE_LIST lists its variables the same way.
        w.make_scale(self.count_ds, "count")
        for ds2d in (self.xgrid, self.ygrid, self.kx, self.ky, self.maskZ):
            w.attach_scale(ds2d, 0, self.dimX)
            w.attach_scale(ds2d, 1, self.dimY)
        w.attach_scale(self.Z, 0, self.count_ds)
        w.attach_scale(self.Z, 1, self.dimX)
        w.attach_scale(self.Z, 2, self.dimY)
        for ds1d in (self.time_ds, self.workdir_ds, self.cam0images, self.cam0masks):
            w.attach_scale(ds1d, 0, self.count_ds)

        for name, units, long_name in [
            ("scale", "meter", "scale"),
            ("count", "steps", "count"),
            ("time", "seconds", "time"),
            ("workdir", "workdir", "WASS-like workdir number (ie. frame index)"),
            ("X_grid", "millimeter", "X axis grid"),
            ("Y_grid", "millimeter", "Y axis grid"),
            ("Kx", "wavenumbers", "Horizontal wavenumbers"),
            ("Ky", "wavenumbers", "Vertical wavenumbers"),
            ("Z", "millimeter", "Z data on time over the XY grid"),
            ("maskZ", "", "Z mask over the XY grid"),
        ]:
            ds = root.children[name]
            w.set_attr(ds, "units", units)
            w.set_attr(ds, "long_name", long_name)

        self.meta = w.create_group(root, "meta")

    @property
    def scale(self):
        return self._scale

    @scale.setter
    def scale(self, v):
        self._scale = v
        self._h5.write(self.scale_ds, v)

    def _grid(self, A) -> np.ndarray:
        """An (M, N) grid transposed to the cube's (N, M); any other shape as given."""
        A = np.asarray(A)
        return A.T if A.shape == (self.M, self.N) else A

    def set_grids(self, XX, YY):
        self._h5.write(self.xgrid, self._grid(XX))
        self._h5.write(self.ygrid, self._grid(YY))

    def set_kxky(self, KX, KY):
        self._h5.write(self.kx, self._grid(KX))
        self._h5.write(self.ky, self._grid(KY))

    def set_mask(self, mask):
        self._h5.write(self.maskZ, self._grid(mask))

    def set_intrinsics(self, K0, K1, kc0, kc1, P0plane, P1plane, P0cam, P1cam, Cam0toGrid, Cam1toGrid):
        w, m = self._h5, self.meta

        def put(name, A):
            A = np.asarray(A, np.float64)
            w.create_dataset(m, name, A.shape, F8, A)

        put("intr0", K0)
        put("intr1", K1)
        put("dist0", np.asarray(kc0, np.float64).reshape(-1))
        put("dist1", np.asarray(kc1, np.float64).reshape(-1))
        for name, M_ in [
            ("P0plane", P0plane), ("P1plane", P1plane),
            ("P0cam", P0cam), ("P1cam", P1cam),
            ("Cam0toGrid", Cam0toGrid), ("Cam1toGrid", Cam1toGrid),
        ]:
            if M_ is not None:
                put(name, M_)

    def add_meta_attribute(self, name, value):
        self._h5.set_attr(self.meta, name, value)

    def push_Z(self, Z, time: float, workdir: int, image: Optional[bytes] = None, imagemask: Optional[bytes] = None):
        idx = self._count
        if idx >= self.n_frames:
            raise IndexError(f"the cube holds {self.n_frames} frames; frame {idx} does not fit")
        Zt = np.asarray(Z, np.float32)
        if Zt.shape == (self.M, self.N):
            Zt = Zt.T
        if Zt.shape != (self.N, self.M):
            raise ValueError(f"Z of shape {np.shape(Z)} for a ({self.M}, {self.N}) grid")
        self._count += 1
        w = self._h5
        w.write(self.Z, Zt, idx * self.N * self.M)
        w.write(self.count_ds, np.uint32(idx), idx)
        w.write(self.time_ds, np.float32(time), idx)
        w.write(self.workdir_ds, np.uint64(workdir), idx)
        if image is not None:
            w.write_vlen(self.cam0images, idx, image)
        if imagemask is not None:
            w.write_vlen(self.cam0masks, idx, imagemask)

    def close(self):
        self._h5.close()


class NetCDFReader:
    """Reader for gridded.nc cubes, the port's, the JAX package's h5py ones
    and the netCDF library's (io/hdf5.py's H5File; the JAX reader's
    methods)."""

    def __init__(self, filename):
        self.f = hdf5.H5File(filename)

    def __getitem__(self, name):
        return self.f[name]

    @property
    def Z(self):
        return self.f["Z"]

    def meta(self, name):
        return self.f["meta"][name][...]

    def meta_attr(self, name):
        return self.f["meta"].attrs[name]

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
