"""Digests of an HDF5 file's values, as io/hdf5.py's reader returns them.

`tests/torch_h5_fixtures.py` writes the committed HDF5 fixtures with h5py
and records, in their MANIFEST.json, the sha256 of every dataset's C-order
bytes and of every attribute's value, after mapping h5py's values to the
reader's forms (object references as the referenced object's path,
variable-length strings as str).  `file_manifest` computes the same
digests through the port's reader, so a host without h5py can check that
it reads every fixture as h5py did.
"""

from __future__ import annotations

import hashlib

import numpy as np


def canonical(value) -> bytes:
    """Bytes that identify a value: numbers and fixed strings by their
    C-order bytes, str as UTF-8, sequences (VLEN elements, reference
    lists) element by element, each with its length."""
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, (list, tuple)) or (isinstance(value, np.ndarray) and value.dtype == object):
        parts = [canonical(v) for v in value]
        return b"".join(len(p).to_bytes(8, "little") + p for p in parts)
    if isinstance(value, int):  # a reference list's axis
        return value.to_bytes(8, "little", signed=True)
    return np.ascontiguousarray(value).tobytes()


def digest(value) -> str:
    return hashlib.sha256(canonical(value)).hexdigest()


def file_manifest(path, refused=()) -> dict:
    """{"datasets": {path: [shape, dtype, sha256]}, "attrs": {path: {name:
    sha256}}} of the file at path, read by the port's reader; the values of
    the datasets in `refused` (their filters are not read) are left out."""
    from wass_tpu_torch.io import hdf5

    out = {"datasets": {}, "attrs": {}}
    with hdf5.H5File(path) as f:
        objs = [("/", f["/"])]
        f.visititems(lambda name, obj: objs.append(("/" + name, obj)))
        for name, obj in objs:
            if obj.attrs:
                out["attrs"][name] = {k: digest(v) for k, v in obj.attrs.items()}
            if isinstance(obj, hdf5.H5Dataset) and name not in refused:
                out["datasets"][name] = [list(obj.shape), str(obj.dtype), digest(obj[()])]
    return out
