"""Grouped array stores: the reference's HDF5 layout (`<group>/<key>`
arrays, e.g. `<id>/s_h`, `data_info/num_train`) in one of two files.

  * `.npz` — written and read with numpy alone: one `<group>/<key>.npy`
    zip member per array. Everything this package writes uses it.
  * `.hdf5` — reference datasets and older dumps; read through h5py, which
    is imported only when such a file is opened.

Both readers hand back objects with the same access pattern:
`store.keys()`, `group in store`, `store[group][key]` -> array (h5py returns
a dataset that `[()]` / slicing turns into one). Strings come back as `str`
from `.npz` and as `bytes` from `.hdf5`.
"""

import os
import os.path as osp
import zipfile

import numpy as np

DATA_FILES = ("data.npz", "data.hdf5")


def data_file(dataset_path):
    """The dataset's store file: `data.npz`, else `data.hdf5`."""
    for name in DATA_FILES:
        path = osp.join(dataset_path, name)
        if osp.exists(path):
            return path
    raise FileNotFoundError(
        f"no {' or '.join(DATA_FILES)} in {dataset_path}")


def open_store(path):
    """Open a `.npz` or `.hdf5` store for reading."""
    if path.endswith(".hdf5"):
        import h5py
        return h5py.File(path, "r")
    return NpzStore(path)


class NpzGroup:
    def __init__(self, npz, name, keys):
        self._npz = npz
        self.name = name
        self._keys = keys

    def keys(self):
        return list(self._keys)

    def __iter__(self):
        return iter(self._keys)

    def __contains__(self, key):
        return key in self._keys

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(f"{self.name}/{key}")
        return self._npz[f"{self.name}/{key}"]


class NpzStore:
    """Read side of a grouped `.npz` store; arrays load on access."""

    def __init__(self, path):
        self.filename = path
        self._npz = np.load(path, allow_pickle=False)
        self._groups = {}
        for member in self._npz.files:
            group, _, key = member.rpartition("/")
            self._groups.setdefault(group, []).append(key)

    def keys(self):
        return list(self._groups)

    def __iter__(self):
        return iter(self._groups)

    def __contains__(self, group):
        return group in self._groups

    def __getitem__(self, group):
        return NpzGroup(self._npz, group, self._groups[group])

    def close(self):
        self._npz.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _GroupWriter:
    def __init__(self, writer, name):
        self._writer = writer
        self._name = name

    def __setitem__(self, key, value):
        self._writer._write(f"{self._name}/{key}", value)


class NpzWriter:
    """Write side: `create_group(name)[key] = array`. Arrays stream into the
    zip as they are set; the file appears under its name on `close()`."""

    def __init__(self, path):
        self.path = path
        self._partial = path + ".partial"
        self._zip = zipfile.ZipFile(self._partial, "w", zipfile.ZIP_STORED,
                                    allowZip64=True)
        self._groups = set()

    def create_group(self, name):
        if "/" in name or name in self._groups:
            raise ValueError(f"invalid or duplicate group name {name!r}")
        self._groups.add(name)
        return _GroupWriter(self, name)

    def _write(self, member, value):
        with self._zip.open(member + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(value),
                                      allow_pickle=False)

    def close(self):
        self._zip.close()
        os.replace(self._partial, self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._zip.close()
            os.remove(self._partial)
