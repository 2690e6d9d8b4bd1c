"""Checkpoints: a pytree saved as one `.npz`, one member per leaf, keyed by
the leaf's key path (`jax.tree_util.keystr`).

Layout: `<ckpt_dir>/<step>/default/state.npz`. A save is written under
`<step>.partial/` and renamed into place, so a checkpoint directory either
holds a complete state or does not exist.
"""

import os
import os.path as osp
import shutil

import jax
import numpy as np

_FILE = "state.npz"


def _flat(tree):
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def save(ckpt_dir, step, tree):
    """Write `tree` as checkpoint `step`; returns its path."""
    final = osp.join(ckpt_dir, str(step))
    partial = final + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(osp.join(partial, "default"))
    arrays = {key: np.asarray(leaf) for key, leaf in _flat(tree)}
    with open(osp.join(partial, "default", _FILE), "wb") as f:
        np.savez(f, **arrays)
    os.replace(partial, final)
    return path_of(ckpt_dir, step)


def path_of(ckpt_dir, step):
    return osp.join(ckpt_dir, str(step), "default")


def restore(path, target):
    """Load the checkpoint at `path` (a `<step>/default` directory) into
    the structure of `target`. Every leaf of `target` must be in the file
    with the same shape and dtype; entries of the file that `target` lacks
    are ignored."""
    state_file = osp.join(path, _FILE)
    if not osp.isfile(state_file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    leaves_with_path, treedef = jax.tree_util.tree_flatten_with_path(target)
    with np.load(state_file, allow_pickle=False) as z:
        leaves = []
        for p, leaf in leaves_with_path:
            key = jax.tree_util.keystr(p)
            if key not in z.files:
                raise KeyError(f"checkpoint {path} has no entry {key}")
            arr = z[key]
            shape, dtype = tuple(leaf.shape), np.dtype(leaf.dtype)
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint entry {key}: {arr.dtype}{list(arr.shape)} "
                    f"does not match {dtype}{list(shape)}")
            leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def all_steps(ckpt_dir):
    if not osp.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit()
                  and osp.isfile(osp.join(path_of(ckpt_dir, d), _FILE)))


def latest_step(ckpt_dir):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None
