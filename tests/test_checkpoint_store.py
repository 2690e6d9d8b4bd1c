"""The numpy replacements for orbax checkpoints and h5py dataset stores."""

import os

import numpy as np
import pytest

from demo2program_tpu.data.store import (
    NpzWriter, data_file, open_store)
from demo2program_tpu.train import checkpoint


def _state():
    import jax.numpy as jnp
    import optax

    from demo2program_tpu.train.step import TrainState
    params = {"dense": {"kernel": jnp.arange(12.0).reshape(3, 4),
                        "bias": jnp.ones(4)},
              "embedding": jnp.linspace(0, 1, 6).reshape(2, 3)}
    tx = optax.chain(optax.clip_by_global_norm(20.0), optax.adam(1e-3))
    return TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                      batch_stats={"bn": {"mean": jnp.zeros(4),
                                          "var": jnp.ones(4)}},
                      opt_state=tx.init(params))


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    import jax
    state = _state()
    path = checkpoint.save(str(tmp_path / "ckpt"), 7, state)
    assert path == checkpoint.path_of(str(tmp_path / "ckpt"), 7)
    zeros = jax.tree_util.tree_map(lambda a: a * 0, state)
    restored = checkpoint.restore(path, zeros)
    assert jax.tree_util.tree_structure(restored) \
        == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_steps_ignore_partial_writes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(ckpt) is None
    checkpoint.save(ckpt, 4, {"a": np.zeros(2)})
    checkpoint.save(ckpt, 12, {"a": np.ones(2)})
    os.makedirs(os.path.join(ckpt, "20.partial", "default"))
    os.makedirs(os.path.join(ckpt, "30"))
    assert checkpoint.all_steps(ckpt) == [4, 12]
    assert checkpoint.latest_step(ckpt) == 12


def test_checkpoint_restore_rejects_mismatch(tmp_path):
    path = checkpoint.save(str(tmp_path), 1, {"a": np.zeros((2, 3),
                                                            np.float32)})
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore(path, {"a": np.zeros((3, 2), np.float32)})
    with pytest.raises(KeyError):
        checkpoint.restore(path, {"b": np.zeros((2, 3), np.float32)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "nope"), {})


def _write_groups(path):
    r = np.random.RandomState(0)
    groups = {
        "no_0": {"program": np.array([1, 5, 3], np.int8),
                 "s_h": r.rand(2, 4, 8, 8, 16) > 0.5,
                 "s_h_len": np.array([4, 3], np.int16)},
        "data_info": {"dsl_type": "prob", "num_train": 1,
                      "vizdoom_pos_keys": ["player_pos", "demon_pos"]},
    }
    with NpzWriter(path) as w:
        for name, arrays in groups.items():
            g = w.create_group(name)
            for k, v in arrays.items():
                g[k] = v
    return groups


def test_npz_store_roundtrip_and_lookup(tmp_path):
    groups = _write_groups(str(tmp_path / "data.npz"))
    assert data_file(str(tmp_path)) == str(tmp_path / "data.npz")
    with open_store(data_file(str(tmp_path))) as s:
        assert sorted(s.keys()) == sorted(groups)
        assert "no_0" in s and "missing" not in s
        g = s["no_0"]
        assert "s_h" in g and sorted(g.keys()) == sorted(groups["no_0"])
        np.testing.assert_array_equal(g["s_h"][()], groups["no_0"]["s_h"])
        np.testing.assert_array_equal(g["s_h"][:, :1],
                                      groups["no_0"]["s_h"][:, :1])
        assert g["program"].dtype == np.int8
        assert str(s["data_info"]["dsl_type"][()]) == "prob"
        assert int(s["data_info"]["num_train"][()]) == 1
    with pytest.raises(FileNotFoundError):
        data_file(str(tmp_path / "elsewhere"))


def test_npz_writer_rejects_duplicates_and_is_atomic(tmp_path):
    path = str(tmp_path / "out.npz")
    w = NpzWriter(path)
    w.create_group("a")["x"] = np.zeros(3)
    with pytest.raises(ValueError):
        w.create_group("a")
    assert not os.path.exists(path)  # only the partial file so far
    w.close()
    assert os.path.exists(path) and not os.path.exists(path + ".partial")
    with pytest.raises(RuntimeError):
        with NpzWriter(str(tmp_path / "failed.npz")) as w2:
            w2.create_group("b")["y"] = np.ones(2)
            raise RuntimeError("generation failed")
    assert os.listdir(tmp_path) == ["out.npz"]


def test_hdf5_store_reads_like_npz(tmp_path):
    """A reference-style data.hdf5 and the .npz store hand the loaders the
    same arrays."""
    h5py = pytest.importorskip("h5py")
    groups = _write_groups(str(tmp_path / "data.npz"))
    with h5py.File(tmp_path / "data.hdf5", "w") as f:
        for name, arrays in groups.items():
            g = f.create_group(name)
            for k, v in arrays.items():
                g[k] = v
    with open_store(str(tmp_path / "data.npz")) as a, \
            open_store(str(tmp_path / "data.hdf5")) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for name in a.keys():
            assert sorted(a[name].keys()) == sorted(b[name].keys())
            for k in a[name].keys():
                va, vb = a[name][k][()], b[name][k][()]
                if isinstance(vb, bytes) or (isinstance(vb, np.ndarray)
                                             and vb.dtype.kind in "OS"):
                    vb = np.char.decode(np.asarray(vb).astype("S"))
                np.testing.assert_array_equal(np.asarray(va),
                                              np.asarray(vb))


def test_karel_loader_same_from_npz_and_hdf5(tmp_path):
    """The Karel loader serves identical items from a generated data.npz
    and the same dataset converted to a reference data.hdf5."""
    h5py = pytest.importorskip("h5py")
    import shutil

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.data.karel_generator import (
        GeneratorConfig, generate)

    npz_dir, h5_dir = tmp_path / "npz", tmp_path / "h5"
    generate(GeneratorConfig(
        dir_name=str(npz_dir), num_train=4, num_test=2, num_val=2,
        num_demo_per_program=3, num_test_demo_per_program=2,
        min_demo_length=4, max_demo_length=10, seed=5), progress_every=0)
    h5_dir.mkdir()
    shutil.copy(npz_dir / "id.txt", h5_dir / "id.txt")
    with open_store(str(npz_dir / "data.npz")) as src, \
            h5py.File(h5_dir / "data.hdf5", "w") as dst:
        for name in src.keys():
            g = dst.create_group(name)
            for k in src[name].keys():
                v = src[name][k][()]
                g[k] = v.astype("S") if v.dtype.kind == "U" else v
    a, _, _ = create_default_splits(str(npz_dir), num_k=2)
    b, _, _ = create_default_splits(str(h5_dir), num_k=2)
    assert a.ids == b.ids and a.dsl_type == b.dsl_type == "prob"
    for id_ in a.ids:
        ia, ib = a.get_data(id_), b.get_data(id_)
        for k in ia:
            np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)
