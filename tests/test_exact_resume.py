"""Exact resume (VERDICT r3 weak #4 / next #7): a killed-and-resumed run
must replay the IDENTICAL batch sequence and per-step rng stream, so the
resumed parameters match an uninterrupted run's bit for bit.

Three layers:
  * chunked Karel path — batch indices are a pure function of (seed, step),
    so exactness is by construction; asserted end-to-end on params.
  * streaming BatchPipeline — fast_forward(n) replays the id stream.
  * DoomDeviceCache — fast_forward(n) replays the shuffle-cursor draws.
"""

import types

import numpy as np
import pytest

from tests.test_data import tiny_dataset_dir  # session fixture  # noqa: F401


def _args(dataset_dir, train_dir, **kw):
    ns = types.SimpleNamespace(
        debug=False, prefix="test", model="synthesis_baseline",
        dataset_type="karel", dataset_path=dataset_dir,
        checkpoint=None, num_k=3, batch_size=4, seed=0,
        encoder_rnn_type="lstm", num_lstm_cell_units=32,
        demo_aggregation="avgpool", scheduled_sampling=False,
        scheduled_sampling_decay_steps=20000,
        train_dir=str(train_dir),
        learning_rate=1e-3, lr_weight_decay=False,
        log_step=2, write_summary_step=100, test_sample_step=1000,
        ckpt_save_step=2, max_steps=4)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.slow
def test_chunked_resume_bitwise(tiny_dataset_dir, tmp_path):  # noqa: F811
    """Uninterrupted 4-step run == (2 steps, kill, auto-resume to 4)."""
    import jax

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)

    a = Trainer(_args(tiny_dataset_dir, tmp_path / "a"), ds_train, ds_test)
    assert a.karel_cache is not None, "chunked path must be active"
    a.train(max_steps=4)

    b1 = Trainer(_args(tiny_dataset_dir, tmp_path / "b"), ds_train, ds_test)
    b1.train(max_steps=2)  # dies after 2 of an intended 4
    import json
    import os
    with open(os.path.join(b1.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": 4}, f)
    b2 = Trainer(_args(tiny_dataset_dir, tmp_path / "b"), ds_train, ds_test)
    assert b2._auto_resumed and int(b2.state.step) == 2
    b2.train(max_steps=4)

    la = jax.tree_util.tree_leaves(a.state.params)
    lb = jax.tree_util.tree_leaves(b2.state.params)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pipeline_fast_forward(tiny_dataset_dir):  # noqa: F811
    from demo2program_tpu.data import BatchPipeline
    from demo2program_tpu.data.dataset import create_default_splits

    ds, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    a = BatchPipeline(ds, 3, shuffle=True, seed=7)
    seq_a = [list(next(a)["id"]) for _ in range(6)]

    b = BatchPipeline(ds, 3, shuffle=True, seed=7)
    next(b)  # the trainer's init example consumes one draw
    b.fast_forward(2)  # skip draws 1..2 (the dead run's 2 steps)
    assert list(next(b)["id"]) == seq_a[3]
    assert list(next(b)["id"]) == seq_a[4]


def test_doom_cache_fast_forward(tmp_path):
    """fast_forward replays the same index draws as consuming batches."""
    from demo2program_tpu.train.device_cache import DoomDeviceCache

    class _FakeCache(DoomDeviceCache):
        # exercise only the cursor logic, not the device push
        def __init__(self, n, bs, seed):
            self.batch_size = bs
            self.rng = np.random.RandomState(seed)
            self._ids = np.arange(n)
            self.n_shards = 1
            self._order = None
            self._pos = 0

    a = _FakeCache(10, 4, seed=3)
    draws_a = [list(a._draw()) for _ in range(7)]
    b = _FakeCache(10, 4, seed=3)
    b.fast_forward(5)
    assert list(b._draw()) == draws_a[5]
    assert list(b._draw()) == draws_a[6]
