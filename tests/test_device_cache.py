"""Device-resident doom pipeline: the device-cached batch, after on-device
expansion, must match the stacked full-wire loader exactly."""

import types

import numpy as np

from demo2program_tpu.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu.ops import reconstruct
from demo2program_tpu.train.device_cache import DoomDeviceCache
from demo2program_tpu.train.trainer import config_from_dataset

from tests.test_vizdoom_data import real_vizdoom_dir  # noqa: F401 (fixture)


def test_device_cache_matches_full_loader(real_vizdoom_dir):  # noqa: F811
    ds, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    args = types.SimpleNamespace(
        model="full", dataset_type="vizdoom", batch_size=2,
        num_lstm_cell_units=16, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=10)
    cfg = config_from_dataset(args, ds)
    cache = DoomDeviceCache(ds, batch_size=2, seed=0,
                            include_test_actions=True)
    batch = next(cache)
    ids = list(batch["id"])
    out = reconstruct.expand_batch(
        {k: v for k, v in batch.items() if k != "id"}, cfg)
    items = [ds.get_data(i) for i in ids]
    full = {k: np.stack([it[k] for it in items]) for k in items[0]
            if k != "id"}
    np.testing.assert_array_equal(
        np.asarray(out["s_h"]), full["s_h"].astype(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(out["per"]), full["per"].astype(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(out["a_h"]), full["a_h"].astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(out["a_h_tokens"]), full["a_h_tokens"])
    np.testing.assert_array_equal(
        np.asarray(out["test_a_h"]), full["test_a_h"].astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(out["test_a_h_tokens"]), full["test_a_h_tokens"])
    np.testing.assert_array_equal(
        np.asarray(out["program"]).astype(bool),
        full["program"].astype(bool))
    np.testing.assert_array_equal(np.asarray(out["demo_len"]),
                                  full["demo_len"])
    np.testing.assert_array_equal(np.asarray(out["test_demo_len"]),
                                  full["test_demo_len"])


def test_device_cache_sharded_mesh(real_vizdoom_dir):  # noqa: F811
    """Multi-chip: the split shards over the mesh's data axis (no per-chip
    full copy) and every gathered row still corresponds to its id — incl.
    rows served from the pad region on shards beyond the item count."""
    import jax
    from demo2program_tpu.parallel import make_mesh

    ds, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    mesh = make_mesh()
    n_dev = jax.device_count()
    cache = DoomDeviceCache(ds, batch_size=n_dev, seed=0, mesh=mesh,
                            include_test_actions=True)
    # cached item axis is sharded, not replicated
    shard_sizes = {s.data.shape[0]
                   for s in cache._data["dc_s_h"].addressable_shards}
    assert shard_sizes == {cache._per_shard}
    for _ in range(3):
        batch = next(cache)
        assert batch["dc_s_h"].shape[0] == n_dev
        for r, id_ in enumerate(batch["id"]):
            it = ds.get_data(id_)
            np.testing.assert_array_equal(
                np.asarray(batch["demo_len"])[r], it["demo_len"])
            gt = np.argmax(it["program"], axis=0)
            L = int(it["program_len"][0])
            np.testing.assert_array_equal(
                np.asarray(batch["program_tokens"])[r, :L], gt[:L])


def test_device_cache_epochs(real_vizdoom_dir):  # noqa: F811
    ds, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    cache = DoomDeviceCache(ds, batch_size=3, seed=1)
    seen = set()
    for _ in range(4):  # 2 epochs of 2 full batches over 6 items
        b = next(cache)
        assert b["dc_s_h"].shape[0] == 3
        seen.update(b["id"].tolist())
    assert seen == set(ds.ids)


def test_device_cache_set_batch_size(real_vizdoom_dir):  # noqa: F811
    """A stage change (reference bs 32 -> 8 recipe) re-aims the SAME pushed
    cache at a new batch size — scripts/doom_stage_runner.py relies on this
    to pay the device push once per dataset instead of once per stage."""
    ds, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    cache = DoomDeviceCache(ds, batch_size=3, seed=1)
    b3 = next(cache)
    assert b3["dc_s_h"].shape[0] == 3
    cache.set_batch_size(2)
    seen = set()
    for _ in range(6):  # 2 epochs of 3 batches over 6 items
        b = next(cache)
        assert b["dc_s_h"].shape[0] == 2
        seen.update(b["id"].tolist())
    assert seen == set(ds.ids)


def test_stage_already_done_helper(tmp_path):
    """trainer_cli short-circuits completed stages before any data setup."""
    import json

    from demo2program_tpu.cli.trainer_cli import _stage_already_done

    d = tmp_path / "stage"
    assert not _stage_already_done(str(d))
    (d / "ckpt" / "500").mkdir(parents=True)
    assert not _stage_already_done(str(d))  # no resume.json yet
    (d / "resume.json").write_text(json.dumps({"target_step": 500}))
    assert _stage_already_done(str(d))
    (d / "resume.json").write_text(json.dumps({"target_step": 600}))
    assert not _stage_already_done(str(d))
    (d / "resume.json").write_text("garbage")
    assert not _stage_already_done(str(d))
