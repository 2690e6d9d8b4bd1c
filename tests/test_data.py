"""Dataset generation + loader + pipeline tests.

Generates a tiny Karel dataset into a tmpdir (session-scoped fixture, reused
by model/e2e tests) and checks reference schema + loader conventions.
"""

import numpy as np
import pytest

from demo2program_tpu.data import (
    KarelDataset, create_default_splits, BatchPipeline)
from demo2program_tpu.data.karel_generator import GeneratorConfig, generate
from demo2program_tpu.data.store import data_file, open_store
from demo2program_tpu.dsl import karel_interp, karel_parser
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.envs import KarelWorld


@pytest.fixture(scope="session")
def tiny_dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("karel_tiny")
    cfg = GeneratorConfig(
        dir_name=str(d), num_train=12, num_test=4, num_val=4,
        num_demo_per_program=5, num_test_demo_per_program=3,
        min_demo_length=4, max_demo_length=12, seed=11)
    generate(cfg, progress_every=0)
    return str(d)


def test_schema_matches_reference(tiny_dataset_dir):
    with open_store(data_file(tiny_dataset_dir)) as f:
        info = f["data_info"]
        assert int(info["num_program_tokens"][()]) == 50
        assert int(info["num_action_tokens"][()]) == 5
        assert info["dsl_type"][()] in (b"prob", "prob")
        ids = [k for k in f.keys() if k != "data_info"]
        assert len(ids) == 20
        g = f[ids[0]]
        for key in ["program", "s_h", "s_h_len", "a_h", "a_h_len", "per",
                    "test_s_h", "test_s_h_len", "test_a_h", "test_a_h_len",
                    "test_per"]:
            assert key in g, key
        n, t, h, w, c = g["s_h"].shape
        assert (n, h, w, c) == (5, 8, 8, 16)
        assert g["a_h"].shape == (5, t - 1)
        assert g["per"].shape == (5, t, 5)
        # id format parity
        assert ids[0].startswith("no_")


def test_stored_demos_replay_exactly(tiny_dataset_dir):
    """Every stored demo must be reproducible by executing the stored program
    from the stored initial state (the core dataset invariant)."""
    vocab = KarelVocab()
    with open_store(data_file(tiny_dataset_dir)) as f:
        ids = [k for k in f.keys() if k != "data_info"][:5]
        for id_ in ids:
            g = f[id_]
            code = vocab.intseq2str(g["program"][()])
            ast, ok = karel_parser.parse(code)
            assert ok
            s_h = g["s_h"][()]
            lens = g["s_h_len"][()]
            for i in range(s_h.shape[0]):
                world = KarelWorld(s_h[i, 0].copy())
                n, success = karel_interp.execute(ast, world)
                assert success
                assert len(world.s_h) == lens[i]
                replay = np.stack(world.s_h, axis=0)
                assert (replay == s_h[i, :lens[i]]).all()
                # perception vectors match stored per
                per = np.stack(world.p_v_h, axis=0)
                assert (per == g["per"][()][i, :lens[i]]).all()


def test_loader_shapes_and_quirks(tiny_dataset_dir):
    ds_train, ds_test, ds_val = create_default_splits(
        tiny_dataset_dir, num_k=3)
    assert (len(ds_train), len(ds_test), len(ds_val)) == (12, 4, 4)
    item = ds_train.get_data(ds_train.ids[0])
    T = ds_train.max_demo_len
    L = ds_train.max_program_len
    assert item["program"].shape == (50, L)
    assert item["s_h"].shape == (3, T, 8, 8, 16)          # num_k sliced
    assert item["test_s_h"].shape == (3, T, 8, 8, 16)     # test_k unsliced
    assert item["a_h"].shape == (3, T, 6)                 # 5 actions + <e>
    assert item["per"].shape == (3, T, 5)
    assert item["demo_len"].shape == (3,)
    assert item["program_len"].shape == (1,)

    # program one-hot coherent with padded tokens
    plen = int(item["program_len"][0])
    assert (item["program"][:, :plen].argmax(axis=0)
            == item["program_tokens"][:plen]).all()

    # reference <e>-placement quirk: the end token sits at the per-program
    # max action length for EVERY demo (dataset_karel.py:69-76)
    with open_store(data_file(tiny_dataset_dir)) as f:
        row_len = f[ds_train.ids[0]]["a_h"].shape[1]
    assert (item["a_h"][:, row_len, 5] == 1).all()
    # argmax of all-zero rows beyond row_len+1 decodes to 0 ('move')
    if row_len + 1 < T:
        assert (item["a_h_tokens"][:, row_len + 1:] == 0).all()


def test_pipeline_batches(tiny_dataset_dir):
    ds_train, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    pipe = BatchPipeline(ds_train, batch_size=4, shuffle=True, seed=0)
    batch = next(pipe)
    assert batch["s_h"].shape[0] == 4
    # one-hots/demos travel as uint8; models cast on device
    assert batch["program"].dtype == np.uint8
    assert batch["s_h"].dtype == np.uint8
    assert batch["id"].shape == (4,)
    batch2 = next(pipe)
    assert batch2["s_h"].shape == batch["s_h"].shape

    # eval mode: exactly one epoch of full batches
    pipe_eval = BatchPipeline(ds_train, batch_size=5, shuffle=False)
    batches = list(pipe_eval)
    assert len(batches) == 12 // 5


def test_splits_json_override(tiny_dataset_dir, tmp_path):
    """A splits.json in the dataset dir re-partitions id.txt (subset-view
    mechanism for trading train-split size against num_k under the
    device-cache budget)."""
    import json
    import os

    from demo2program_tpu.data.dataset import all_ids

    tr0, te0, va0 = all_ids(tiny_dataset_dir)
    view = tmp_path / "subset_view"
    view.mkdir()
    os.symlink(data_file(tiny_dataset_dir), view / "data.npz")
    # reorder id.txt: 6 train ids first, then the ORIGINAL test ids, then
    # the original val ids (surplus train ids dropped from every split)
    with open(os.path.join(tiny_dataset_dir, "id.txt")) as f:
        ids = [s.strip() for s in f if s.strip()]
    keep_train = [i for i in ids[:12]][:6]
    (view / "id.txt").write_text(
        "\n".join(keep_train + ids[12:16] + ids[16:20]) + "\n")
    (view / "splits.json").write_text(
        json.dumps({"num_train": 6, "num_test": 4, "num_val": 4}))
    tr, te, va = all_ids(str(view))
    assert len(tr) == 6 and set(tr) < set(tr0)
    assert sorted(te) == sorted(te0) and sorted(va) == sorted(va0)
    assert not (set(tr) & set(te)) and not (set(tr) & set(va))
