"""ViZDoom dataset loader + model-path tests over a REAL engine-generated
dataset (DoomLite, envs/doomlite.py) — these fixtures replaced the round-1
hand-rolled synthetic datasets once the software engine landed, so the loader,
model and scorer are exercised against genuine engine output."""

import numpy as np
import pytest

from demo2program_tpu.data.merge_datasets import merge
from demo2program_tpu.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu.data.vizdoom_generator import (
    VizdoomGeneratorConfig, generate)

pytestmark = pytest.mark.slow  # heavy model-stack compiles; fast gate skips


H = W = 32  # small frames keep the conv test cheap
C = 3
KD, TKD = 3, 2  # demos / test demos per program
PER = 3  # 'more_simple' percepts


def _gen_real(dir_name, num_train=6, num_test=2, num_val=2, seed=11):
    generate(VizdoomGeneratorConfig(
        dir_name=dir_name, num_train=num_train, num_test=num_test,
        num_val=num_val, num_demo_per_program=KD,
        num_test_demo_per_program=TKD, width=W, height=H,
        min_demo_length=2, max_demo_length=6,
        perception_type="more_simple", seed=seed))


@pytest.fixture(scope="session")
def real_vizdoom_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vizdoom_real"))
    _gen_real(d)
    return d


def test_vizdoom_loader(real_vizdoom_dir):
    ds_train, ds_test, ds_val = create_vizdoom_splits(
        real_vizdoom_dir, num_k=2)
    assert (len(ds_train), len(ds_test), len(ds_val)) == (6, 2, 2)
    item = ds_train.get_data(ds_train.ids[0])
    T = ds_train.max_demo_len
    assert item["s_h"].shape == (2, T, H, W, C)         # num_k sliced
    assert item["test_s_h"].shape == (TKD, T, H, W, C)
    assert item["a_h"].shape == (2, T, 12)              # 11 actions + <e>
    assert item["per"].shape == (2, T, PER)
    n_pos = item["init_pos"].shape[2]
    assert item["init_pos"].shape == (2, 5, n_pos, 2)
    assert item["init_pos_len"].shape == (2, 5)
    assert item["test_init_pos"].shape == (TKD, 5, n_pos, 2)
    # raw pixel scale preserved (real rendered frames)
    assert item["s_h"].max() > 1.5


def test_vizdoom_full_model_forward(real_vizdoom_dir):
    import types

    import jax

    from demo2program_tpu.data import BatchPipeline
    from demo2program_tpu.models import objective
    from demo2program_tpu.models.full import FullModel
    from demo2program_tpu.train.step import strip_non_tensor
    from demo2program_tpu.train.trainer import config_from_dataset

    ds_train, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    args = types.SimpleNamespace(
        model="full", dataset_type="vizdoom", batch_size=2,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=100)
    cfg = config_from_dataset(args, ds_train)
    assert cfg.depth == C and cfg.h == H
    assert cfg.perception_type == "more_simple"
    assert cfg.program_end_token == 3
    assert len(cfg.vizdoom_pos_keys) == 5

    batch = next(BatchPipeline(ds_train, 2, shuffle=False))
    batch = strip_non_tensor(batch)
    model = FullModel(cfg, train=True)
    variables = model.init(jax.random.key(0), batch)
    # the vizdoom path uses the 5-conv state encoder
    enc_params = variables["params"]["encoder"]["demo_encoder"][
        "state_encoder"]
    assert "conv5" in enc_params
    out, _ = model.apply(variables, batch, mutable=["batch_stats"])
    loss, report = objective.compute_loss(cfg, out, batch, "full")
    assert np.isfinite(float(loss))

    # engine-free part of the doom scorer: syntax + canonical
    from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
    from demo2program_tpu.models.objective import program_eval_tensors
    evals = jax.device_get(program_eval_tensors(cfg, out, batch))
    scorer = VizdoomScorer(cfg)
    scores = scorer.score_batch(batch, evals, skip_execution=True)
    assert 0.0 <= scores["greedy_program_syntax_acc"] <= 1.0


def test_scorer_execution_oracle(real_vizdoom_dir):
    """Ground-truth programs replayed through the live engine must score
    execution-correct on every demo (the doom analogue of the Karel oracle
    sanity test) — exercises VizdoomScorer.execution end to end."""
    import types

    from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
    from demo2program_tpu.train.trainer import config_from_dataset

    ds_train, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    args = types.SimpleNamespace(
        model="full", dataset_type="vizdoom", batch_size=2,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=100)
    cfg = config_from_dataset(args, ds_train)
    scorer = VizdoomScorer(cfg, engine_config=None)

    items = [ds_train.get_data(i) for i in ds_train.ids[:2]]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]
             if k != "id"}
    L = batch["program_tokens"].shape[1]
    pred_len = batch["program_len"][:, 0].astype(np.int64)
    # pretend the gt is the prediction, with is_same_seq=0 to force real
    # engine replay rather than the exact-match shortcut
    nc, per_demo = scorer.execution(
        batch["program_tokens"], pred_len, np.zeros(2),
        batch["s_h"], batch["demo_len"],
        batch["init_pos"], batch["init_pos_len"])
    assert per_demo.all(), per_demo


def test_scorer_execution_oracle_v3_sprites(tmp_path):
    """sprite_style=v3 end to end: generate with silhouette sprites, then
    replay gt programs — the dataset records the style, the scorer renders
    with it, and stored frames must match the live replay bit for bit."""
    import types

    from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
    from demo2program_tpu.train.trainer import config_from_dataset

    d = str(tmp_path / "v3ds")
    generate(VizdoomGeneratorConfig(
        dir_name=d, num_train=3, num_test=1, num_val=1,
        num_demo_per_program=KD, num_test_demo_per_program=TKD,
        width=W, height=H, min_demo_length=2, max_demo_length=6,
        perception_type="more_simple", seed=21, sprite_style="v3"))
    ds_train, _, _ = create_vizdoom_splits(d, num_k=2)
    assert ds_train.sprite_style == "v3"
    args = types.SimpleNamespace(
        model="full", dataset_type="vizdoom", batch_size=2,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=100)
    cfg = config_from_dataset(args, ds_train)
    assert cfg.sprite_style == "v3"
    scorer = VizdoomScorer(cfg, engine_config=None)
    items = [ds_train.get_data(i) for i in ds_train.ids[:2]]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]
             if k != "id"}
    pred_len = batch["program_len"][:, 0].astype(np.int64)
    nc, per_demo = scorer.execution(
        batch["program_tokens"], pred_len, np.zeros(2),
        batch["s_h"], batch["demo_len"],
        batch["init_pos"], batch["init_pos_len"])
    assert per_demo.all(), per_demo


def test_merge_datasets(real_vizdoom_dir, tmp_path):
    d2 = str(tmp_path / "shard2")
    _gen_real(d2, seed=9)
    out = str(tmp_path / "merged")
    merge([real_vizdoom_dir, d2], out)
    ds_train, ds_test, ds_val = create_vizdoom_splits(out, num_k=2)
    assert len(ds_train) + len(ds_test) + len(ds_val) == 20
    item = ds_train.get_data(ds_train.ids[0])
    assert item["s_h"].shape[0] == 2


def test_full_k_rerank_arrays_and_pick(real_vizdoom_dir):
    """--rerank_k: Evaler._full_k_rerank_arrays re-reads the batch rows'
    seen demos at full stored k (> num_k), and VizdoomScorer.rerank_pick
    over those arrays rejects a wrong beam that the gt beam survives."""
    import types

    from demo2program_tpu.eval.evaler import Evaler
    from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
    from demo2program_tpu.train.trainer import config_from_dataset

    ds_train, _, _ = create_vizdoom_splits(real_vizdoom_dir, num_k=2)
    args = types.SimpleNamespace(
        model="full", dataset_type="vizdoom", batch_size=2,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=100)
    cfg = config_from_dataset(args, ds_train)
    items = [ds_train.get_data(i) for i in ds_train.ids[:2]]
    batch = {k: (np.stack([it[k] for it in items]) if k != "id"
                 else [it[k] for it in items]) for k in items[0]}

    stub = types.SimpleNamespace(dataset=ds_train)
    aux = Evaler._full_k_rerank_arrays(stub, batch, 99)
    # capped at the stored demo count, and the first num_k rows must agree
    # with the sliced loader view
    assert aux["s_h"].shape[1] == KD
    assert aux["init_pos"].shape[1] == KD
    np.testing.assert_array_equal(aux["s_h"][:, :2], batch["s_h"])
    np.testing.assert_array_equal(aux["demo_len"][:, :2], batch["demo_len"])

    # beam 0 = the OTHER example's program (wrong), beam 1 = gt; full-k
    # engine verification must reject beam 0 and settle on the gt beam
    bt = np.stack([np.stack([batch["program_tokens"][1 - i],
                             batch["program_tokens"][i]])
                   for i in range(2)])
    bl = np.stack([[int(batch["program_len"][1 - i, 0]),
                    int(batch["program_len"][i, 0])]
                   for i in range(2)]).astype(np.int32)
    pick = VizdoomScorer(cfg).rerank_pick(bt, bl, aux)
    assert (pick == 1).all(), pick
