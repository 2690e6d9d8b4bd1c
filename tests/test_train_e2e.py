"""End-to-end: tiny dataset -> trainer steps -> eval + scorer; plus the
multi-device dryrun on the virtual 8-CPU mesh."""

import sys
import types

import numpy as np
import pytest

from tests.test_data import tiny_dataset_dir  # session fixture  # noqa: F401


pytestmark = pytest.mark.slow  # heavy model-stack compiles; fast gate skips


def _args(dataset_dir, tmp_path, **kw):
    ns = types.SimpleNamespace(
        debug=False, prefix="test", model=kw.get("model",
                                                 "synthesis_baseline"),
        dataset_type="karel", dataset_path=dataset_dir,
        checkpoint=None, num_k=3, batch_size=4, seed=0,
        encoder_rnn_type="lstm", num_lstm_cell_units=32,
        demo_aggregation="avgpool", scheduled_sampling=False,
        scheduled_sampling_decay_steps=20000,
        train_dir=str(tmp_path / "train_dir"),
        learning_rate=1e-3, lr_weight_decay=False,
        log_step=2, write_summary_step=100, test_sample_step=4,
        ckpt_save_step=1000, max_steps=6)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("model", ["synthesis_baseline", "full"])
def test_trainer_e2e(tiny_dataset_dir, tmp_path, model):  # noqa: F811
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer
    from demo2program_tpu.eval.scorer import KarelScorer

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = _args(tiny_dataset_dir, tmp_path / model, model=model)
    trainer = Trainer(args, ds_train, ds_test)
    trainer.train(max_steps=3)
    assert int(trainer.state.step) == 3

    # eval a batch + host/VM scoring
    batch = next(trainer.pipe_test)
    report, evals = trainer.eval_step(trainer.state, batch)
    assert np.isfinite(float(report["loss"]))
    scorer = KarelScorer(trainer.cfg)
    scores = scorer.score_batch(batch, evals)
    assert 0.0 <= scores["greedy_program_syntax_acc"] <= 1.0
    assert scores["greedy_program_execution_acc_hist"].shape == (4,)
    assert abs(scores["greedy_program_execution_acc_hist"].sum() - 1.0) < 1e-5
    # TF-path predictions truncated at gt length are scored too
    assert "program_syntax_acc" in scores

    # checkpoint round trip
    trainer.save()
    step_before = int(trainer.state.step)
    ckpt_path = f"{trainer.ckpt_dir}/{step_before}/default"
    trainer.restore(ckpt_path)
    assert int(trainer.state.step) == step_before


def test_ground_truth_programs_score_perfectly(tiny_dataset_dir):  # noqa: F811
    """Feed the GROUND-TRUTH programs through the scorer: syntax, canonical
    and execution accuracy must all be exactly 1 (oracle sanity)."""
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.eval.scorer import KarelScorer
    from demo2program_tpu.models.common import ModelConfig
    from demo2program_tpu.data import BatchPipeline

    ds_train, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    batch = next(BatchPipeline(ds_train, 6, shuffle=False))
    cfg = ModelConfig(
        model="synthesis_baseline", k=3, test_k=3,
        max_demo_len=ds_train.max_demo_len,
        max_program_len=ds_train.max_program_len)
    scorer = KarelScorer(cfg)
    gt_tokens = batch["program_tokens"]
    gt_len = batch["program_len"][:, 0]
    same = np.ones(6, np.float32)  # exact match by construction
    syntax, exact = scorer.syntax_and_exact(
        gt_tokens, gt_len, same, gt_tokens, gt_len)
    assert syntax.mean() == 1.0 and exact.mean() == 1.0

    # execution against both seen and unseen demos, NOT short-circuited by
    # the same-seq flag (same=0 forces real VM replay)
    nc, _ = scorer.execution(gt_tokens, gt_len, np.zeros(6, np.float32),
                             batch["s_h"], batch["demo_len"])
    assert (nc == 3).all(), nc
    tnc, _ = scorer.execution(gt_tokens, gt_len, np.zeros(6, np.float32),
                              batch["test_s_h"], batch["test_demo_len"])
    assert (tnc == 3).all(), tnc


def test_trainer_bf16_compute(tiny_dataset_dir, tmp_path):  # noqa: F811
    """Mixed precision: forward/backward in bf16, params/opt/loss f32 —
    trains to finite loss and keeps float32 parameter storage."""
    import jax
    import jax.numpy as jnp

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = _args(tiny_dataset_dir, tmp_path, model="full",
                 compute_dtype="bfloat16")
    trainer = Trainer(args, ds_train, ds_test)
    trainer.train(max_steps=2)
    assert int(trainer.state.step) == 2
    leaves = jax.tree_util.tree_leaves(trainer.state.params)
    assert all(x.dtype == jnp.float32 for x in leaves)
    bs_leaves = jax.tree_util.tree_leaves(trainer.state.batch_stats)
    assert all(x.dtype == jnp.float32 for x in bs_leaves)
    batch = next(trainer.pipe_test)
    report, _ = trainer.eval_step(trainer.state, batch)
    assert np.isfinite(float(report["loss"]))


def test_trainer_scheduled_sampling(tiny_dataset_dir, tmp_path):  # noqa: F811
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline",
                 batch_size=4, scheduled_sampling=True,
                 scheduled_sampling_decay_steps=10)
    trainer = Trainer(args, ds_train, ds_test)
    trainer.train(max_steps=3)
    assert int(trainer.state.step) == 3


def test_trainer_auto_resume(tiny_dataset_dir, tmp_path):  # noqa: F811
    """Crash-resume semantics (reference Supervisor, trainer.py:123-140):
    relaunching the same command into a train_dir with checkpoints restores
    the latest full state and finishes the ORIGINAL stage target, ignoring
    --checkpoint."""
    import json
    import os

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline")
    t1 = Trainer(args, ds_train, ds_test)
    t1.train(max_steps=2)  # "crashes" after 2 of an intended 4 steps
    assert int(t1.state.step) == 2
    # pretend the original launch asked for 4 steps
    with open(os.path.join(t1.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": 4}, f)

    # relaunch: same command, plus a bogus --checkpoint that MUST be ignored
    args2 = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline",
                  checkpoint=str(tmp_path / "no_such_ckpt"))
    t2 = Trainer(args2, ds_train, ds_test)
    assert t2._auto_resumed and int(t2.state.step) == 2
    t2.train(max_steps=4)
    assert int(t2.state.step) == 4
    # a third relaunch finds the stage complete and does nothing
    t3 = Trainer(args2, ds_train, ds_test)
    t3.train(max_steps=4)
    assert int(t3.state.step) == 4


def test_check_data_id(tiny_dataset_dir):  # noqa: F811
    import pytest as _pytest
    from demo2program_tpu.data.dataset import (
        check_data_id, create_default_splits)
    ds, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    check_data_id(ds, ds.ids[:2])  # valid
    with _pytest.raises(RuntimeError):
        check_data_id(ds, ["nonexistent_id"])


@pytest.fixture(scope="module")
def mesh_dataset_dir(tmp_path_factory):
    """Tiny dataset whose test split fits a batch-8 eval stream (the shared
    tiny_dataset_dir has only 4 test items)."""
    from demo2program_tpu.data.karel_generator import (
        GeneratorConfig, generate)
    d = tmp_path_factory.mktemp("karel_mesh")
    generate(GeneratorConfig(
        dir_name=str(d), num_train=16, num_test=8, num_val=4,
        num_demo_per_program=5, num_test_demo_per_program=3,
        min_demo_length=4, max_demo_length=12, seed=13), progress_every=0)
    return str(d)


@pytest.mark.slow
def test_trainer_multichip_e2e(mesh_dataset_dir, tmp_path):  # noqa: F811
    """VERDICT r3 next #8: drive the FULL Trainer (not just the jitted
    step) on the 8-device CPU mesh — sharded/replicated cache, chunked
    loop, test-sample eval stream, checkpoint save + auto-resume
    re-replication."""
    import json
    import os

    import jax

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(mesh_dataset_dir, num_k=3)
    args = _args(mesh_dataset_dir, tmp_path, model="synthesis_baseline",
                 batch_size=8, log_step=4, test_sample_step=8,
                 ckpt_save_step=8)
    t1 = Trainer(args, ds_train, ds_test)
    assert int(np.prod(t1.mesh.devices.shape)) == 8
    t1.train(max_steps=12)  # crosses a ckpt boundary at 8
    assert int(t1.state.step) == 12
    from demo2program_tpu.train import checkpoint
    assert 8 in checkpoint.all_steps(t1.ckpt_dir)

    # auto-resume onto the mesh: restored state must re-replicate and the
    # loop must finish the original target
    with open(os.path.join(t1.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": 16}, f)
    t2 = Trainer(args, ds_train, ds_test)
    assert t2._auto_resumed and int(t2.state.step) == 12
    t2.train(max_steps=16)
    assert int(t2.state.step) == 16
    report, _ = t2.eval_step(t2.state, next(t2.pipe_test))
    assert np.isfinite(float(jax.device_get(report["loss"])))


def test_dryrun_multichip():
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_entry_compiles():
    import jax
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import entry
    fn, args = entry()
    loss, tokens = jax.jit(fn)(*args)
    assert np.isfinite(float(loss))
