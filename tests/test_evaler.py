"""Evaler end-to-end: train briefly, evaluate via the CLI path, check
artifacts."""

import os
import types

import numpy as np
import pytest

from tests.test_data import tiny_dataset_dir  # noqa: F401


pytestmark = pytest.mark.slow  # heavy model-stack compiles; fast gate skips


def test_evaler_end_to_end(tiny_dataset_dir, tmp_path):  # noqa: F811
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer
    from demo2program_tpu.eval.evaler import Evaler
    from tests.test_train_e2e import _args

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    targs = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline",
                  batch_size=4)
    trainer = Trainer(targs, ds_train, ds_test)
    trainer.train(max_steps=2)
    trainer.save()
    step = int(trainer.state.step)
    ckpt = os.path.join(trainer.ckpt_dir, str(step), "default")

    eargs = types.SimpleNamespace(
        debug=False, prefix="e", model="synthesis_baseline",
        dataset_type="karel", dataset_path=tiny_dataset_dir,
        checkpoint=ckpt, num_k=3, batch_size=4, seed=0,
        encoder_rnn_type="lstm", num_lstm_cell_units=32,
        demo_aggregation="avgpool", scheduled_sampling=False,
        scheduled_sampling_decay_steps=20000,
        dataset_split="test", train_dir="", output_dir=str(tmp_path / "out"),
        max_steps=1, no_loss=False, pred_program=True,
        result_data=True, result_data_path=str(tmp_path / "result.npz"),
        id_list=None, unseen_test=False, quiet=False,
        no_write_summary=False, write_summary=True,
        summary_file=str(tmp_path / "report.txt"))

    evaler = Evaler(eargs, ds_test)
    loss_avg, acc_avg, hist_avg = evaler.eval_run()

    # reference metric names present
    for key in ["program_token_acc", "program_seq_acc", "program_syntax_acc",
                "pred_exact_program_accuracy",
                "greedy_exact_program_accuracy",
                "greedy_program_syntax_acc"]:
        assert key in acc_avg, key
    assert "program_loss" in loss_avg and "greedy_program_loss" in loss_avg
    for key in ["program_execution_acc_hist",
                "greedy_program_execution_acc_hist",
                "test_program_execution_acc_hist",
                "test_greedy_program_execution_acc_hist"]:
        assert key in hist_avg, key
        assert abs(hist_avg[key].sum() - 1.0) < 1e-4

    # artifacts
    assert os.path.exists(tmp_path / "report.txt")
    base = tmp_path / "out" / f"out_{evaler.checkpoint_name}_test"
    assert os.path.exists(f"{base}.txt")
    with open(f"{base}.txt") as f:
        body = f.read()
    assert "gt: DEF run m(" in body and "greedy" in body
    from demo2program_tpu.data.store import open_store
    with open_store(f"{base}.npz") as f:
        pid = list(f.keys())[0]
        assert "program_prediction" in f[pid]
        assert f[pid]["program_syntax"][()] in ("wrong", "correct")
        assert "greedy_num_execution_correct" in f[pid]
    with open_store(str(tmp_path / "result.npz")) as f:
        pid = list(f.keys())[0]
        assert f[pid]["s_h"].shape[-1] == 16
        assert "pred_program" in f[pid]


def test_evaler_beam_execution_rerank(tiny_dataset_dir, tmp_path):  # noqa: F811
    """Evaler with --unroll_type beam --execution_rerank: runs end to end,
    reports rerank_changed_rate, and the reranked programs' seen-demo
    execution is at least as good as what plain beam-0 would score."""
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer
    from demo2program_tpu.eval.evaler import Evaler
    from tests.test_train_e2e import _args

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    targs = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline",
                  batch_size=4)
    trainer = Trainer(targs, ds_train, ds_test)
    trainer.train(max_steps=2)
    trainer.save()
    step = int(trainer.state.step)
    ckpt = os.path.join(trainer.ckpt_dir, str(step), "default")

    def eargs(**kw):
        ns = types.SimpleNamespace(
            debug=False, prefix="e", model="synthesis_baseline",
            dataset_type="karel", dataset_path=tiny_dataset_dir,
            checkpoint=ckpt, num_k=3, batch_size=4, seed=0,
            encoder_rnn_type="lstm", num_lstm_cell_units=32,
            demo_aggregation="avgpool", scheduled_sampling=False,
            scheduled_sampling_decay_steps=20000,
            dataset_split="test", train_dir="",
            output_dir=str(tmp_path / "out_beam"),
            max_steps=1, no_loss=False, pred_program=False,
            result_data=False, result_data_path="", id_list=None,
            unseen_test=False, quiet=True, no_write_summary=True,
            write_summary=False, summary_file=None,
            unroll_type="beam", beam_width=3)
        for k, v in kw.items():
            setattr(ns, k, v)
        return ns

    _, acc_beam, hist_beam = Evaler(eargs(), ds_test).eval_run()
    _, acc_rr, hist_rr = Evaler(
        eargs(execution_rerank=True), ds_test).eval_run()
    assert "rerank_changed_rate" in acc_rr
    # seen-demo execution all-correct can only improve under rerank: every
    # changed pick is verified against all seen demos before being chosen
    seen_beam = hist_beam["greedy_program_execution_acc_hist"][-1]
    seen_rr = hist_rr["greedy_program_execution_acc_hist"][-1]
    assert seen_rr >= seen_beam - 1e-6


def test_evaler_cli_sweep_steps(tiny_dataset_dir, tmp_path):  # noqa: F811
    """--sweep_steps evaluates several checkpoints in ONE process (one
    compile), names artifacts per step, and is idempotent on rerun."""
    import shutil

    from demo2program_tpu.cli import evaler_cli
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer
    from tests.test_train_e2e import _args

    ds_train, ds_test, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    targs = _args(tiny_dataset_dir, tmp_path, model="synthesis_baseline",
                  batch_size=4)
    trainer = Trainer(targs, ds_train, ds_test)
    trainer.train(max_steps=2)
    trainer.save()
    step = int(trainer.state.step)
    ckpt_root = os.path.join(trainer.ckpt_dir)
    # a second restorable checkpoint under a different step name is enough
    # to exercise the sweep (restore + per-step naming + skip logic)
    shutil.copytree(os.path.join(ckpt_root, str(step)),
                    os.path.join(ckpt_root, str(step + 2)))

    out_dir = str(tmp_path / "sweep_out")
    argv = ["--dataset_path", tiny_dataset_dir, "--dataset_type", "karel",
            "--quiet", "--pred_program", "--model", "synthesis_baseline",
            "--num_k", "3", "--batch_size", "4", "--max_steps", "1",
            "--train_dir", targs.train_dir, "--output_dir", out_dir,
            "--dataset_split", "test", "--num_lstm_cell_units", "32",
            "--demo_aggregation", "avgpool",
            # step+4 does not exist: must be skipped with a warning
            "--sweep_steps", f"{step},{step + 2},{step + 4}"]
    evaler_cli.main(argv)

    logs = {}
    for s in (step, step + 2):
        p = os.path.join(out_dir, f"out_{s}_test.log")
        assert os.path.exists(p), p
        with open(p) as f:
            assert "Final Avg Report" in f.read()
        logs[s] = os.path.getmtime(p)
    assert not os.path.exists(
        os.path.join(out_dir, f"out_{step + 4}_test.log"))

    # idempotent: a rerun skips everything and rewrites nothing
    evaler_cli.main(argv)
    for s, mtime in logs.items():
        assert os.path.getmtime(
            os.path.join(out_dir, f"out_{s}_test.log")) == mtime
