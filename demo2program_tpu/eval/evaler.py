"""Evaluation driver.

Parity target: the reference `evaler.py` — restores an explicit checkpoint
(or the latest in a train_dir), walks a data split without shuffling for a
fixed number of full batches, and produces:

  * per-batch + final-average loss/accuracy/histogram report lines
    (`evaler.py:292-359`)
  * `--pred_program`: out_<ckpt>_<split>.txt (gt vs pred vs greedy programs),
    .npz (per-id predictions, syntax verdicts, execution correctness; the
    reference wrote this as .hdf5), .log (`evaler.py:108-240`)
  * `--result_data`: a store (data/store.py) joining predictions with raw
    demos (`evaler.py:130-162`)
  * a summary report file `<ckpt>_report_testdata{N}_num_k{K}.txt`
    (`evaler.py:93-94, 324-359`)

Metric names match the reference's report_loss / report_accuracy /
report_hist keys (`model_full.py:1099-1132`). Execution accuracy runs on the
on-device Karel VM (ops/vm.py) instead of serial tf.py_func rollouts.
"""

import os
import time

import jax
import numpy as np

from demo2program_tpu.data import BatchPipeline
from demo2program_tpu.data.store import NpzWriter, data_file, open_store
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.dsl.vizdoom_vocab import VizDoomDSLVocab
from demo2program_tpu.eval.scorer import KarelScorer
from demo2program_tpu.models import get_model_class
from demo2program_tpu.train import checkpoint
from demo2program_tpu.train.step import (
    TrainState, make_eval_step, strip_non_tensor)
from demo2program_tpu.train.trainer import config_from_dataset
from demo2program_tpu.utils import log


class Evaler:
    def __init__(self, args, dataset):
        self.args = args
        self.dataset = dataset
        self.cfg = config_from_dataset(args, dataset)
        self.vocab = KarelVocab()
        model_cls = get_model_class(args.model)
        self.model = model_cls(self.cfg, train=False)

        example = dataset.get_data(dataset.ids[0])
        example_batch = {k: (np.stack([v] * args.batch_size)
                             if k != "id" else np.array([v]))
                         for k, v in example.items()}
        variables = self.model.init(
            jax.random.key(123), strip_non_tensor(example_batch))
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})

        self.checkpoint = args.checkpoint or ""
        if not self.checkpoint and getattr(args, "train_dir", ""):
            step = checkpoint.latest_step(
                os.path.join(os.path.abspath(args.train_dir), "ckpt"))
            if step is not None:
                self.checkpoint = checkpoint.path_of(
                    os.path.join(os.path.abspath(args.train_dir), "ckpt"),
                    step)
        if self.checkpoint:
            self._restore(self.checkpoint)
            self.checkpoint_name = os.path.basename(
                os.path.dirname(self.checkpoint.rstrip("/")))
        else:
            log.warn("No checkpoint is given. Just random initialization :-)")
            self.checkpoint_name = "random_init"

        self._state = TrainState(step=np.zeros((), np.int32),
                                 params=self.params,
                                 batch_stats=self.batch_stats,
                                 opt_state=None)
        self.eval_step = make_eval_step(
            self.model, self.cfg, args.model,
            decode_mode=getattr(args, "unroll_type", "greedy"))
        if args.dataset_type == "vizdoom":
            from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
            self.vocab = VizDoomDSLVocab(
                perception_type=self.cfg.perception_type,
                level=self.cfg.level or "not_simple")
            self.scorer = VizdoomScorer(self.cfg, self.vocab)
        else:
            self.scorer = KarelScorer(self.cfg, self.vocab)
        self.summary_file = self.checkpoint + \
            "_report_testdata{}_num_k{}.txt".format(
                args.max_steps * args.batch_size, args.num_k)

    def _restore(self, path):
        """Restore params/batch_stats from a saved TrainState."""
        restored = checkpoint.restore(
            os.path.abspath(path),
            TrainState(step=np.zeros((), np.int32), params=self.params,
                       batch_stats=self.batch_stats, opt_state=None))
        self.params = restored.params
        self.batch_stats = restored.batch_stats
        log.info("Loaded from checkpoint: %s", path)

    def set_checkpoint(self, path):
        """Re-aim this Evaler at another checkpoint of the SAME run.

        Checkpoint-sweep support (val-selection protocols evaluate every
        saved step): params/batch_stats swap while the jitted eval_step is
        reused, so only the first checkpoint of a sweep pays the XLA
        compile + process startup.
        """
        self._restore(path)
        self.checkpoint = os.path.abspath(path)
        self.checkpoint_name = os.path.basename(
            os.path.dirname(self.checkpoint.rstrip("/")))
        self._state = TrainState(step=np.zeros((), np.int32),
                                 params=self.params,
                                 batch_stats=self.batch_stats,
                                 opt_state=None)
        self.summary_file = self.checkpoint + \
            "_report_testdata{}_num_k{}.txt".format(
                self.args.max_steps * self.args.batch_size, self.args.num_k)

    # ---------------------------------------------------------------------
    def eval_run(self):
        args = self.args
        cfg = self.cfg
        # Karel evals stream the compact wire format; demos are replayed on
        # device for execution scoring (ops/reconstruct.py)
        pipe = BatchPipeline(self.dataset, args.batch_size, shuffle=False,
                             compact=args.dataset_type == "karel")
        max_steps = args.max_steps or pipe.steps_per_epoch()

        text_file = pred_file = log_file = None
        if args.pred_program:
            os.makedirs(args.output_dir, exist_ok=True)
            base = os.path.join(args.output_dir, "out_{}_{}".format(
                self.checkpoint_name, args.dataset_split))
            text_file = open(base + ".txt", "w")
            pred_file = NpzWriter(base + ".npz")
            log_file = open(base + ".log", "w")
        result_file = source = None
        if args.result_data:
            result_file = NpzWriter(args.result_data_path)
            source = open_store(data_file(args.dataset_path))

        rerank = getattr(args, "execution_rerank", False)
        self._rerank_changed = self._rerank_total = 0
        sums, hist_sums = {}, {}
        t_total = 0.0
        for s in range(max_steps):
            t0 = time.time()
            batch = next(pipe)
            report, evals = self.eval_step(self._state, batch)
            report = {k: np.asarray(v) for k, v in
                      jax.device_get(report).items()}
            evals = jax.device_get(evals)
            if rerank and evals and "beam_tokens" in evals:
                self._apply_rerank(batch, evals)
            scores = self.scorer.score_batch(batch, evals) if evals else {}
            step_time = time.time() - t0
            t_total += step_time

            loss_d, acc_d, hist_d = self._assemble(report, evals, scores)
            msg = self._step_msg(s, loss_d, acc_d, hist_d, step_time,
                                 quiet=args.quiet)
            for d, store in ((loss_d, sums), (acc_d, sums)):
                for k, v in d.items():
                    store[k] = store.get(k, 0.0) + float(v)
            for k, v in hist_d.items():
                hist_sums[k] = hist_sums.get(k, np.zeros_like(v)) + v

            if args.pred_program and evals:
                log_file.write(msg + "\n")
                log_file.flush()
                self._write_artifacts(batch, evals, scores,
                                      text_file, pred_file)
            if args.result_data and evals:
                self._write_result_data(batch, evals, result_file, source)

        loss_avg = {k: v / max_steps for k, v in sums.items()
                    if k.endswith("loss")}
        acc_avg = {k: v / max_steps for k, v in sums.items()
                   if not k.endswith("loss")}
        hist_avg = {k: v / max_steps for k, v in hist_sums.items()}
        # how often canonical-program comparison hit the expansion-size cap
        # and fell back to exact-token equality (VERDICT r2: if >0 this
        # biases program accuracy down, so it must be visible)
        from demo2program_tpu.dsl.karel_canonical import STATS as _CSTATS
        if _CSTATS["compares"]:
            acc_avg["canonical_fallback_rate"] = (
                _CSTATS["cap_fallbacks"] / _CSTATS["compares"])
        if rerank and self._rerank_total:
            acc_avg["rerank_changed_rate"] = (
                self._rerank_changed / self._rerank_total)
        final = self._final_msg(loss_avg, acc_avg, hist_avg, t_total)

        if args.write_summary:
            with open(args.summary_file or self.summary_file, "w") as f:
                f.write("Model class: {}\nCheckpoint: {}\nDataset: {}\n{}"
                        .format(args.model, self.checkpoint,
                                args.dataset_path, final))
        if args.pred_program:
            log_file.write(final + "\n")
            log_file.write("Model class: {}\n".format(args.model))
            log_file.write("Checkpoint: {}\n".format(self.checkpoint))
            log_file.write("Dataset: {}\n".format(args.dataset_path))
            for f in (text_file, log_file):
                f.close()
            pred_file.close()
        if args.result_data:
            result_file.close()
            source.close()
        log.warning("Completed Evaluation.")
        return loss_avg, acc_avg, hist_avg

    # ---------------------------------------------------------------------
    def _apply_rerank(self, batch, evals):
        """Execution-guided beam selection (--unroll_type beam
        --execution_rerank): re-point the greedy_* eval tensors at the
        highest-scoring beam that reproduces all SEEN demos (scorer
        .rerank_pick — seen demos are the model's own inputs, so this uses
        no test information), then recompute the sequence/token stats
        host-side for the picked programs. The reference has no
        counterpart; greedy numbers are always reported separately."""
        bt = np.asarray(evals["beam_tokens"])
        bl = np.asarray(evals["beam_lengths"]).astype(np.int32)
        bscore = np.asarray(evals["beam_scores"])
        order = np.argsort(-bscore, axis=1, kind="stable")
        bt = np.take_along_axis(bt, order[:, :, None], axis=1)
        bl = np.take_along_axis(bl, order, axis=1)
        rerank_k = int(getattr(self.args, "rerank_k", 0) or 0)
        if rerank_k > self.cfg.k and self.args.dataset_type == "vizdoom":
            pick = self.scorer.rerank_pick(
                bt, bl, self._full_k_rerank_arrays(batch, rerank_k))
        else:
            pick = self.scorer.rerank_pick(bt, bl, batch)
        rows = np.arange(len(pick))
        tokens, lens = bt[rows, pick], bl[rows, pick]
        self._rerank_changed += int((pick != 0).sum())
        self._rerank_total += len(pick)

        gt_tokens = np.asarray(batch["program_tokens"])
        gt_len = np.asarray(batch["program_len"])[:, 0].astype(int)
        bs = tokens.shape[0]
        same = np.zeros(bs, np.float32)
        tok_acc = np.zeros(bs, np.float32)
        for i in range(bs):
            gl, pl = int(gt_len[i]), int(lens[i])
            m = min(gl, pl)
            match = (tokens[i, :m] == gt_tokens[i, :m]).sum()
            tok_acc[i] = match / max(gl, pl, 1)
            same[i] = float(pl == gl and match == gl)
        evals["greedy_tokens"] = tokens
        evals["greedy_len"] = lens
        evals["greedy_is_same_seq"] = same
        evals["greedy_program_seq_acc"] = same.mean()
        evals["greedy_program_token_acc"] = tok_acc.mean()

    def _full_k_rerank_arrays(self, batch, rk):
        """--rerank_k: re-read the batch rows' SEEN demos from the dataset
        store at rk > num_k demos (doom device-memory budgets force small
        train-time num_k; the stored extra seen demos of the same task
        instance make a stronger execution-verification set, still using
        no test-demo information). Returns the 4 arrays VizdoomScorer.rerank_pick reads."""
        ds = self.dataset
        rk = min(rk, ds.num_demo)
        s_h, dl, ip, ipl = [], [], [], []
        for id_ in batch["id"]:
            grp = ds._store[str(id_)]
            demo = grp["s_h"][()][:rk]
            pad = np.zeros([rk, ds.max_demo_len] + list(demo.shape[2:]),
                           demo.dtype)
            pad[:, :demo.shape[1]] = demo
            s_h.append(pad.astype(np.uint8))
            dl.append(grp["s_h_len"][()][:rk].astype(np.float32))
            pos = grp["vizdoom_init_pos"][()][:rk]
            ppad = np.zeros([rk, pos.shape[1],
                             ds.vizdoom_max_init_pos_len, 2], pos.dtype)
            ppad[:, :, :pos.shape[2], :] = pos
            ip.append(ppad.astype(np.int32))
            ipl.append(grp["vizdoom_init_pos_len"][()][:rk].astype(np.int32))
        return {"s_h": np.stack(s_h), "demo_len": np.stack(dl),
                "init_pos": np.stack(ip), "init_pos_len": np.stack(ipl)}

    def _assemble(self, report, evals, scores):
        """Split scalars into the reference's loss/acc/hist dicts with its
        metric names."""
        loss_d = {k: float(v) for k, v in report.items()
                  if k.endswith("loss")}
        if not evals:
            # induction baseline: action metrics only, dummy program fetches
            # (`model_induction.py:866-875`)
            acc_d = {k: float(v) for k, v in report.items()
                     if k.endswith("acc")}
            return loss_d, acc_d, {}
        acc_d = {
            "program_token_acc": float(report["program_token_acc"]),
            "program_seq_acc": float(report["program_seq_acc"]),
            "program_syntax_acc": scores["program_syntax_acc"],
            "pred_exact_program_accuracy": scores["exact_program_acc"],
            "greedy_exact_program_accuracy":
                scores["greedy_exact_program_acc"],
            "greedy_program_token_acc":
                float(evals["greedy_program_token_acc"]),
            "greedy_program_seq_acc":
                float(evals["greedy_program_seq_acc"]),
            "greedy_program_syntax_acc":
                scores["greedy_program_syntax_acc"],
        }
        loss_d["greedy_program_loss"] = float(evals["greedy_program_loss"])
        for k in ("avg_action_token_acc", "avg_action_seq_acc",
                  "greedy_avg_action_token_acc", "greedy_avg_action_seq_acc"):
            if k in report:
                acc_d[k] = float(report[k])
        hist_d = {k: np.asarray(v) for k, v in scores.items()
                  if k.endswith("_hist")}
        return loss_d, acc_d, hist_d

    def _write_artifacts(self, batch, evals, scores, text_file, pred_file):
        correctness = ["wrong", "correct"]
        ids = batch["id"]
        gt_tokens = np.asarray(batch["program_tokens"])
        gt_len = np.asarray(batch["program_len"])[:, 0].astype(int)
        pred_tokens = np.asarray(evals["pred_tokens"])
        pred_len = np.asarray(evals["pred_len"]).astype(int)
        g_tokens = np.asarray(evals["greedy_tokens"])
        g_len = np.asarray(evals["greedy_len"]).astype(int)
        for i in range(len(ids)):
            pid = str(ids[i])
            pred_str = self.vocab.intseq2str(pred_tokens[i, :pred_len[i]])
            greedy_str = self.vocab.intseq2str(g_tokens[i, :g_len[i]])
            try:
                grp = pred_file.create_group(pid)
            except ValueError:
                pass
            else:
                grp["program_prediction"] = pred_str
                grp["program_syntax"] = correctness[
                    int(scores["is_correct_syntax"][i])]
                grp["program_num_execution_correct"] = int(
                    scores["program_num_execution_correct"][i])
                grp["program_is_correct_execution"] = \
                    scores["program_is_correct_execution"][i]
                grp["greedy_prediction"] = greedy_str
                grp["greedy_syntax"] = correctness[
                    int(scores["greedy_is_correct_syntax"][i])]
                grp["greedy_num_execution_correct"] = int(
                    scores["greedy_program_num_execution_correct"][i])
                grp["greedy_is_correct_execution"] = \
                    scores["greedy_program_is_correct_execution"][i]
            text_file.write(
                "[id: {}]\ngt: {}\npred{}: {}\ngreedy{}: {}\n".format(
                    pid,
                    self.vocab.intseq2str(gt_tokens[i, :gt_len[i]]),
                    "(error)" if scores["is_correct_syntax"][i] == 0 else "",
                    pred_str,
                    "(error)" if scores["greedy_is_correct_syntax"][i] == 0
                    else "",
                    greedy_str))

    def _write_result_data(self, batch, evals, result_file, source):
        ids = batch["id"]
        g_tokens = np.asarray(evals["greedy_tokens"])
        g_len = np.asarray(evals["greedy_len"]).astype(int)
        for i in range(len(ids)):
            pid = str(ids[i])
            try:
                grp = result_file.create_group(pid)
            except ValueError:
                log.info("Duplicates: %s", pid)
                continue
            if "program" in batch:
                grp["program"] = np.asarray(batch["program"])[i]
            else:  # compact wire: rebuild the one-hot host-side
                tok = np.asarray(batch["program_tokens"])[i]
                plen = int(np.asarray(batch["program_len"])[i, 0])
                oh = np.zeros(
                    (self.cfg.dim_program_token, tok.shape[0]), bool)
                oh[tok[:plen], np.arange(plen)] = True
                grp["program"] = oh
            grp["pred_program"] = g_tokens[i]
            grp["pred_program_len"] = g_len[i]
            grp["s_h"] = source[pid]["s_h"][()]
            grp["test_s_h"] = source[pid]["test_s_h"][()]

    # ---------------------------------------------------------------------
    def _fmt_hist(self, hist_d):
        out = ""
        for k in sorted(hist_d):
            out += "{}: [".format(k)
            for h in hist_d[k]:
                out += "{acc: .3f}, ".format(acc=h)
            out += "] "
        return out

    def _step_msg(self, step, loss_d, acc_d, hist_d, step_time, quiet=False):
        loss_str = "".join("{}:{loss: .3f} ".format(k, loss=loss_d[k])
                           for k in sorted(loss_d))
        acc_str = "".join("{}:{acc: .3f} ".format(k, acc=acc_d[k])
                          for k in sorted(acc_d))
        msg = ("[{:5s} step {:5d}] {}{}{}({:.3f} sec/batch, "
               "{:.3f} instances/sec)").format(
            "val", step, loss_str, acc_str, self._fmt_hist(hist_d),
            step_time, self.args.batch_size / max(step_time, 1e-3))
        if not quiet:
            log.infov(msg)
        return msg

    def _final_msg(self, loss_avg, acc_avg, hist_avg, t_total):
        loss_str = "".join("{}:{loss: .3f} ".format(k, loss=loss_avg[k])
                           for k in sorted(loss_avg))
        acc_str = "\n".join("{}:{acc: .3f}".format(k, acc=acc_avg[k])
                            for k in sorted(acc_avg))
        hist_str = "\n".join(
            "{}: [{}]".format(k, "".join("{acc: .3f}, ".format(acc=h)
                                         for h in hist_avg[k]))
            for k in sorted(hist_avg))
        msg = ("[Final Avg Report] \n[Loss] {}\n[Acc]  {}\n[Hist] {}\n"
               "[Time] ({:.3f} sec)").format(loss_str, acc_str, hist_str,
                                             t_total)
        log.infov(msg)
        log.infov("Model class: %s", self.args.model)
        log.infov("Checkpoint: %s", self.checkpoint)
        log.infov("Dataset: %s", self.args.dataset_path)
        return msg
