"""Program scoring: syntax, canonical-program equality, execution accuracy.

Reference semantics (`model_full.py:602-916`):

  * is_correct_syntax[i] = 1 if the predicted sequence exactly matches the
    ground truth, else whether the prefix up to the predicted length parses
    (`model_full.py:602-616`)
  * exact-program accuracy: canonical-form equality via dsl_enum_program,
    gated on syntax correctness (`model_full.py:713-728`)
  * execution: replay the predicted program from each demo's initial state;
    correct iff the full state sequence and its length match, OR the token
    sequences matched exactly (`model_full.py:747-787, 892-916`); reported
    as #correct-of-k and a histogram over 0..k

The reference interleaves these as tf.py_func serial Python inside the graph;
here syntax + canonical checks run on host (cheap string work) while the
(bs x k) execution grid runs on-device through ops/vm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from demo2program_tpu.dsl import karel_canonical, karel_parser
from demo2program_tpu.dsl.karel_bytecode import (
    DEFAULT_MAX_CODE_LEN, compile_batch)
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.ops import reconstruct, vm
from demo2program_tpu.ops.grids import decode_states


@jax.jit
def _decode_demo_tensors(s_h):
    """(bs, k, T, h, w, 16) -> compact per-step tensors + initial state."""
    dec = decode_states(s_h)
    return dec


class KarelScorer:
    def __init__(self, cfg, vocab=None, max_code_len=DEFAULT_MAX_CODE_LEN):
        self.cfg = cfg
        self.vocab = vocab or KarelVocab()
        self.max_code_len = max_code_len
        self.make_error = cfg.env_type != "no_error"

    # -- host-side string metrics --------------------------------------------
    def syntax_and_exact(self, pred_tokens, pred_len, is_same_seq,
                         gt_tokens, gt_len):
        """Returns (is_correct_syntax (bs,), exact_correct (bs,))."""
        bs = pred_tokens.shape[0]
        syntax = np.zeros(bs, np.float32)
        exact = np.zeros(bs, np.float32)
        for i in range(bs):
            if is_same_seq[i] == 1:
                syntax[i] = 1.0
            else:
                p_str = self.vocab.intseq2str(
                    pred_tokens[i, :int(pred_len[i])])
                _, ok = karel_parser.parse(p_str)
                syntax[i] = float(ok)
            if syntax[i] == 1.0:
                p_str = self.vocab.intseq2str(
                    pred_tokens[i, :int(pred_len[i])])
                g_str = self.vocab.intseq2str(
                    gt_tokens[i, :int(gt_len[i])])
                exact[i] = float(
                    karel_canonical.programs_equal(p_str, g_str))
        return syntax, exact

    # -- on-device execution accuracy ----------------------------------------
    def execution(self, pred_tokens, pred_len, is_same_seq, s_h, demo_len):
        """Execution correctness of predicted programs against (bs, k) demos
        given the full (bs, k, T, h, w, 16) state tensors.

        Returns (num_correct (bs,), is_correct (bs, k)).
        """
        bs, k = s_h.shape[0], s_h.shape[1]
        dec = _decode_demo_tensors(jnp.asarray(s_h))

        def flat(a):  # (bs, k, ...) -> (bs*k, ...)
            return a.reshape((bs * k,) + a.shape[2:])

        target = {
            "wall": flat(dec["wall"][:, :, 0]),
            "y": flat(dec["y"]), "x": flat(dec["x"]), "d": flat(dec["d"]),
            "markers": flat(dec["markers"]),
        }
        init = (flat(dec["y"][:, :, 0]), flat(dec["x"][:, :, 0]),
                flat(dec["d"][:, :, 0]), flat(dec["markers"][:, :, 0]))
        return self._execute_against(pred_tokens, pred_len, is_same_seq,
                                     target, init, demo_len, bs, k)

    def execution_compact(self, pred_tokens, pred_len, is_same_seq, batch,
                          test=False):
        """Execution correctness against a COMPACT wire-format batch: the
        target state sequences are replayed on device from initial state +
        recorded actions (ops/reconstruct.py), so the full demo tensors
        never exist host-side at all."""
        pfx = "test_" if test else ""
        rep, bs, k = (reconstruct.replay_test(batch, self.cfg) if test
                      else reconstruct.replay_seen(batch, self.cfg))
        init = (rep["y"][:, 0], rep["x"][:, 0], rep["d"][:, 0],
                rep["markers"][:, 0])
        target = {"wall": rep["wall"], "y": rep["y"], "x": rep["x"],
                  "d": rep["d"], "markers": rep["markers"]}
        return self._execute_against(
            pred_tokens, pred_len, is_same_seq, target, init,
            batch[pfx + "demo_len"], bs, k)

    def _execute_against(self, pred_tokens, pred_len, is_same_seq, target,
                         init, demo_len, bs, k):
        codes, compiled_ok = compile_batch(
            np.asarray(pred_tokens), np.asarray(pred_len), self.vocab,
            self.max_code_len)
        codes_rep = np.repeat(codes, k, axis=0)  # program per demo
        out = vm.run_and_compare(
            jnp.asarray(codes_rep), target["wall"],
            init[0], init[1], init[2], init[3],
            target["y"], target["x"], target["d"], target["markers"],
            jnp.asarray(demo_len, jnp.int32).reshape(bs * k),
            make_error=self.make_error, h=self.cfg.h, w=self.cfg.w)

        vm_correct = np.asarray(out["correct"]).reshape(bs, k)
        same = np.asarray(is_same_seq).astype(bool)[:, None]
        ok = compiled_ok[:, None]
        # reference gating: execute only when syntactically valid and not an
        # exact token match; exact matches are correct by definition
        is_correct = (vm_correct & ok & ~same) | same
        return is_correct.sum(axis=1).astype(np.float32), is_correct

    def execution_histogram(self, num_correct, k):
        hist = np.zeros(k + 1, np.float32)
        for i in range(k + 1):
            hist[i] = float((num_correct == i).sum()) / len(num_correct)
        return hist

    def rerank_pick(self, beam_tokens, beam_lens, batch):
        """Execution-guided beam selection: pick, per example, the first
        (= highest-scoring; beams arrive score-sorted) beam whose program
        reproduces ALL seen demos — the model's own inputs, no test-demo
        information — falling back to the best-scoring beam. The reference
        has no counterpart (greedy only); this is this framework's
        inference-time search: each beam is verified as one batched VM call.
        Returns pick (bs,) int."""
        bs, K, _ = beam_tokens.shape
        all_ok = np.zeros((bs, K), bool)
        no_shortcut = np.zeros(bs, np.float32)
        for j in range(K):
            nc, _ = self.execution_compact(
                beam_tokens[:, j], beam_lens[:, j], no_shortcut, batch)
            all_ok[:, j] = nc == self.cfg.k
        return np.where(all_ok.any(axis=1), all_ok.argmax(axis=1), 0)

    def score_batch(self, batch, evals, prefix=""):
        """Full scoring of one eval batch for both TF-path and greedy
        predictions. `evals` comes from objective.program_eval_tensors.
        Returns a flat dict of scalars + per-example arrays."""
        gt_tokens = np.asarray(batch["program_tokens"])
        gt_len = np.asarray(batch["program_len"])[:, 0].astype(np.int64)
        res = {}
        for name, tok_key, len_key, same_key in [
                ("", "pred_tokens", "pred_len", "pred_is_same_seq"),
                ("greedy_", "greedy_tokens", "greedy_len",
                 "greedy_is_same_seq")]:
            if tok_key not in evals:
                continue
            tokens = np.asarray(evals[tok_key])
            lens = np.asarray(evals[len_key])
            same = np.asarray(evals[same_key])
            syntax, exact = self.syntax_and_exact(
                tokens, lens, same, gt_tokens, gt_len)
            res[f"{name}is_correct_syntax"] = syntax
            res[f"{name}exact_program_correct"] = exact
            res[f"{name}program_syntax_acc"] = float(syntax.mean())
            res[f"{name}exact_program_acc"] = float(exact.mean())

            compact = reconstruct.is_compact(batch)
            if compact:
                nc, per_demo = self.execution_compact(tokens, lens, same,
                                                      batch)
            else:
                nc, per_demo = self.execution(tokens, lens, same,
                                              np.asarray(batch["s_h"]),
                                              np.asarray(batch["demo_len"]))
            res[f"{name}program_is_correct_execution"] = per_demo
            res[f"{name}program_num_execution_correct"] = nc
            res[f"{name}program_execution_acc_hist"] = \
                self.execution_histogram(nc, self.cfg.k)
            # all-k-correct rate: the headline "execution accuracy"
            res[f"{name}program_execution_all_correct"] = float(
                (nc == self.cfg.k).mean())

            if compact:
                tnc, _ = self.execution_compact(tokens, lens, same, batch,
                                                test=True)
            else:
                tnc, _ = self.execution(tokens, lens, same,
                                        np.asarray(batch["test_s_h"]),
                                        np.asarray(batch["test_demo_len"]))
            res[f"test_{name}program_num_execution_correct"] = tnc
            res[f"test_{name}program_execution_acc_hist"] = \
                self.execution_histogram(tnc, self.cfg.test_k)
            res[f"test_{name}program_execution_all_correct"] = float(
                (tnc == self.cfg.test_k).mean())
        return res
