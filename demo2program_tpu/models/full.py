"""Full model: two-pass summarizer encoder + multi-task heads.

Parity target: `models/model_full.py` — program decoder initialized from the
residual rn summaries (`:351-362,399-404`), plus per-demo action decoders
(shared weights across k, `:525-562`) and perception decoders (`:564-599`).

Re-design: the reference builds k weight-shared decoder copies in a Python
loop; here the k axis folds into the batch for one decoder application
(bs*k sequences through one scan).

Quirk replicated: the "greedy" perception head is teacher-forced
(`model_full.py:409`), hence numerically identical to the training head —
we expose the same tensor under both names.
"""

from demo2program_tpu.models.common import (
    fold_k, two_pass_demo_encoder, unfold_k)
from demo2program_tpu.models.decoder import TokenDecoder, vector_decoder
from demo2program_tpu.models.nn import Model


class FullModel(Model):

    def forward(self, s, batch, include_greedy=True, sampling_prob=None,
                rng=None, decode_mode="greedy"):
        cfg = self.cfg
        bs = batch["s_h"].shape[0]
        k = cfg.k
        units = cfg.num_lstm_cell_units
        demo_len = batch["demo_len"].astype("int32")
        enc = two_pass_demo_encoder(s.child("encoder"), cfg, batch["s_h"],
                                    demo_len, rn_aggregation="rn")

        out = {}

        # --- program decoder ---
        program_decoder = TokenDecoder(
            s.child("program_decoder"), cfg.dim_program_token, units,
            cfg.program_end_token)
        gt_tokens = batch["program_tokens"].astype("int32")
        if sampling_prob is not None and self.train:
            out["pred_program_logits"], out["pred_program_tokens"] = \
                program_decoder.scheduled(
                    enc["demo_c_summary"], enc["demo_h_summary"],
                    gt_tokens, sampling_prob, rng, return_sampled=True)
        else:
            out["pred_program_logits"] = program_decoder.teacher_forced(
                enc["demo_c_summary"], enc["demo_h_summary"], gt_tokens)

        # --- action decoders (k folded into batch; weights shared like the
        # reference's reuse=i>0 loop) ---
        action_decoder = TokenDecoder(
            s.child("action_decoder"), cfg.action_space, units,
            cfg.action_space - 1)  # <e> end token (`model_full.py:430-431`)
        a_c = fold_k(enc["demo_c"])
        a_h = fold_k(enc["demo_h"])
        gt_actions = fold_k(batch["a_h_tokens"].astype("int32"))
        act_logits = action_decoder.teacher_forced(a_c, a_h, gt_actions)
        out["pred_action_logits"] = unfold_k(act_logits, bs, k)

        # --- perception decoders ---
        per_logits = vector_decoder(s.child("per_decoder"), a_c, a_h,
                                    fold_k(batch["per"]), cfg.per_dim, units)
        out["pred_per_logits"] = unfold_k(per_logits, bs, k)
        out["greedy_per_logits"] = out["pred_per_logits"]  # teacher-forced

        if include_greedy:
            from demo2program_tpu.models.synthesis import _decode_program
            g_logits, g_tokens, g_len, extras = _decode_program(
                program_decoder, enc["demo_c_summary"],
                enc["demo_h_summary"], cfg, decode_mode, rng)
            out.update(greedy_program_logits=g_logits,
                       greedy_program_tokens=g_tokens,
                       greedy_program_len=g_len, **extras)
            ga_logits, ga_tokens, ga_len = action_decoder.greedy(
                a_c, a_h, cfg.max_demo_len)
            out.update(
                greedy_action_logits=unfold_k(ga_logits, bs, k),
                greedy_action_tokens=unfold_k(ga_tokens, bs, k),
                greedy_action_len=unfold_k(ga_len, bs, k))
        return out
