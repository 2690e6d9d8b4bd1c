"""Summarizer baseline: two-pass demo encoder + rn-pool summary + program
decoder (no multi-task heads).

Parity target: `models/baselines/model_summarizer.py` — identical encoder
topology to the full model but with PURE rn_pool aggregation (no residual
mean, `model_summarizer.py:345-355`) and only the program decoder.
"""

from demo2program_tpu.models.common import two_pass_demo_encoder
from demo2program_tpu.models.decoder import TokenDecoder
from demo2program_tpu.models.nn import Model


class SummarizerModel(Model):

    def forward(self, s, batch, include_greedy=True, sampling_prob=None,
                rng=None, decode_mode="greedy"):
        cfg = self.cfg
        enc = two_pass_demo_encoder(
            s.child("encoder"), cfg, batch["s_h"],
            batch["demo_len"].astype("int32"), rn_aggregation="rn_pure")

        decoder = TokenDecoder(s.child("program_decoder"),
                               cfg.dim_program_token,
                               cfg.num_lstm_cell_units,
                               cfg.program_end_token)
        gt_tokens = batch["program_tokens"].astype("int32")
        out = {}
        if sampling_prob is not None and self.train:
            tf_logits, sampled = decoder.scheduled(
                enc["demo_c_summary"], enc["demo_h_summary"],
                gt_tokens, sampling_prob, rng, return_sampled=True)
            out["pred_program_tokens"] = sampled
        else:
            tf_logits = decoder.teacher_forced(
                enc["demo_c_summary"], enc["demo_h_summary"], gt_tokens)

        out["pred_program_logits"] = tf_logits
        if include_greedy:
            from demo2program_tpu.models.synthesis import _decode_program
            g_logits, g_tokens, g_len, extras = _decode_program(
                decoder, enc["demo_c_summary"], enc["demo_h_summary"],
                cfg, decode_mode, rng)
            out.update(greedy_program_logits=g_logits,
                       greedy_program_tokens=g_tokens,
                       greedy_program_len=g_len, **extras)
        return out
