"""Synthesis baseline: single-pass demo encoder + program decoder.

Parity target: `models/baselines/model_synthesis.py` — per-demo CNN+LSTM
encoder, concat/avgpool/maxpool aggregation (`:336-358`), LSTM program
decoder with teacher-forced / scheduled-sampling / greedy unrolls
(`:385-490`). No summarizer second pass, no action/perception heads.
"""

from demo2program_tpu.models.common import (
    aggregate_baseline, single_pass_demo_encoder)
from demo2program_tpu.models.decoder import TokenDecoder
from demo2program_tpu.models.nn import Model


class SynthesisModel(Model):

    def forward(self, s, batch, include_greedy=True, sampling_prob=None,
                rng=None, decode_mode="greedy"):
        cfg = self.cfg
        demo_len = batch["demo_len"].astype("int32")

        _, demo_h, demo_c = single_pass_demo_encoder(
            s.child("encoder"), cfg, batch["s_h"], demo_len)
        summary_h, summary_c = aggregate_baseline(
            s, demo_h, demo_c, cfg.demo_aggregation, cfg.num_lstm_cell_units)

        decoder = TokenDecoder(s.child("program_decoder"),
                               cfg.dim_program_token,
                               cfg.num_lstm_cell_units,
                               cfg.program_end_token)
        gt_tokens = batch["program_tokens"].astype("int32")
        out = {}
        if sampling_prob is not None and self.train:
            tf_logits, sampled = decoder.scheduled(
                summary_c, summary_h, gt_tokens, sampling_prob, rng,
                return_sampled=True)
            out["pred_program_tokens"] = sampled
        else:
            tf_logits = decoder.teacher_forced(
                summary_c, summary_h, gt_tokens)

        out["pred_program_logits"] = tf_logits
        if include_greedy:
            g_logits, g_tokens, g_len, extras = _decode_program(
                decoder, summary_c, summary_h, cfg, decode_mode, rng)
            out.update(greedy_program_logits=g_logits,
                       greedy_program_tokens=g_tokens,
                       greedy_program_len=g_len, **extras)
        return out


def _decode_program(decoder, init_c, init_h, cfg, decode_mode, rng):
    """greedy | beam | syntax_greedy | syntax_sample program decoding
    (`model_synthesis.py:384-397` exposes the syntax-constrained unrolls;
    they are karel-only there too). Returns (logits, tokens, lengths,
    extras); extras carries the full beam set for decode_mode='beam' so the
    evaler can execution-rerank candidates against the seen demos."""
    if decode_mode == "greedy":
        return decoder.greedy(init_c, init_h, cfg.max_program_len) + ({},)
    if decode_mode == "beam":
        import jax
        tokens, lengths, beams = decoder.beam(
            init_c, init_h, cfg.max_program_len, cfg.beam_width)
        # indicator "logits" so downstream argmax-based metrics see the
        # beam's tokens (beam search has no per-step distribution to report)
        logits = jax.nn.one_hot(tokens, cfg.dim_program_token)
        return logits, tokens, lengths, {
            "beam_tokens": beams["tokens"],      # (bs, K, L)
            "beam_lengths": beams["lengths"],    # (bs, K)
            "beam_scores": beams["scores"],      # (bs, K) log-prob sums
        }
    if decode_mode in ("syntax_greedy", "syntax_sample"):
        if cfg.dataset_type != "karel":
            raise NotImplementedError(
                "syntax-constrained decoding is defined for the karel DSL "
                "(matching the reference's karel-only dsl_syntax)")
        from demo2program_tpu.dsl.karel_syntax import jnp_tables
        return decoder.greedy_constrained(
            init_c, init_h, cfg.max_program_len, jnp_tables(),
            sample_rng=rng if decode_mode == "syntax_sample" else None) \
            + ({},)
    raise ValueError(f"unknown decode_mode {decode_mode!r}")
