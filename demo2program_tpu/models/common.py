"""Shared model plumbing: configs and the one/two-pass demo encoders."""

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp

from demo2program_tpu.models import nn
from demo2program_tpu.models.encoder import (
    demo_encoder, lstm_encoder, summarize_feature)


@dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters + data dims (the reference injects these
    into its argparse Namespace from the first datum, `trainer.py:304-335`)."""
    model: str = "full"
    dataset_type: str = "karel"
    batch_size: int = 32
    num_lstm_cell_units: int = 512
    demo_aggregation: str = "avgpool"   # synthesis baseline aggregation
    encoder_rnn_type: str = "lstm"
    scheduled_sampling: bool = False
    scheduled_sampling_decay_steps: int = 20000
    # data dims
    dim_program_token: int = 50
    max_program_len: int = 45
    k: int = 10
    test_k: int = 5
    max_demo_len: int = 20
    h: int = 8
    w: int = 8
    depth: int = 16
    action_space: int = 6
    per_dim: int = 5
    # domain metadata
    dsl_type: str = "prob"
    env_type: Optional[str] = None
    # vizdoom-specific metadata (empty/None for karel, `trainer.py:322-335`)
    vizdoom_pos_keys: tuple = ()
    vizdoom_max_init_pos_len: int = -1
    perception_type: str = ""
    level: Optional[str] = None
    # DoomLite sprite rendering style the dataset was generated with
    # (execution scoring replays must render identically)
    sprite_style: str = "v2"
    # program end token id ('m)' for karel, domain vocab supplies otherwise)
    program_end_token: int = 3
    # beam width for decode_mode='beam'
    beam_width: int = 5
    # compute dtype for forward/backward ("float32" | "bfloat16"); params,
    # optimizer state, loss and BN running stats always stay float32
    # (train/step.py casts around model.apply)
    compute_dtype: str = "float32"
    # induction-baseline flags the reference reads but never defines
    # (SURVEY.md §5 config gap) — given concrete defaults here:
    pixel_input: bool = False
    attn_type: str = "luong"
    state_encoder_fc: bool = False
    concat_state_feature_direct_prediction: bool = False
    stack_subsequent_state: bool = False

    def __post_init__(self):
        allowed = ("lstm", "bilstm") if self.model == "induction_baseline" \
            else ("lstm",)
        if self.encoder_rnn_type not in allowed:
            # The reference parses --encoder_rnn_type {lstm,rnn,gru} but its
            # models read cell_state.h/.c and build LSTMStateTuples, which
            # only exist for LSTM (`model_full.py:243-258, 394`): rnn/gru
            # crash at graph build. bilstm exists only in the induction
            # baseline (`model_induction.py:435-449`).
            raise ValueError(
                f"encoder_rnn_type={self.encoder_rnn_type!r} is not "
                f"functional for model={self.model!r} (allowed: {allowed})")


def fold_k(x):
    """(bs, k, ...) -> (bs*k, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def unfold_k(x, bs, k):
    return x.reshape((bs, k) + x.shape[1:])


def single_pass_demo_encoder(s, cfg, s_h, demo_len):
    """Synthesis-baseline encoder: one CNN+LSTM pass over each of the k demos
    (`model_synthesis.py:322-336`). Returns per-demo feature histories and
    final (h, c), each with a (bs, k, ...) layout."""
    bs, k = s_h.shape[0], s_h.shape[1]
    hist, h, c = demo_encoder(s.child("demo_encoder"), fold_k(s_h),
                              fold_k(demo_len), cfg.num_lstm_cell_units,
                              cfg.dataset_type)
    return (unfold_k(hist, bs, k), unfold_k(h, bs, k), unfold_k(c, bs, k))


def two_pass_demo_encoder(s, cfg, s_h, demo_len, rn_aggregation="rn"):
    """Summarizer/full-model encoder (`model_full.py:367-404`): first pass
    per demo, average the final states across demos, then a second LSTM pass
    over the first-pass feature histories initialized with that summary.

    rn_aggregation: 'rn' (residual mean + rn_pool; full model) or 'rn_pure'
    (summarizer baseline).
    """
    bs, k = s_h.shape[0], s_h.shape[1]
    units = cfg.num_lstm_cell_units
    flat_len = fold_k(demo_len)

    hist1, h1, c1 = demo_encoder(s.child("demo_encoder"), fold_k(s_h),
                                 flat_len, units, cfg.dataset_type)

    # cross-demo summaries of the first-pass final states (avgpool,
    # `model_full.py:380-385`)
    summary_h = unfold_k(h1, bs, k).mean(axis=1)
    summary_c = unfold_k(c1, bs, k).mean(axis=1)

    # second pass, every demo initialized with the same summary state
    rep = lambda x: jnp.repeat(x, k, axis=0)
    hist2, h2, c2 = lstm_encoder(
        s.child("second_path").child("lstm"), hist1, flat_len, units,
        init_state=(rep(summary_c), rep(summary_h)))

    demo_h = unfold_k(h2, bs, k)   # (bs, k, units)
    demo_c = unfold_k(c2, bs, k)
    return {
        "feature_history": unfold_k(hist2, bs, k),
        "demo_h": demo_h, "demo_c": demo_c,
        "demo_h_summary": summarize_feature(
            s.child("demo_h_summary"), demo_h, units, rn_aggregation),
        "demo_c_summary": summarize_feature(
            s.child("demo_c_summary"), demo_c, units, rn_aggregation),
    }


def aggregate_baseline(s, demo_h, demo_c, aggregation, units):
    """Synthesis-baseline aggregation (`model_synthesis.py:336-358`).

    'concat' note: the reference feeds the (bs, k*units) concat straight into
    a units-wide LSTM decoder state, which cannot build; we document and fix
    it with a linear projection back to `units` (the only way to make the
    flag usable)."""
    if aggregation == "avgpool":
        return demo_h.mean(axis=1), demo_c.mean(axis=1)
    if aggregation == "maxpool":
        return demo_h.max(axis=1), demo_c.max(axis=1)
    if aggregation == "concat":
        bs = demo_h.shape[0]
        return (nn.dense(s.child("concat_proj_h"), demo_h.reshape(bs, -1),
                         units),
                nn.dense(s.child("concat_proj_c"), demo_c.reshape(bs, -1),
                         units))
    raise ValueError(f"unknown demo aggregation {aggregation!r}")
