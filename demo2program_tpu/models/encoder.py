"""Demonstration encoders.

Architecture parity: `models/model_full.py:216-277` (State_Encoder CNN,
Demo_Encoder CNN+LSTM, SecondPathEncoder) and the rn_pool / SummarizeFeature
aggregators (`model_full.py:333-362`; the summarizer baseline uses the pure —
non-residual — rn variant, `model_summarizer.py:345-355`).

Re-design: the reference unrolls a Python loop over the k demos, building k
graph copies with shared weights (`model_full.py:373-398`). Here the k axis
is folded into the batch — one CNN application over (bs*k*T) frames and one
`lax.scan` LSTM over (bs*k) sequences — so every matmul is batched over all
demos instead of k small ones.

dynamic_rnn length semantics replicated: outputs beyond each sequence's
length are zeros; the final state is the state at the last valid step
(`model_full.py:254-257`).
"""

import jax.numpy as jnp

from demo2program_tpu.models import nn


def state_encoder(s, frames, dataset_type="karel"):
    """Per-frame CNN: 3 conv layers for Karel grids, 5 for ViZDoom frames
    (`model_full.py:216-231`); 3x3 kernels, stride 2, 16/32/48(/48/48) ch.
    (B, h, w, depth) -> (B, feat)."""
    x = frames.astype(jnp.float32)  # demos arrive as uint8
    widths = [16, 32, 48] + ([48, 48] if dataset_type == "vizdoom" else [])
    for i, ch in enumerate(widths):
        x = nn.conv_bn(s.child(f"conv{i + 1}"), x, ch)
    return x.reshape(x.shape[0], -1)


def lstm_encoder(s, xs, seq_len, units, init_state=None):
    """Masked LSTM over (B, T, D), frozen past each sequence's length.
    Returns (outputs (B, T, units), final h, final c)."""
    B, T, D = xs.shape
    if init_state is None:
        init_state = (jnp.zeros((B, units), xs.dtype),
                      jnp.zeros((B, units), xs.dtype))
    valid = (jnp.arange(T)[None, :] < seq_len[:, None])[:, :, None]
    cell = nn.lstm_params(s.child("OptimizedLSTMCell_0"), D, units)

    def step(carry, inp):
        c, h = carry
        x, v = inp
        (c_new, h_new), out = nn.lstm_step(cell, (c, h), x)
        return ((jnp.where(v, c_new, c), jnp.where(v, h_new, h)),
                jnp.where(v, out, jnp.zeros_like(out)))

    (c_fin, h_fin), outs = nn.time_major_scan(step, init_state, (xs, valid))
    return outs, h_fin, c_fin


def bilstm_encoder(s, xs, seq_len, units, init_state=None):
    """Bidirectional masked LSTM; outputs and final states are SUMMED over
    the two directions, as the induction baseline does
    (`model_induction.py:435-449` stacks then reduce_sums)."""
    T = xs.shape[1]
    fwd_out, fwd_h, fwd_c = lstm_encoder(s.child("fwd"), xs, seq_len, units,
                                         init_state)
    # per-sequence reversal within each sequence's length
    # (tf.reverse_sequence semantics)
    t_idx = jnp.arange(T)[None, :]
    rev_idx = jnp.where(t_idx < seq_len[:, None],
                        seq_len[:, None] - 1 - t_idx, t_idx)
    xs_rev = jnp.take_along_axis(xs, rev_idx[:, :, None], axis=1)
    bwd_out_rev, bwd_h, bwd_c = lstm_encoder(s.child("bwd"), xs_rev, seq_len,
                                             units, init_state)
    bwd_out = jnp.take_along_axis(bwd_out_rev, rev_idx[:, :, None], axis=1)
    return fwd_out + bwd_out, fwd_h + bwd_h, fwd_c + bwd_c


def demo_encoder(s, s_h, seq_len, units, dataset_type="karel"):
    """CNN per frame -> LSTM over time (`model_full.py:235-258`).

    Input (B, T, h, w, depth); B is typically bs*k (demo axis folded in).
    Returns (feature history (B, T, units), final h, final c).
    """
    B, T = s_h.shape[0], s_h.shape[1]
    frames = s_h.reshape((B * T,) + s_h.shape[2:])
    feats = state_encoder(s.child("state_encoder"), frames, dataset_type)
    return lstm_encoder(s.child("lstm"), feats.reshape(B, T, -1), seq_len,
                        units)


def rn_pool(s, feat, units):
    """Relation-network pooling over the k demo features
    (`model_full.py:333-349`): all k x k pairwise concats -> 2 x FC(units,
    BN+lrelu) -> mean over both k axes, as one (bs*k*k, 2v) matmul."""
    bs, k, v = feat.shape
    tile1 = jnp.broadcast_to(feat[:, None, :, :], (bs, k, k, v))
    tile2 = jnp.broadcast_to(feat[:, :, None, :], (bs, k, k, v))
    x = jnp.concatenate([tile1, tile2], axis=3).reshape(bs * k * k, 2 * v)
    x = nn.fc_bn(s.child("fc1"), x, units)
    x = nn.fc_bn(s.child("fc2"), x, units)
    return x.reshape(bs, k, k, -1).mean(axis=(1, 2))


def summarize_feature(s, features, units, aggregation="avgpool"):
    """Cross-demo aggregation (`model_full.py:351-362`) of (bs, k, v).

    aggregation:
      'avgpool'     mean over k
      'rn'          mean + rn_pool   (full model — residual variant)
      'rn_pure'     rn_pool only     (summarizer baseline variant,
                                      `model_summarizer.py:345-355`)
    """
    if aggregation == "avgpool":
        return features.mean(axis=1)
    if aggregation == "rn":
        return features.mean(axis=1) + rn_pool(s.child("rn_pool"), features,
                                               units)
    if aggregation == "rn_pure":
        return rn_pool(s.child("rn_pool"), features, units)
    raise ValueError(f"unknown aggregation {aggregation!r}")
