"""Induction baseline: no program decoding — predicts the action sequence of
each TEST demonstration with an LSTM that attends over all k seen-demo
feature histories.

Parity target: `models/baselines/model_induction.py`:
  * state encoder = 3 convs (5 with pixel_input) + optional 2xFC, with the
    per-step perception vector CONCATENATED to the frame feature (`:399-422`)
  * demo encoder over the k seen demos; concat/avgpool/maxpool aggregation of
    final (h, c) (`:524-553`)
  * manipulation decoder per test demo: LSTM wrapped in a pooling attention
    wrapper — Luong attention over each of the k feature histories, one
    SHARED memory projection and one SHARED attention layer (TF variable
    reuse makes the per-mechanism layers alias, `:615-667` + `:25-53`),
    attention outputs averaged over k (`:169-171`), attention output (not
    cell output) projected to action logits, and the previous attention
    concatenated to the next input (AttentionWrapper default cell_input_fn)
  * QUIRK replicated: the decoder's initial cell state is
    LSTMStateTuple(demo_h_summary, demo_c_summary) — h and c SWAPPED relative
    to every other model (LSTMStateTuple's first field is c; `:675-677`)
  * metrics: per-test-demo action token/seq acc + `seq_all_acc` — fraction of
    tasks where ALL test_k sequences match (`:816-819`)

Config flags the reference reads but never defines (SURVEY.md §5) get
concrete defaults in ModelConfig: pixel_input=False, attn_type='luong',
state_encoder_fc=False, concat_state_feature_direct_prediction=False,
stack_subsequent_state=False.

Both attn_type variants are implemented: 'luong' and 'luong_monotonic'
(reference `:645-656`; the monotonic energies/recursive alignment are in
_AttnDecoder below, tested in tests/test_induction.py).
"""

import jax
import jax.numpy as jnp

from demo2program_tpu.models import nn
from demo2program_tpu.models.common import (
    aggregate_baseline, fold_k, unfold_k)
from demo2program_tpu.models.encoder import bilstm_encoder, lstm_encoder
from demo2program_tpu.models.nn import Model


def induction_state_encoder(s, cfg, frames, per):
    """CNN (+ optional FCs) with the perception vector concatenated.
    frames: (B, h, w, depth), per: (B, per_dim)."""
    x = frames.astype(jnp.float32)  # demos arrive as uint8
    widths = [16, 32, 48] + ([48, 48] if cfg.pixel_input else [])
    for i, ch in enumerate(widths):
        x = nn.conv_bn(s.child(f"conv{i + 1}"), x, ch)
    x = x.reshape(x.shape[0], -1)
    if cfg.state_encoder_fc:
        x = nn.fc_bn(s.child("fc1"), x, 512)
        x = nn.fc_bn(s.child("fc2"), x, 512)
    return jnp.concatenate([x, per.astype(jnp.float32)], axis=-1)


def induction_demo_encoder(s, cfg, s_h, per, seq_len):
    """s_h: (B, T, h, w, depth); per: (B, T, per_dim)."""
    B, T = s_h.shape[0], s_h.shape[1]
    frames = s_h.reshape((B * T,) + s_h.shape[2:])
    pers = per.reshape(B * T, per.shape[-1])
    feats = induction_state_encoder(s.child("state_encoder"), cfg, frames,
                                    pers).reshape(B, T, -1)
    encode = (bilstm_encoder if cfg.encoder_rnn_type == "bilstm"
              else lstm_encoder)
    outs, h, c = encode(s.child("lstm"), feats, seq_len,
                        cfg.num_lstm_cell_units)
    if cfg.concat_state_feature_direct_prediction:
        outs = jnp.concatenate([outs, feats], axis=-1)
    return outs, h, c


class _AttnDecoder:
    """The attention-decoder step (parameters under `manipulation/`).

    attn_type 'luong': softmax alignments. 'luong_monotonic': Raffel et al.
    monotonic attention in the parallel-training formulation used by TF's
    LuongMonotonicAttention (`model_induction.py:649-651`):

        p      = sigmoid(score)
        cp     = exclusive-cumprod(1 - p)
        align  = p * cp * cumsum(prev_align / max(cp, eps))

    with alignments initialized to a dirac at position 0.
    """

    def __init__(self, s, action_space, units, mem_units, attn_type):
        self.attn_type = attn_type
        self.table = nn.embedding(s, action_space + 1, units)
        self.cell = nn.lstm_params(s.child("cell"), 2 * units, units)
        # shared Luong memory projection + shared attention layer (see module
        # docstring re the reference's variable aliasing)
        self.w_attn = s.child("attention_layer").param(
            "kernel", nn.lecun_normal, (units + mem_units, units))
        self.w_out = s.child("output_projection").param(
            "kernel", nn.lecun_normal, (units, action_space))

    def embed(self, ids):
        return nn.embed(self.table, ids)

    def __call__(self, carry, x_emb, memory, keys, mask):
        """x_emb: (bs, E); memory/keys: (bs, k, T, units); mask: (bs, k, T)"""
        (c, h), attention, prev_align = carry
        cell_in = jnp.concatenate([x_emb, attention], axis=-1)
        (c, h), out = nn.lstm_step(self.cell, (c, h), cell_in)
        # Luong scores against all k memories at once
        scores = jnp.einsum("bu,bktu->bkt", out, keys)
        scores = jnp.where(mask, scores, -1e9)
        if self.attn_type == "luong_monotonic":
            p = jax.nn.sigmoid(scores)
            one_minus = jnp.where(mask, 1.0 - p, 1.0)
            cp = jnp.cumprod(
                jnp.concatenate([jnp.ones_like(one_minus[..., :1]),
                                 one_minus[..., :-1]], axis=-1), axis=-1)
            q = prev_align / jnp.clip(cp, 1e-10, 1.0)
            align = p * cp * jnp.cumsum(q, axis=-1)
            align = jnp.where(mask, align, 0.0)
        else:
            align = jax.nn.softmax(scores, axis=-1)
        ctx = jnp.einsum("bkt,bktu->bku", align, memory)
        # shared attention layer over concat(cell_output, context) per k
        k = memory.shape[1]
        out_tiled = jnp.broadcast_to(out[:, None, :],
                                     (out.shape[0], k, out.shape[-1]))
        att_in, w_attn = nn.promote(
            jnp.concatenate([out_tiled, ctx], axis=-1), self.w_attn)
        attention = (att_in @ w_attn).mean(axis=1)     # (bs, units)
        att, w_out = nn.promote(attention, self.w_out)
        return ((c, h), attention, align), att @ w_out


class InductionModel(Model):

    def forward(self, s, batch, include_greedy=True, sampling_prob=None,
                rng=None):
        cfg = self.cfg
        if cfg.attn_type not in ("luong", "luong_monotonic"):
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        bs = batch["s_h"].shape[0]
        k, test_k = cfg.k, cfg.test_k
        units = cfg.num_lstm_cell_units
        demo_len = batch["demo_len"].astype("int32")

        s_h, per = batch["s_h"], batch["per"]
        if cfg.stack_subsequent_state:
            # encode consecutive state PAIRS stacked on the channel axis
            # (`model_induction.py:385-396`). Note: the reference forgets to
            # slice its perception tensor to the shortened time axis, which
            # crashes at graph build; we align per with the first state of
            # each pair.
            s_h = jnp.concatenate([s_h[:, :, :-1], s_h[:, :, 1:]], axis=-1)
            per = per[:, :, :-1]
            demo_len = demo_len - 1

        hist, h, c = induction_demo_encoder(
            s.child("encoder"), cfg, fold_k(s_h), fold_k(per),
            fold_k(demo_len))
        memory = unfold_k(hist, bs, k)          # (bs, k, T, mem_units)
        demo_h = unfold_k(h, bs, k)
        demo_c = unfold_k(c, bs, k)
        h_sum, c_sum = aggregate_baseline(
            s, demo_h, demo_c, cfg.demo_aggregation, units)

        core = _AttnDecoder(s.child("manipulation"), cfg.action_space, units,
                            memory.shape[-1], cfg.attn_type)
        # precompute Luong keys once: one big matmul
        keys = nn.dense(s.child("memory_layer"), memory, units,
                        use_bias=False)
        T = memory.shape[2]
        mask = (jnp.arange(T)[None, None, :]
                < demo_len[:, :, None])          # (bs, k, T)

        # fold test_k into batch: each test demo decodes independently with
        # the same weights (reference reuse=i>0 loop, `:669-709`)
        def rep(x):
            return jnp.repeat(x, test_k, axis=0)

        mem_r, keys_r, mask_r = rep(memory), rep(keys), rep(mask)
        # QUIRK: swapped (c, h) init — c <- h_summary, h <- c_summary
        init_c, init_h = rep(h_sum), rep(c_sum)
        att0 = jnp.zeros((bs * test_k, units))
        # monotonic attention starts with a dirac alignment at position 0
        align0 = jnp.zeros((bs * test_k, k, T)).at[:, :, 0].set(1.0)

        gt = fold_k(batch["test_a_h_tokens"].astype("int32"))  # (bs*tk, T)
        start = jnp.full((bs * test_k, 1), cfg.action_space + 1, gt.dtype)
        gt_in = jnp.concatenate([start, gt[:, :-1]], axis=1)

        def tf_step(carry, ids):
            return core(carry, core.embed(ids), mem_r, keys_r, mask_r)

        carry0 = ((init_c, init_h), att0, align0)
        _, logits = nn.time_major_scan(tf_step, carry0, gt_in)
        out = {"pred_action_logits": unfold_k(logits, bs, test_k)}

        if include_greedy:
            end_token = cfg.action_space - 1
            max_len = gt.shape[1]

            def greedy_step(carry, _):
                inner, prev, finished, length, t = carry
                inner, logits = core(inner, core.embed(prev), mem_r, keys_r,
                                     mask_r)
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                newly = (tok == end_token) & ~finished
                length = jnp.where(newly, t + 1, length)
                finished = finished | newly
                return (inner, tok, finished, length, t + 1), (logits, tok)

            g0 = (carry0,
                  jnp.full((bs * test_k,), cfg.action_space, jnp.int32),
                  jnp.zeros(bs * test_k, bool),
                  jnp.full(bs * test_k, max_len, jnp.int32),
                  jnp.zeros((), jnp.int32))
            final, ys = jax.lax.scan(greedy_step, g0, None, length=max_len)
            g_logits, g_tokens = (jnp.swapaxes(a, 0, 1) for a in ys)
            out.update(
                greedy_action_logits=unfold_k(g_logits, bs, test_k),
                greedy_action_tokens=unfold_k(g_tokens, bs, test_k),
                greedy_action_len=unfold_k(final[3], bs, test_k))
        return out
