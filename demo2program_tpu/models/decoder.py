"""Sequence decoders (program / action / perception heads).

Architecture parity: `models/model_full.py:406-599` — a single-layer LSTM
whose initial state is the demo summary (c, h), a learned token embedding,
and a bias-free output projection, with three unroll modes (teacher forcing,
scheduled sampling, greedy) sharing weights.

Quirks replicated deliberately:
  * the embedding table has token_dim+1 rows; teacher forcing prepends a
    start token with id token_dim+1, which is OUT OF RANGE and on the
    reference's GPU silently embeds to ZEROS (`model_full.py:288-291,
    447-450`). We embed via one_hot(num_classes=token_dim+1) @ table, which
    reproduces the zero embedding exactly. Greedy decoding uses the in-range
    id token_dim (the real last row) as its start token
    (`model_full.py:426-427`).
  * greedy end tokens: 'm)' for programs, token_dim-1 (<e>) for actions
    (`model_full.py:429-432`).
  * predicted length = first-end-token position + 1, or max_len if the end
    token is never emitted (dynamic_decode's final_sequence_lengths).
  * the perception head is ALWAYS teacher-forced — even on the "greedy"
    path (`model_full.py:409`) — and feeds the current target vector as
    input without a one-step shift (`model_full.py:447-456` skips the
    <s>-prepend for sequence_type 'per').
  * scheduled sampling follows ScheduledEmbeddingTrainingHelper: per element
    and step, with probability sampling_prob a token is drawn from the
    step's softmax and its embedding replaces the next ground-truth input
    (`model_full.py:414-423`; the trainer decays sample_prob 1.0 -> 0.1,
    sampling_prob = 1 - sample_prob).

Known deviation (documented): the reference zero-pads greedy logits past the
batch-global stop step (dynamic_decode early exit); we compute logits for all
max_len steps. Predicted tokens/lengths — everything that feeds accuracy,
syntax and execution metrics — are unaffected.

Shape notes: teacher forcing embeds all steps as one (bs*L, V+1)@(V+1, E)
matmul and projects all hidden states as one (bs*L, H)@(H, V) matmul; only
the recurrence itself is a scan.
"""


import jax
import jax.numpy as jnp

from demo2program_tpu.models import nn


def _stack_time(ys):
    """lax.scan stacks outputs on axis 0; decoders report (bs, L, ...)."""
    return jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), ys)


class TokenDecoder:
    """LSTM token decoder with shared-weight unroll modes. Parameters live
    under `<scope>/core/`: `embedding` (token_dim+1 rows), the LSTM `cell`
    and the bias-free `output_projection`."""

    def __init__(self, s, token_dim, units, end_token):
        core = s.child("core")
        self.token_dim = token_dim
        self.end_token = end_token
        self.table = nn.embedding(core, token_dim + 1, units)
        self.cell = nn.lstm_params(core.child("cell"), units, units)
        self.w_out = core.child("output_projection").param(
            "kernel", nn.lecun_normal, (units, token_dim))

    def embed(self, ids):
        # one_hot of id == token_dim+1 (out of range) -> zero vector
        return nn.embed(self.table, ids)

    def project(self, x):
        x, w = nn.promote(x, self.w_out)
        return x @ w

    def step(self, state, prev_tok, inp=None):
        """One full decode step. `inp` = (gt_x, use_prev) selects between
        the previous token's embedding and a ground-truth input."""
        x = self.embed(prev_tok)
        if inp is not None:
            gt_x, use_prev = inp
            x = jnp.where(use_prev[:, None], x, gt_x)
        state, out = nn.lstm_step(self.cell, state, x)
        return state, self.project(out)

    def _shift_gt(self, gt_tokens):
        start = jnp.full((gt_tokens.shape[0], 1), self.token_dim + 1,
                         dtype=gt_tokens.dtype)
        return jnp.concatenate([start, gt_tokens[:, :-1]], axis=1)

    def teacher_forced(self, init_c, init_h, gt_tokens):
        """gt_tokens (bs, L) -> logits (bs, L, token_dim)."""
        inputs = self.embed(self._shift_gt(gt_tokens))
        _, outs = nn.time_major_scan(
            lambda carry, x: nn.lstm_step(self.cell, carry, x),
            (init_c, init_h), inputs)
        return self.project(outs)

    def greedy(self, init_c, init_h, max_len):
        """-> (logits (bs, L, V), tokens (bs, L), lengths (bs,)).

        Past a sequence's end token the unroll keeps feeding its argmax, as
        the reference's greedy helper does (so the logits there are the
        reference's), but the emitted token is the end token again, as in a
        finished beam."""
        bs = init_c.shape[0]
        end_token = self.end_token

        def step(carry, _):
            state, prev, finished, length, t = carry
            state, logits = self.step(state, prev)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out = jnp.where(finished, end_token, tok)
            newly = (tok == end_token) & ~finished
            length = jnp.where(newly, t + 1, length)
            finished = finished | newly
            return (state, tok, finished, length, t + 1), (logits, out)

        carry0 = ((init_c, init_h),
                  jnp.full((bs,), self.token_dim, jnp.int32),
                  jnp.zeros(bs, bool),
                  jnp.full(bs, max_len, jnp.int32),
                  jnp.zeros((), jnp.int32))
        final, ys = jax.lax.scan(step, carry0, None, length=max_len)
        logits, tokens = _stack_time(ys)
        return logits, tokens, final[3]

    def beam(self, init_c, init_h, max_len, beam_width=5):
        """On-device beam-search decode -> (tokens (bs, L), lengths (bs,))
        of the best beam, plus all beams' (tokens, lengths, scores).

        The reference has no beam decoder (greedy only); this covers the
        beam-decode capability listed in BASELINE.json's config matrix.
        Finished beams are frozen: they may only re-emit the end token at
        zero added log-probability. Scores are raw log-prob sums (no length
        normalization), so greedy == beam_width=1.
        """
        bs = init_c.shape[0]
        K = beam_width
        V = self.token_dim
        end_token = self.end_token
        NEG = -1e9

        def rep(x):  # (bs, H) -> (bs*K, H)
            return jnp.repeat(x, K, axis=0)

        def step(carry, _):
            (c, h), prev, scores, finished, length, t = carry
            # one decode step for all beams (folded into batch)
            (c, h), logits = self.step((c, h), prev.reshape(bs * K))
            logp = jax.nn.log_softmax(logits.reshape(bs, K, V), axis=-1)
            # finished beams: only end_token, at no cost
            end_only = jnp.full((V,), NEG).at[end_token].set(0.0)
            logp = jnp.where(finished[:, :, None], end_only[None, None, :],
                             logp)
            total = scores[:, :, None] + logp          # (bs, K, V)
            flat = total.reshape(bs, K * V)
            top_scores, top_idx = jax.lax.top_k(flat, K)
            parent = top_idx // V                      # (bs, K)
            tok = (top_idx % V).astype(jnp.int32)

            # gather parent beam states
            gather = jnp.arange(bs)[:, None] * K + parent
            c = c.reshape(bs * K, -1)[gather.reshape(-1)]
            h = h.reshape(bs * K, -1)[gather.reshape(-1)]
            finished = jnp.take_along_axis(finished, parent, axis=1)
            length = jnp.take_along_axis(length, parent, axis=1)
            newly = (tok == end_token) & ~finished
            length = jnp.where(newly, t + 1, length)
            finished = finished | newly
            return ((c, h), tok, top_scores, finished, length, t + 1), \
                (tok, parent)

        # beam 0 starts live; the rest start at -inf so step 1 fans out
        scores0 = jnp.full((bs, K), NEG).at[:, 0].set(0.0)
        carry0 = ((rep(init_c), rep(init_h)),
                  jnp.full((bs, K), self.token_dim, jnp.int32),
                  scores0,
                  jnp.zeros((bs, K), bool),
                  jnp.full((bs, K), max_len, jnp.int32),
                  jnp.zeros((), jnp.int32))
        final, (toks, parents) = jax.lax.scan(step, carry0, None,
                                              length=max_len)
        _, _, scores, _, lengths, _ = final

        # backtrack the surviving beams through the parent pointers
        def backtrack(carry, step_data):
            beam_idx = carry
            tok_t, parent_t = step_data
            tok = jnp.take_along_axis(tok_t, beam_idx, axis=1)
            beam_idx = jnp.take_along_axis(parent_t, beam_idx, axis=1)
            return beam_idx, tok

        init_idx = jnp.tile(jnp.arange(K)[None, :], (bs, 1))
        _, rev_tokens = jax.lax.scan(backtrack, init_idx,
                                     (toks[::-1], parents[::-1]))
        all_tokens = jnp.moveaxis(rev_tokens[::-1], 0, 2)  # (bs, K, L)

        best = jnp.argmax(scores, axis=1)
        best_tokens = jnp.take_along_axis(
            all_tokens, best[:, None, None], axis=1)[:, 0]
        best_len = jnp.take_along_axis(lengths, best[:, None], axis=1)[:, 0]
        return (best_tokens, best_len,
                {"tokens": all_tokens, "lengths": lengths,
                 "scores": scores})

    def greedy_constrained(self, init_c, init_h, max_len, syntax,
                           sample_rng=None):
        """Syntax-constrained decoding with the pushdown tables from
        dsl/karel_syntax.py running entirely on-device — the replacement for
        the reference's per-step tf.py_func mask server
        (`models/seq2seq_helper.py:228-277`).

        With sample_rng=None this is syntax_greedy (masked argmax); with an
        rng it is syntax_sample (masked softmax sampling). Reference quirks
        kept: once finished, only the end token remains legal; if every
        candidate is masked out (budget impossibility), token 0 is emitted
        (the reference argmaxes an all-zero masked distribution).
        """
        from demo2program_tpu.dsl.karel_syntax import (
            POP, STACK_DEPTH, SYMBOL_MIN, initial_stack)

        bs = init_c.shape[0]
        end_token = self.end_token
        V = self.token_dim
        init = initial_stack()
        stack0 = jnp.zeros((bs, STACK_DEPTH), jnp.int32)
        stack0 = stack0.at[:, :len(init)].set(
            jnp.asarray(init, jnp.int32)[None, :])
        sp0 = jnp.full((bs,), len(init), jnp.int32)
        msum0 = jnp.full((bs,), int(sum(SYMBOL_MIN[s] for s in init)),
                         jnp.int32)
        bidx = jnp.arange(bs)
        step_rngs = (jax.random.split(sample_rng, max_len)
                     if sample_rng is not None else None)

        def step(carry, rng_t):
            state, prev, finished, length, t, stack, sp, msum = carry
            state, logits = self.step(state, prev)

            top = stack[bidx, jnp.clip(sp - 1, 0, STACK_DEPTH - 1)]
            empty = sp <= 0
            legal = syntax["legal"][top]                      # (bs, V)
            budget_ok = (t + 1 + msum[:, None]
                         + syntax["delta"][top]) <= max_len
            mask = legal & budget_ok & ~empty[:, None]
            # finished elements: only the end token (seq2seq_helper.py:248)
            end_only = jax.nn.one_hot(
                jnp.full((bs,), end_token), V, dtype=bool)
            mask = jnp.where(finished[:, None], end_only, mask)

            masked = jnp.where(mask, logits, -1e9)
            if rng_t is None:
                tok = jnp.argmax(masked, axis=-1).astype(jnp.int32)
            else:
                tok = jax.random.categorical(rng_t, masked).astype(jnp.int32)
            # all-masked fallback -> token 0, the reference's zero-argmax
            tok = jnp.where(mask.any(axis=-1), tok, 0)

            # stack transition (no-op when the consumed token is illegal)
            do = legal[bidx, tok] & ~empty & ~finished
            repl = syntax["repl"][top, tok]
            plen = syntax["push_len"][top, tok]
            msum = msum + jnp.where(do, syntax["delta"][top, tok], 0)
            # replace or pop the top
            top_pos = jnp.clip(sp - 1, 0, STACK_DEPTH - 1)
            stack = stack.at[bidx, top_pos].set(
                jnp.where(do & (repl != POP), repl, stack[bidx, top_pos]))
            base = jnp.where(repl == POP, sp - 1, sp)
            for j in range(syntax["push_seq"].shape[-1]):
                pos = jnp.clip(base + j, 0, STACK_DEPTH - 1)
                val = syntax["push_seq"][top, tok, j]
                write = do & (j < plen)
                stack = stack.at[bidx, pos].set(
                    jnp.where(write, val, stack[bidx, pos]))
            sp = jnp.where(do, base + plen, sp)

            newly = (tok == end_token) & ~finished
            length = jnp.where(newly, t + 1, length)
            finished = finished | newly
            return (state, tok, finished, length, t + 1, stack, sp, msum), \
                (logits, tok)

        carry0 = ((init_c, init_h),
                  jnp.full((bs,), self.token_dim, jnp.int32),
                  jnp.zeros(bs, bool),
                  jnp.full(bs, max_len, jnp.int32),
                  jnp.zeros((), jnp.int32),
                  stack0, sp0, msum0)
        final, ys = jax.lax.scan(step, carry0, step_rngs, length=max_len)
        logits, tokens = _stack_time(ys)
        return logits, tokens, final[3]

    def scheduled(self, init_c, init_h, gt_tokens, sampling_prob, rng,
                  return_sampled=False):
        """Scheduled-sampling unroll -> logits (bs, L, token_dim).

        With return_sampled=True also returns the per-step SAMPLED token ids
        — the reference's helper emits these as sample_id and they (not the
        logit argmax) feed the train-time metrics
        (`model_synthesis.py:441-447`)."""
        bs, L = gt_tokens.shape
        gt_in = self.embed(self._shift_gt(gt_tokens))  # (bs, L, E)
        step_rngs = jax.random.split(rng, 2 * L).reshape(L, 2)

        def step(carry, xs):
            gt_x, rngs = xs
            state, prev_tok, use_prev = carry
            state, logits = self.step(state, prev_tok, (gt_x, use_prev))
            sampled = jax.random.categorical(
                rngs[0], logits).astype(jnp.int32)
            do_sample = jax.random.bernoulli(rngs[1], sampling_prob, (bs,))
            return (state, sampled, do_sample), (logits, sampled)

        carry0 = ((init_c, init_h),
                  jnp.zeros(bs, jnp.int32), jnp.zeros(bs, bool))
        _, ys = jax.lax.scan(step, carry0,
                             (jnp.swapaxes(gt_in, 0, 1), step_rngs))
        logits, sampled = _stack_time(ys)
        if return_sampled:
            return logits, sampled
        return logits


def vector_decoder(s, init_c, init_h, gt_vectors, out_dim, units):
    """Perception-vector decoder head (`model_full.py:564-599`): inputs are
    the (unshifted) target vectors through an FC+BN embedding
    (`Per_Encoder`, `model_full.py:308-316`); always teacher-forced.
    gt_vectors: (bs, T, out_dim), shipped as uint8."""
    x = nn.fc_bn(s.child("per_embed"), gt_vectors.astype(jnp.float32), units,
                 activation="none")
    cell = nn.lstm_params(s.child("OptimizedLSTMCell_0"), units, units)
    _, outs = nn.time_major_scan(
        lambda carry, xt: nn.lstm_step(cell, carry, xt), (init_c, init_h), x)
    return nn.dense(s.child("output_projection"), outs, out_dim,
                    use_bias=False)
