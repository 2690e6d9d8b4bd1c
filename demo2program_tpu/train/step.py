"""jit-compiled train / eval steps.

Optimization parity with the reference trainer (`trainer.py:82-109`):
Adam, gradient clipping by global norm 20 (tf.contrib optimize_loss
clip_gradients semantics), optional staircase exponential LR decay
(x0.5 every 10k steps). Scheduled sampling probability decays linearly
1.0 -> 0.1 over scheduled_sampling_decay_steps (`model_full.py:59-67`);
the DECODER samples with probability (1 - sample_prob)
(`model_full.py:418-423`).

The whole step — forward, backward, Adam update — is one jitted program over
the data-sharded batch; XLA inserts the gradient all-reduce across devices.
"""

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from demo2program_tpu.models import objective
from demo2program_tpu.ops.reconstruct import expand_batch

NON_TENSOR_KEYS = ("id",)


def strip_non_tensor(batch):
    """Drop host-only entries (the string id column) before entering jit."""
    return {k: v for k, v in batch.items() if k not in NON_TENSOR_KEYS}


class TrainState(NamedTuple):
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **changes):
        return self._replace(**changes)


def make_optimizer(cfg, learning_rate, lr_weight_decay=False):
    if lr_weight_decay:
        schedule = optax.exponential_decay(
            init_value=learning_rate, transition_steps=10000,
            decay_rate=0.5, staircase=True)
    else:
        schedule = learning_rate
    return optax.chain(
        optax.clip_by_global_norm(20.0),
        optax.adam(schedule),
    )


def create_train_state(model, cfg, tx, rng, example_batch):
    example_batch = expand_batch(strip_non_tensor(example_batch), cfg)
    variables = model.init(rng, example_batch, include_greedy=False)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
    )


def _cast_floats(tree, dtype):
    """Cast float32 leaves to `dtype` (mixed-precision compute: params and
    activations run in bf16 while the stored params, optimizer state and
    loss stay float32)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a, tree)


def _sampling_prob(cfg, step):
    """1 - polynomial_decay(1.0 -> 0.1) of the teacher-forcing prob."""
    frac = jnp.minimum(
        step.astype(jnp.float32) / cfg.scheduled_sampling_decay_steps, 1.0)
    sample_prob = 1.0 + (0.1 - 1.0) * frac
    return 1.0 - sample_prob


def make_step_fn(model, cfg, tx, model_name):
    """Pure (state, batch, rng) -> (state, report) step body — the single
    source of truth for the update rule. `make_train_step` jits it for the
    streaming per-step path; `make_chunked_train_step` scans it for the
    device-cache path (many steps per dispatch)."""
    use_ss = cfg.scheduled_sampling
    bf16 = getattr(cfg, "compute_dtype", "float32") == "bfloat16"

    def _train_step(state, batch, rng):
        # compact-wire batches are expanded here, inside jit, so the one-hot
        # / state-replay rebuild fuses into the step (ops/reconstruct.py)
        batch = expand_batch(batch, cfg)
        sp = _sampling_prob(cfg, state.step) if use_ss else None

        def loss_fn(params):
            kwargs = dict(include_greedy=False)
            if use_ss:
                kwargs.update(sampling_prob=sp, rng=rng)
            p, bstats, b = params, state.batch_stats, batch
            if bf16:
                # forward/backward in bf16 (params cast inside autodiff so
                # grads come back float32); loss + BN running stats stay f32
                p = _cast_floats(p, jnp.bfloat16)
                bstats = _cast_floats(bstats, jnp.bfloat16)
                b = _cast_floats(b, jnp.bfloat16)
            out, updates = model.apply(
                {"params": p, "batch_stats": bstats},
                b, mutable=["batch_stats"], **kwargs)
            if bf16:
                out = _cast_floats(out, jnp.float32)
                updates = jax.tree_util.tree_map(
                    lambda a: (a.astype(jnp.float32)
                               if a.dtype == jnp.bfloat16 else a), updates)
            loss, report = objective.compute_loss(cfg, out, batch,
                                                  model_name)
            return loss, (report, updates)

        (loss, (report, updates)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        upd, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, upd)
        new_state = state.replace(
            step=state.step + 1,
            params=new_params,
            batch_stats=updates["batch_stats"],
            opt_state=new_opt)
        report["grad_norm"] = optax.global_norm(grads)
        return new_state, report

    return _train_step


def make_train_step(model, cfg, tx, model_name, donate=True):
    _train_step = jax.jit(
        make_step_fn(model, cfg, tx, model_name),
        donate_argnums=(0,) if donate else ())

    def train_step(state, batch, rng):
        return _train_step(state, strip_non_tensor(batch), rng)

    return train_step


def make_chunked_train_step(model, cfg, tx, model_name, n_items, batch_size,
                            chunk, sharding=None):
    """`chunk` train steps in ONE jitted dispatch over a device-resident
    split.

    The streaming path pays a host->device transfer every step; with the
    whole train split in device memory (train/device_cache.py) the loop needs
    NO per-step host work at all. Batch selection moves on device and is a
    PURE FUNCTION of
    (data_key, step): epoch e uses jax.random.permutation(fold_in(data_key,
    e)) and step s takes rows [s_in_e*bs, (s_in_e+1)*bs) of it — the same
    epoch-shuffled-without-replacement semantics as BatchPipeline, and a
    killed-and-resumed run replays the identical batch sequence by
    construction (exact resume; the reference's Supervisor restart revisits
    early batches instead).

    Returns jitted (state, data, data_key, base_key) -> (state, reports)
    where reports is the per-step report dict stacked over the chunk and
    per-step model rng is fold_in(base_key, step).
    """
    step_fn = make_step_fn(model, cfg, tx, model_name)
    steps_per_epoch = n_items // batch_size
    if steps_per_epoch < 1:
        raise ValueError(
            f"batch_size {batch_size} exceeds split size {n_items}")

    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunked(state, data, data_key, base_key):
        def body(carry, _):
            state = carry
            step = state.step
            epoch = step // steps_per_epoch
            s_in_e = step % steps_per_epoch
            perm = jax.random.permutation(
                jax.random.fold_in(data_key, epoch), n_items)
            idx = jax.lax.dynamic_slice(perm, (s_in_e * batch_size,),
                                        (batch_size,))
            batch = jax.tree_util.tree_map(
                lambda a: jnp.take(a, idx, axis=0), data)
            if sharding is not None:
                batch = jax.lax.with_sharding_constraint(
                    batch,
                    jax.tree_util.tree_map(lambda _: sharding, batch))
            new_state, report = step_fn(state, batch,
                                        jax.random.fold_in(base_key, step))
            return new_state, report

        state, reports = jax.lax.scan(body, state, xs=None, length=chunk)
        return state, reports

    return chunked


def make_eval_step(eval_model, cfg, model_name, decode_mode="greedy",
                   decode_seed=123):
    """Eval forward: loss/acc reports + program tensors for host/VM scoring.
    Uses running batch-norm statistics (train=False model). decode_mode
    selects greedy / syntax_greedy / syntax_sample program unrolling."""
    kwargs = {}
    if decode_mode != "greedy":
        kwargs["decode_mode"] = decode_mode
        if decode_mode == "syntax_sample":
            kwargs["rng"] = jax.random.key(decode_seed)

    bf16 = getattr(cfg, "compute_dtype", "float32") == "bfloat16"

    @jax.jit
    def _eval_step(state, batch):
        batch = expand_batch(batch, cfg)
        p, bstats, b = state.params, state.batch_stats, batch
        if bf16:
            p = _cast_floats(p, jnp.bfloat16)
            bstats = _cast_floats(bstats, jnp.bfloat16)
            b = _cast_floats(b, jnp.bfloat16)
        out = eval_model.apply(
            {"params": p, "batch_stats": bstats},
            b, include_greedy=True, **kwargs)
        if bf16:
            out = _cast_floats(out, jnp.float32)
        _, report = objective.compute_loss(cfg, out, batch, model_name)
        report.update(objective.greedy_action_report(cfg, out, batch,
                                                     model_name))
        evals = objective.program_eval_tensors(cfg, out, batch)
        return report, evals

    def eval_step(state, batch):
        return _eval_step(state, strip_non_tensor(batch))

    return eval_step
