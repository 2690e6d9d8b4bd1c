"""Benchmark: Karel full-model training throughput.

Measures BOTH:
  * step-only: the jitted train step on device-resident synthetic batches
    (the compiled-compute ceiling), and
  * end-to-end: the REAL training loop — the device-resident cache +
    chunked train step (train/device_cache.py + make_chunked_train_step),
    i.e. exactly what Trainer runs: batch sampling on device, many steps
    per dispatch, no per-step host work.

Timing method: every measurement runs a chain with a DYNAMIC trip count
(one compile) at two lengths N and 2N and reports

    dt = (t(2N) - t(N)) / N

so the fixed sync + dispatch overhead cancels instead of polluting the
per-step time. The cancelled overhead is recorded (`sync_overhead_ms`).

Also reports the XLA-counted FLOPs per step, achieved FLOP/s and MFU
against the device's published dense bf16 peak (`_PEAK_FLOPS`, keyed by
`device_kind`; an unknown kind reports no MFU, with the reason).

A failed end-to-end or batch-scaling measurement is recorded in the JSON
line and makes the script exit non-zero.

Regime: the reference's Karel training setup (batch 32, k=10 demos, T=20,
8x8x16 grids, 512 LSTM units — reference README.md:100-110, trainer.py
defaults). Baseline: the reference logs `1.896 sec/batch, 16.878
instances/sec` (README.md:96) = 168.78 demos/sec.

Prints exactly one JSON line; `value` is the END-TO-END demos/s/device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from demo2program_tpu.cli._jax_setup import REPO_ROOT, setup  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

BASELINE_DEMOS_PER_SEC = 16.878 * 10  # reference README.md:96, k=10

# published dense bf16 peak FLOP/s per device, keyed by jax device_kind
# (NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, at a 700 W limit)
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}



def peak_flops(kind):
    """(peak FLOP/s, None) for a device kind in the table; (None, reason)
    for any other — an unknown device never gets an assumed peak."""
    if kind in _PEAK_FLOPS:
        return _PEAK_FLOPS[kind], None
    return None, f"no published peak for device_kind {kind!r}"


# chain lengths for the differencing measurement; overridable for CPU smoke
CHAIN_N = int(os.environ.get("D2P_BENCH_CHAIN", 256))
# structural smoke on CPU: shrink the model (the recorded regime is 512)
UNITS = int(os.environ.get("D2P_BENCH_UNITS", 512))
REPS = int(os.environ.get("D2P_BENCH_REPS", 5))


def _find_dataset():
    from demo2program_tpu.data.store import data_file
    cands = [os.environ.get("D2P_BENCH_DATASET")] + [
        os.path.join(REPO_ROOT, "datasets", d)
        for d in ("karel_25k", "karel_10k", "karel_small")]
    for d in filter(None, cands):
        try:
            data_file(d)
            return d
        except FileNotFoundError:
            continue
    return None


def _gen_tiny(path=os.path.join(REPO_ROOT, "datasets", "bench_tiny")):
    if not os.path.exists(os.path.join(path, "data.npz")):
        from demo2program_tpu.data.karel_generator import (
            GeneratorConfig, generate)
        generate(GeneratorConfig(dir_name=path, num_train=192, num_test=32,
                                 num_val=32), progress_every=0)
    return path


def _hard_sync(st):
    # device->host fetch of a scalar reduction of a live param leaf: it
    # cannot arrive before the steps that produced it ran
    import jax.numpy as jnp
    leaf = min(jax.tree_util.tree_leaves(st.params), key=lambda a: a.size)
    return float(jnp.sum(leaf))


def _diff_time(run_fn, n):
    """Median t(n) and t(2n) over REPS -> (per-step dt, sync overhead s).

    run_fn(count) must execute `count` steps ending in a hard sync and
    return wall seconds. The differencing cancels every count-independent
    cost (dispatch, sync fetch)."""
    t_n = sorted(run_fn(n) for _ in range(REPS))[REPS // 2]
    t_2n = sorted(run_fn(2 * n) for _ in range(REPS))[REPS // 2]
    dt = (t_2n - t_n) / n
    if dt <= 0:  # noise inversion: fall back to the longer chain's average
        dt = t_2n / (2 * n)
    overhead = max(t_n - n * dt, 0.0)
    return dt, overhead


def main():
    setup()
    sys.exit(_run())


def _run():
    from demo2program_tpu.models.common import ModelConfig
    from demo2program_tpu.models.full import FullModel
    from demo2program_tpu.parallel import make_mesh, replicated_sharding
    from demo2program_tpu.parallel.mesh import shard_batch
    from demo2program_tpu.train.step import (
        create_train_state, make_optimizer, make_step_fn, make_train_step,
        strip_non_tensor)
    from __graft_entry__ import _random_batch

    cfg = ModelConfig(model="full", batch_size=32, num_lstm_cell_units=UNITS,
                      k=10, test_k=5, max_demo_len=20, max_program_len=45)
    bs = cfg.batch_size
    n_chips = jax.device_count()
    batch = _random_batch(cfg, bs)

    mesh = make_mesh()
    model = FullModel(cfg, train=True)
    tx = make_optimizer(cfg, 1e-3)
    state = create_train_state(model, cfg, tx, jax.random.key(0), batch)
    state = jax.device_put(state, replicated_sharding(mesh))
    sharded = shard_batch(batch, mesh)
    sharded_t = strip_non_tensor(sharded)
    rng = jax.random.key(1)

    # host<->device round-trip probe: recorded so environment drift is
    # visible in the record (it does not bias the timings)
    rtt = []
    for _ in range(10):
        t0 = time.perf_counter()
        np.asarray(jax.device_put(np.zeros(8, np.float32)))
        rtt.append(time.perf_counter() - t0)
    rtt_ms = float(np.median(rtt) * 1e3)

    # speed-of-light anchor: a pure bf16 matmul chain through the SAME
    # timing method; near the peak means the device and the measurement
    # are sound
    import jax.numpy as jnp
    on_accel = jax.default_backend() != "cpu"
    Nm = 4096 if on_accel else 2048
    ma = jax.random.normal(jax.random.key(2), (Nm, Nm), jnp.bfloat16)
    mb = jax.random.normal(jax.random.key(3), (Nm, Nm), jnp.bfloat16)

    @jax.jit
    def _mm_chain(a, b, n):
        def body(i, ab):
            return (jnp.tanh(ab[0] @ ab[1]), ab[1])
        a, b = jax.lax.fori_loop(0, n, body, (a, b))
        return jnp.float32(jnp.sum(a))

    float(_mm_chain(ma, mb, 2))

    def _mm_run(n):
        t0 = time.perf_counter()
        float(_mm_chain(ma, mb, n))
        return time.perf_counter() - t0

    mm_n = max(CHAIN_N // 4, 2)
    mm_dt, _ = _diff_time(_mm_run, mm_n)
    matmul_tflops = 2 * Nm ** 3 / mm_dt / 1e12

    # XLA-counted FLOPs for the compiled step (forward+backward+Adam)
    train_step = make_train_step(model, cfg, tx, "full", donate=False)
    flops_per_step = None
    try:
        lowered = jax.jit(
            lambda s, b, r: train_step(s, b, r)).lower(
                state, sharded_t, rng)
        ca = lowered.compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        if ca and "flops" in ca:
            flops_per_step = float(ca["flops"])
    except Exception:
        pass

    # ---- step-only: dynamic-count fori_loop chain, ONE compile ----
    step_fn = make_step_fn(model, cfg, tx, "full")

    def _make_chain(fn):
        def run(s, b, r, n):
            return jax.lax.fori_loop(
                0, n, lambda i, st: fn(st, b, r)[0], s)
        return jax.jit(run)

    chain = _make_chain(step_fn)
    print("bench: compiling step-only chain...", file=sys.stderr)
    state = chain(state, sharded_t, rng, 2)  # compile (count is dynamic)
    _hard_sync(state)

    def run_steps(count):
        nonlocal state
        t0 = time.perf_counter()
        state = chain(state, sharded_t, rng, count)
        _hard_sync(state)
        return time.perf_counter() - t0

    print("bench: step-only chain compiled; timing...", file=sys.stderr)
    dt_step, step_overhead = _diff_time(run_steps, CHAIN_N)
    print(f"bench: step-only dt={dt_step*1e3:.3f} ms", file=sys.stderr)
    step_demos = bs * cfg.k / dt_step / n_chips

    # bf16 step variant: same f32 params/optimizer, forward/backward cast
    # to bf16 inside the step (train/step.py)
    import dataclasses
    cfg_bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model_bf = FullModel(cfg_bf, train=True)
    chain_bf = _make_chain(make_step_fn(model_bf, cfg_bf, tx, "full"))
    state = chain_bf(state, sharded_t, rng, 2)  # compile
    _hard_sync(state)

    def run_bf(count):
        nonlocal state
        t0 = time.perf_counter()
        state = chain_bf(state, sharded_t, rng, count)
        _hard_sync(state)
        return time.perf_counter() - t0

    dt_bf16, _ = _diff_time(run_bf, CHAIN_N)
    print(f"bench: bf16 dt={dt_bf16*1e3:.3f} ms", file=sys.stderr)
    bf16_demos = bs * cfg.k / dt_bf16 / n_chips

    # ---- batch-scaling point: one extra step-only measurement at a large
    # batch (same k/T/units). At bs=32 the step sits in sequential
    # LSTM-scan steps and small decoder matmuls; a wider batch widens every
    # matmul, so demos/s + MFU here show how far the workload, not the
    # framework, limits utilization.
    bs_big = int(os.environ.get("D2P_BENCH_BIG_BS", 256))
    dt_big = flops_big = None
    big_error = None
    run_big = on_accel or os.environ.get("D2P_BENCH_BIG", "") == "1"
    if run_big:
        try:
            cfg_big = dataclasses.replace(cfg, batch_size=bs_big)
            model_big = FullModel(cfg_big, train=True)
            batch_big = _random_batch(cfg_big, bs_big)
            state_big = create_train_state(
                model_big, cfg_big, tx, jax.random.key(0), batch_big)
            state_big = jax.device_put(state_big,
                                       replicated_sharding(mesh))
            sb = strip_non_tensor(shard_batch(batch_big, mesh))
            try:
                ts_big = make_train_step(model_big, cfg_big, tx, "full",
                                         donate=False)
                ca_big = jax.jit(lambda s, b, r: ts_big(s, b, r)).lower(
                    state_big, sb, rng).compile().cost_analysis()
                if isinstance(ca_big, (list, tuple)):
                    ca_big = ca_big[0]
                if ca_big and "flops" in ca_big:
                    flops_big = float(ca_big["flops"])
            except Exception:
                pass
            chain_big = _make_chain(
                make_step_fn(model_big, cfg_big, tx, "full"))
            print("bench: compiling bs-scaling chain...", file=sys.stderr)
            state_big = chain_big(state_big, sb, rng, 2)
            _hard_sync(state_big)

            def run_big_steps(count):
                nonlocal state_big
                t0 = time.perf_counter()
                state_big = chain_big(state_big, sb, rng, count)
                _hard_sync(state_big)
                return time.perf_counter() - t0

            dt_big, _ = _diff_time(run_big_steps,
                                   max(CHAIN_N * bs // bs_big, 2))
            print(f"bench: bs={bs_big} dt={dt_big*1e3:.3f} ms",
                  file=sys.stderr)
            del state_big, chain_big, sb, batch_big  # free memory for e2e
        except Exception as exc:  # noqa: BLE001
            big_error = f"{type(exc).__name__}: {exc}"

    # ---- end-to-end: the real chunked train loop over a real dataset ----
    # (device cache + on-device batch sampling + scan of steps — the exact
    # code path Trainer runs for Karel)
    e2e_demos = None
    e2e_error = None
    e2e_overhead_ms = None
    ds_dir = _find_dataset() or _gen_tiny()
    try:
        from demo2program_tpu.data import create_default_splits
        from demo2program_tpu.train.device_cache import KarelDeviceCache
        from demo2program_tpu.train.step import make_chunked_train_step
        ds_train, _, _ = create_default_splits(ds_dir, num_k=cfg.k)
        cache = KarelDeviceCache(ds_train, mesh=mesh)
        eb = cache.example_batch(bs)
        e_cfg = ModelConfig(
            model="full", batch_size=bs, num_lstm_cell_units=UNITS,
            k=cfg.k, test_k=5,
            max_demo_len=int(eb["c_a_raw"].shape[2]),
            max_program_len=int(eb["program_tokens"].shape[1]))
        e_model = FullModel(e_cfg, train=True)
        e_state = create_train_state(e_model, e_cfg, tx, jax.random.key(0),
                                     eb)
        e_state = jax.device_put(e_state, replicated_sharding(mesh))
        # Trainer's default log_step — the deployed chunk size (CPU smoke:
        # override it down; a 100-step chunk at 512 units is slow on a CPU)
        CHUNK = int(os.environ.get("D2P_BENCH_CHUNK", 100))
        chunk_fn = make_chunked_train_step(
            e_model, e_cfg, tx, "full", cache.n, bs, CHUNK)
        data_key = jax.random.key(7)
        e_state, _ = chunk_fn(e_state, cache.data, data_key, rng)  # compile
        _hard_sync(e_state)
        print("bench: e2e chunked loop compiled; timing...", file=sys.stderr)

        def run_e2e(count):  # count steps = count/CHUNK sequential chunks
            nonlocal e_state
            t0 = time.perf_counter()
            for _ in range(max(count // CHUNK, 1)):
                e_state, _ = chunk_fn(e_state, cache.data, data_key, rng)
            _hard_sync(e_state)
            return time.perf_counter() - t0

        n_e2e = max((CHAIN_N // CHUNK) * CHUNK, CHUNK)
        dt_e2e, e2e_overhead = _diff_time(run_e2e, n_e2e)
        e2e_overhead_ms = round(e2e_overhead * 1e3, 1)
        e2e_demos = bs * cfg.k / dt_e2e / n_chips
    except Exception as exc:  # noqa: BLE001
        # an e2e failure must not masquerade as an e2e number
        e2e_error = f"{type(exc).__name__}: {exc}"

    kind = jax.devices()[0].device_kind
    peak, mfu_null_reason = peak_flops(kind)
    achieved = flops_per_step / dt_step if flops_per_step else None
    if e2e_demos:
        metric, headline = "train_demos_per_sec_per_chip_e2e", e2e_demos
    else:
        metric, headline = "train_demos_per_sec_per_chip_step_only", step_demos
    out = {
        "metric": metric,
        "value": round(headline, 2),
        "unit": "demos/s",
        "vs_baseline": round(headline / BASELINE_DEMOS_PER_SEC, 2),
        "step_only_demos_per_sec_per_chip": round(step_demos, 2),
        "step_only_bf16_demos_per_sec_per_chip": round(bf16_demos, 2),
        "e2e_error": e2e_error,
        "e2e_dataset": ds_dir,
        "chain_n": CHAIN_N,
        "timing_method": "two-length differencing (overhead cancels)",
        "sync_overhead_ms": round(step_overhead * 1e3, 1),
        "e2e_sync_overhead_ms": e2e_overhead_ms,
        "device_put_rtt_ms": round(rtt_ms, 2),
        "matmul_peak_probe_tflops": round(matmul_tflops, 1),
        "flops_per_step": flops_per_step,
        "achieved_tflops": round(achieved / 1e12, 3) if achieved else None,
        # the bs=256 scaling point: the framework's compute ceiling when
        # the workload's matmuls are wide
        "bs_scaling_batch": bs_big if run_big else None,
        "bs_scaling_ms_per_step": (round(dt_big * 1e3, 3)
                                   if dt_big else None),
        "bs_scaling_demos_per_sec_per_chip": (
            round(bs_big * cfg.k / dt_big / n_chips, 2) if dt_big else None),
        "bs_scaling_flops_per_step": flops_big,
        "bs_scaling_mfu_vs_bf16_peak": (
            round(flops_big / dt_big / peak, 4)
            if dt_big and flops_big and peak else None),
        "bs_scaling_error": big_error,
        "device_kind": kind,
        "device_platform": jax.devices()[0].platform,
        "device_count": n_chips,
        "peak_bf16_flops": peak,
        "mfu_null_reason": mfu_null_reason,
        "mfu_vs_bf16_peak": (round(achieved / peak, 4)
                             if achieved and peak else None),
        "mfu_bf16_step": (round(flops_per_step / dt_bf16 / peak, 4)
                          if flops_per_step and peak else None),
    }
    print(json.dumps(out))
    return 1 if (e2e_error or big_error) else 0


if __name__ == "__main__":
    main()
