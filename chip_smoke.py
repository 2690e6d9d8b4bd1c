"""End-to-end smoke test of the Karel full model on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four_cards  # data-parallel check on four cards

Phases (each prints one line; any failure exits non-zero):
  1. environment: the card (nvidia-smi), JAX, devices, and the package
     census; the main path's own packages must import.
  2. generator_cli: a small Karel dataset (native engine).
  3. trainer_cli: the full model at reference width (512 units, bs 32,
     k 10, 8x8x16 grids) for 30 steps on the chunked device-cache loop,
     ending in a checkpoint.
  4. numerics: one train step from the same params and batch on the GPU and
     on the CPU backend, under "highest" matmul precision.
  5. evaler_cli --pred_program from that checkpoint; the evaler's per-demo
     execution verdicts on its greedy programs, and its scorer's on the
     ground-truth and perturbed programs, must equal the host
     interpreter's.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It is printed only when every phase passed on a GPU.
"""

import argparse
import importlib
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))
WORK = osp.join(ROOT, "datasets", "chip_smoke")
UNITS, BS, K = 512, 32, 10
TRAIN_STEPS, LOG_STEP = 30, 10
# loss and global grad norm, GPU vs CPU, both at "highest" precision: f32
# sums over the same values in another order (cuBLAS/cuDNN vs Eigen tiling),
# which moves the last few bits of each partial sum — far below 1e-4 for a
# single step
NUMERICS_RTOL = 1e-4
# 1 vs 4 data-parallel cards, same global batch: the gradient all-reduce and
# the batch-norm statistics sum per-card partials, so the order differs; the
# difference then compounds through Adam over the steps compared
FOUR_CARD_RTOL = 1e-4
FOUR_CARD_STEPS = 5
# packages that the main path may not need; reported, never imported by it
NOT_ON_MAIN_PATH = ("flax", "orbax.checkpoint", "h5py")


def phase(name, msg):
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def census():
    """Version (or "present", or None) of each package the system has used;
    the optional ones are looked up without importing them."""
    from importlib import metadata, util

    out = {}
    for mod in ("jax", "numpy", "optax"):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod] = None
    dists = {"flax": ["flax"], "orbax.checkpoint": ["orbax-checkpoint"],
             "h5py": ["h5py"],
             "cv2": ["opencv-python", "opencv-python-headless",
                     "opencv-contrib-python"]}
    for mod, names in dists.items():
        try:
            found = util.find_spec(mod) is not None
        except ImportError:
            found = False
        out[mod] = None
        for name in names if found else ():
            try:
                out[mod] = metadata.version(name)
                break
            except metadata.PackageNotFoundError:
                out[mod] = "present"
    return out


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def require_gpu(jax):
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"JAX selected the {jax.default_backend()!r} backend; this "
            "smoke test runs only on an NVIDIA GPU")


def phase_environment(jax, n_cards):
    require_gpu(jax)
    pkgs = census()
    missing = [m for m in ("jax", "numpy", "optax") if pkgs[m] is None]
    if missing:
        raise RuntimeError(f"main-path packages missing: {missing}")
    if jax.device_count() < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, {jax.device_count()} "
                           "visible")
    print(card_line(), flush=True)
    phase("environment", f"jax {jax.__version__}, devices "
          f"{[d.device_kind for d in jax.devices()]}, census {pkgs}")


def make_dataset(path, num_train, num_test=64, num_val=32):
    from demo2program_tpu.cli import generator_cli
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.time()
    generator_cli.main([
        "--dir_name", path, "--num_train", str(num_train),
        "--num_test", str(num_test), "--num_val", str(num_val),
        "--backend", "native", "--seed", "123"])
    return time.time() - t0


def read_metrics(train_dir):
    with open(osp.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(ds_dir, train_dir):
    import numpy as np

    from demo2program_tpu.cli import trainer_cli
    from demo2program_tpu.train import checkpoint

    shutil.rmtree(train_dir, ignore_errors=True)
    t0 = time.time()
    trainer_cli.main([
        "--model", "full", "--dataset_type", "karel",
        "--dataset_path", ds_dir, "--train_dir", train_dir,
        "--num_k", str(K), "--batch_size", str(BS),
        "--num_lstm_cell_units", str(UNITS),
        "--max_steps", str(TRAIN_STEPS), "--log_step", str(LOG_STEP),
        "--test_sample_step", str(TRAIN_STEPS),
        "--ckpt_save_step", str(TRAIN_STEPS)])
    wall = time.time() - t0
    rows = [r for r in read_metrics(train_dir) if r["split"] == "train"]
    losses = np.array([r["loss"] for r in rows])
    if len(rows) != TRAIN_STEPS // LOG_STEP or not np.isfinite(losses).all():
        raise RuntimeError(f"bad train metrics: {rows}")
    # a record's time is when the host fetched that chunk's report; the
    # fetch is queued behind the next chunk, so the first two records
    # bracket one whole chunk of LOG_STEP steps
    steady_ms = (rows[1]["time"] - rows[0]["time"]) / LOG_STEP * 1e3
    steps = checkpoint.all_steps(osp.join(train_dir, "ckpt"))
    if steps != [TRAIN_STEPS]:
        raise RuntimeError(f"expected one checkpoint at {TRAIN_STEPS}, "
                           f"found {steps}")
    other_s = wall - TRAIN_STEPS * steady_ms / 1e3
    phase("train", f"losses {losses.round(4).tolist()}, steady "
          f"{steady_ms:.2f} ms/step, wall {wall:.1f} s of which {other_s:.1f}"
          f" s outside steady steps (compiles, eval sample, checkpoint; "
          f"info only), ckpt/{steps[0]}")
    return osp.join(train_dir, "ckpt", str(steps[0]), "default")


def train_step_on(device, cfg, state, batch, precision):
    """One full-model train step on `device` -> (loss, grad_norm)."""
    import jax

    from demo2program_tpu.models.full import FullModel
    from demo2program_tpu.train.step import make_optimizer, make_train_step

    tx = make_optimizer(cfg, 1e-3)
    step = make_train_step(FullModel(cfg, train=True), cfg, tx, "full",
                           donate=False)
    with jax.default_matmul_precision(precision):
        _, report = step(jax.device_put(state, device),
                         jax.device_put(batch, device), jax.random.key(1))
    return float(report["loss"]), float(report["grad_norm"])


def compare_train_step(gpu, cfg, batch):
    """Loss and global grad norm of one step on `gpu` at "highest" and at
    the default precision vs the CPU backend at "highest". Returns
    {precision: (rel_loss, rel_grad_norm)} and the CPU reference."""
    import jax

    from demo2program_tpu.models.full import FullModel
    from demo2program_tpu.train.step import (
        create_train_state, make_optimizer)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        state = create_train_state(
            FullModel(cfg, train=True), cfg, make_optimizer(cfg, 1e-3),
            jax.random.key(0), batch)
    ref = train_step_on(cpu, cfg, state, batch, "highest")
    out = {}
    for precision in ("highest", "default"):
        got = train_step_on(gpu, cfg, state, batch, precision)
        out[precision] = tuple(abs(g - r) / abs(r) for g, r in zip(got, ref))
    return out, ref


def phase_numerics(jax, ds_dir):
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import config_from_dataset
    import types

    ds_train, _, _ = create_default_splits(ds_dir, num_k=K)
    args = types.SimpleNamespace(
        model="full", dataset_type="karel", batch_size=BS,
        num_lstm_cell_units=UNITS, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=20000)
    cfg = config_from_dataset(args, ds_train)
    batch = ds_train.get_batch_compact(ds_train.ids[:BS])
    del batch["id"]
    rel, ref = compare_train_step(jax.devices()[0], cfg, batch)
    hi_loss, hi_gn = rel["highest"]
    if not (hi_loss <= NUMERICS_RTOL and hi_gn <= NUMERICS_RTOL):
        raise RuntimeError(f"GPU vs CPU at highest precision: rel diff "
                           f"loss {hi_loss:.2e}, grad norm {hi_gn:.2e} > "
                           f"{NUMERICS_RTOL}")
    df_loss, df_gn = rel["default"]
    phase("numerics", f"cpu loss {ref[0]:.6f} grad_norm {ref[1]:.6f}; "
          f"gpu rel diff at highest: loss {hi_loss:.2e}, grad_norm "
          f"{hi_gn:.2e} (tol {NUMERICS_RTOL}); at default (the trainer's "
          f"precision, TF32 on the GPU): loss {df_loss:.2e}, grad_norm "
          f"{df_gn:.2e}")


def host_verdicts(cfg, store, ids, programs):
    """(n, k) bool: does `programs[i]` reproduce seen demo j of item
    `ids[i]` in the host interpreter (dsl/karel_interp.py)? It must parse,
    run without error and give the demo's whole state sequence."""
    import numpy as np

    from demo2program_tpu.dsl import karel_interp, karel_parser
    from demo2program_tpu.envs import KarelWorld

    out = np.zeros((len(ids), cfg.k), bool)
    for i, (id_, prog) in enumerate(zip(ids, programs)):
        ast, parsed = karel_parser.parse(prog)
        if not parsed:
            continue
        demos, lens = store[id_]["s_h"][()], store[id_]["s_h_len"][()]
        for j in range(cfg.k):
            world = KarelWorld(demos[j, 0].copy(),
                               make_error=cfg.env_type != "no_error")
            _, success = karel_interp.execute(ast, world)
            L = lens[j]
            out[i, j] = success and len(world.s_h) == L and all(
                (np.asarray(a) == b).all()
                for a, b in zip(world.s_h, demos[j, :L]))
    return out


def scorer_verdicts(cfg, dataset, ids, programs):
    """(n, k) bool: the evaler's scorer (eval/scorer.py, the device VM) on
    `programs[i]` against the seen demos of item `ids[i]`, with no
    exact-token shortcut."""
    import numpy as np

    from demo2program_tpu.dsl.karel_vocab import KarelVocab
    from demo2program_tpu.eval.scorer import KarelScorer

    vocab = KarelVocab()
    n = len(ids)
    tokens = np.zeros((n, cfg.max_program_len), np.int32)
    lens = np.zeros(n, np.int32)
    for i, prog in enumerate(programs):
        seq = vocab.str2intseq(prog)
        tokens[i, :len(seq)] = seq
        lens[i] = len(seq)
    _, verdicts = KarelScorer(cfg, vocab).execution_compact(
        tokens, lens, np.zeros(n, np.float32),
        dataset.get_batch_compact(ids))
    return verdicts


def perturbed(program, rng):
    """The program with one action token swapped for another action."""
    actions = ["move", "turnLeft", "turnRight", "pickMarker", "putMarker"]
    toks = program.split()
    where = [i for i, t in enumerate(toks) if t in actions]
    if where:
        i = where[rng.randint(len(where))]
        toks[i] = actions[(actions.index(toks[i]) + 1
                           + rng.randint(len(actions) - 1)) % len(actions)]
    return " ".join(toks)


def phase_eval(ds_dir, ckpt, out_dir):
    import numpy as np

    from demo2program_tpu.cli import evaler_cli
    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.data.store import data_file, open_store
    from demo2program_tpu.dsl.karel_vocab import KarelVocab
    from demo2program_tpu.train.trainer import config_from_dataset
    import types

    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    evaler_cli.main([
        "--model", "full", "--dataset_type", "karel",
        "--dataset_path", ds_dir, "--checkpoint", ckpt,
        "--num_k", str(K), "--batch_size", str(BS),
        "--num_lstm_cell_units", str(UNITS), "--pred_program",
        "--output_dir", out_dir, "--quiet"])
    wall = time.time() - t0
    name = osp.basename(osp.dirname(ckpt))
    _, ds_test, _ = create_default_splits(ds_dir, num_k=K)
    args = types.SimpleNamespace(
        model="full", dataset_type="karel", batch_size=BS,
        num_lstm_cell_units=UNITS, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=20000)
    cfg = config_from_dataset(args, ds_test)
    vocab = KarelVocab()
    with open_store(osp.join(out_dir, f"out_{name}_test.npz")) as preds, \
            open_store(data_file(ds_dir)) as store:
        ids = preds.keys()
        greedy = [str(preds[i]["greedy_prediction"][()]) for i in ids]
        evaler_says = np.stack([
            np.asarray(preds[i]["greedy_is_correct_execution"], bool)
            for i in ids])
        gt = [vocab.intseq2str(store[i]["program"][()]) for i in ids]
        # the evaler's own verdicts on its greedy programs; a token-exact
        # match with the ground truth is correct by definition there
        exact = np.array([g == t for g, t in zip(greedy, gt)])
        greedy_host = host_verdicts(cfg, store, ids, greedy) | exact[:, None]
        # the scorer on programs that do and do not reproduce their demos
        rng = np.random.RandomState(0)
        wrong = [perturbed(p, rng) for p in gt]
        checks = [("greedy", evaler_says, greedy_host)] + [
            (what, scorer_verdicts(cfg, ds_test, ids, progs),
             host_verdicts(cfg, store, ids, progs))
            for what, progs in (("ground truth", gt), ("perturbed", wrong))]
    for what, dev, host in checks:
        if dev.shape != host.shape:
            raise RuntimeError(f"{what} programs: verdicts {dev.shape} from "
                               f"the scorer, {host.shape} from the host")
        if (dev != host).any():
            raise RuntimeError(
                f"{what} programs: scorer and host interpreter differ at "
                f"(item, demo) {np.argwhere(dev != host)[:3].tolist()}")
    if not checks[1][2].all():
        raise RuntimeError("ground-truth programs do not reproduce all of "
                           "their demos in the host interpreter")
    counts = ", ".join(f"{what} {int(host.sum())}/{host.size}"
                       for what, _, host in checks)
    phase("eval", f"evaler_cli {wall:.1f} s over {len(ids)} test items; "
          f"scorer == host interpreter per demo on every (program, demo) "
          f"pair; demos reproduced: {counts}")


def check_main_path_imports():
    loaded = [m for m in NOT_ON_MAIN_PATH if m in sys.modules]
    if loaded:
        raise RuntimeError(f"the main path imported {loaded}")


def run_single(jax):
    phase_environment(jax, 1)
    if jax.device_count() != 1:
        raise RuntimeError(f"the default phases use one card; JAX sees "
                           f"{jax.device_count()}")
    gen_s = make_dataset(osp.join(WORK, "karel"), num_train=320)
    phase("generate", f"320 train / 64 test / 32 val items in {gen_s:.1f} s")
    ckpt = phase_train(osp.join(WORK, "karel"), osp.join(WORK, "train"))
    phase_numerics(jax, osp.join(WORK, "karel"))
    phase_eval(osp.join(WORK, "karel"), ckpt, osp.join(WORK, "eval"))
    check_main_path_imports()


def four_card_losses(jax, ds_dir, n_devices):
    import types

    import numpy as np

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import Trainer

    ds_train, ds_test, _ = create_default_splits(ds_dir, num_k=K)
    train_dir = osp.join(WORK, f"train_{n_devices}card")
    shutil.rmtree(train_dir, ignore_errors=True)
    args = types.SimpleNamespace(
        debug=False, prefix="smoke", model="full", dataset_type="karel",
        dataset_path=ds_dir, checkpoint=None, num_k=K, batch_size=BS,
        seed=123, encoder_rnn_type="lstm", num_lstm_cell_units=UNITS,
        demo_aggregation="avgpool", scheduled_sampling=False,
        scheduled_sampling_decay_steps=20000, train_dir=train_dir,
        learning_rate=1e-3, lr_weight_decay=False, log_step=1,
        write_summary_step=100, test_sample_step=1000,
        ckpt_save_step=1000, max_steps=FOUR_CARD_STEPS)
    with jax.default_matmul_precision("highest"):
        trainer = Trainer(args, ds_train, ds_test, num_devices=n_devices)
        mesh_size = trainer.mesh.devices.size
        t0 = time.time()
        trainer.train(max_steps=FOUR_CARD_STEPS)
        wall = time.time() - t0
    trainer.metrics_file.close()
    losses = np.array([r["loss"] for r in read_metrics(train_dir)
                       if r["split"] == "train"])
    return mesh_size, losses, wall


def run_four_cards(jax):
    import numpy as np

    phase_environment(jax, 4)
    ds_dir = osp.join(WORK, "karel4")
    make_dataset(ds_dir, num_train=320)
    results = {n: four_card_losses(jax, ds_dir, n) for n in (4, 1)}
    (m4, l4, w4), (m1, l1, w1) = results[4], results[1]
    if m4 != 4 or m1 != 1 or len(l4) != FOUR_CARD_STEPS \
            or len(l1) != FOUR_CARD_STEPS:
        raise RuntimeError(f"unexpected runs: meshes {m4}/{m1}, "
                           f"losses {l4} / {l1}")
    rel = np.abs(l4 - l1) / np.abs(l1)
    if not (rel <= FOUR_CARD_RTOL).all():
        raise RuntimeError(f"4-card vs 1-card losses differ: rel {rel}")
    phase("four_cards", f"global bs {BS} on the 4-card mesh vs 1 card, "
          f"{FOUR_CARD_STEPS} steps at highest precision: 4-card "
          f"{l4.tolist()}, 1-card {l1.tolist()}, max rel diff "
          f"{rel.max():.2e} (tol {FOUR_CARD_RTOL}); wall {w4:.1f} s / "
          f"{w1:.1f} s incl. compile")
    check_main_path_imports()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four_cards", action="store_true",
                   help="run only the 4-card data-parallel check")
    args = p.parse_args(argv)
    if not args.four_cards:
        # the default phases use one card: show JAX only the first of the
        # visible ones (set before JAX starts its GPU backend)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = (
            "0" if visible is None else visible.split(",")[0])
    sys.path.insert(0, ROOT)
    try:
        import jax

        from demo2program_tpu.cli._jax_setup import setup
        require_gpu(jax)
        setup()
        if args.four_cards:
            run_four_cards(jax)
        else:
            run_single(jax)
    except Exception as exc:  # noqa: BLE001 - report and fail the smoke
        import traceback
        traceback.print_exc()
        print(f"[chip_smoke] FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
