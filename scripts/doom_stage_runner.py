"""Multi-stage ViZDoom train+eval driver: ONE process, ONE device-cache push.

Each trainer_cli invocation on a doom dataset reads the split and pushes it
into the device-resident cache (train/device_cache.py).
A training suite (two-stage full model + baselines) on the SAME dataset
re-pushes identical bytes per stage. This runner builds the cache once
(with test actions, so it also serves the induction baseline), then runs
every stage in-process — Trainer accepts the pre-built pipe — re-aiming
the cache at each stage's batch size. Completed stages (resume.json target
reached) are skipped, so relaunching after a crash continues the suite;
a crashed stage itself auto-resumes from its latest checkpoint.

After each training stage the test-split eval runs in-process too
(greedy decode + live-engine scoring, same artifacts as evaler_cli).

Usage:
  python scripts/doom_stage_runner.py --dataset_path datasets/X --num_k 25 \
      --stage model=full,bs=8,steps=50000,dir=train_dir/x_s2,warm=...ckpt \
      --stage model=synthesis_baseline,bs=32,steps=25000,dir=train_dir/y

LR protocol (r5 fix): stages train at CONSTANT Adam 1e-3 unless the spec
passes decay=1. The reference's ViZDoom commands never pass
--lr_weight_decay (README.md:116-133; trainer.py:275 defaults it False),
so its two-stage doom training ran at constant 1e-3 throughout. The old
hardcoded --lr_weight_decay here was doubly wrong: warm-start restores
the full optimizer state including the Adam step count, so stage 2
resumed the staircase at 1e-3*0.5^5 ~= 3e-5 decaying to 1e-6 — an
effectively FROZEN finetune stage (the r3 doom suite trained this way).
"""
import argparse
import gc
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from demo2program_tpu.utils import log


def parse_stage(spec):
    st = dict(kv.split("=", 1) for kv in spec.split(","))
    for req in ("model", "bs", "steps", "dir"):
        if req not in st:
            raise SystemExit(f"--stage missing {req}=: {spec}")
    return st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--num_k", type=int, default=25)
    ap.add_argument("--stage", action="append", required=True)
    ap.add_argument("--no_eval", action="store_true")
    wargs = ap.parse_args()
    stages = [parse_stage(s) for s in wargs.stage]

    from demo2program_tpu.cli._jax_setup import setup
    setup()
    from demo2program_tpu.cli import evaler_cli
    from demo2program_tpu.cli.flags import add_train_flags, base_parser
    from demo2program_tpu.cli.trainer_cli import _stage_already_done
    from demo2program_tpu.data.vizdoom_dataset import create_vizdoom_splits
    from demo2program_tpu.train.device_cache import DoomDeviceCache
    from demo2program_tpu.train.trainer import Trainer

    ds_train = ds_test = cache = None
    for st in stages:
        argv = ["--dataset_type", "vizdoom",
                "--dataset_path", wargs.dataset_path,
                "--num_k", str(wargs.num_k),
                "--model", st["model"], "--batch_size", st["bs"],
                "--max_steps", st["steps"],
                "--train_dir", st["dir"],
                "--ckpt_save_step", st.get("save", "5000"),
                "--test_sample_step", st.get("sample", "2500"),
                "--log_step", "100"]
        if st.get("decay", "0") == "1":
            argv.append("--lr_weight_decay")
        if not _stage_already_done(st["dir"]):
            if st.get("warm"):
                argv += ["--checkpoint", st["warm"]]
            args = add_train_flags(base_parser()).parse_args(argv)
            if ds_train is None:
                ds_train, ds_test, _ = create_vizdoom_splits(
                    wargs.dataset_path, num_k=wargs.num_k)
            if cache is None:
                cache = DoomDeviceCache(ds_train, int(st["bs"]),
                                        seed=args.seed,
                                        include_test_actions=True)
            cache.set_batch_size(int(st["bs"]))
            log.infov("=== stage %s: %s (bs %s, %s steps) ===",
                      st["dir"], st["model"], st["bs"], st["steps"])
            trainer = Trainer(args, ds_train, ds_test, pipe_train=cache)
            trainer.train(max_steps=args.max_steps)
            trainer.metrics_file.close()
            del trainer
            gc.collect()
        else:
            log.infov("stage %s already complete; skipping train", st["dir"])
        if not wargs.no_eval and st.get("eval", "1") != "0":
            import glob
            # gate on the completion marker: a crashed eval leaves a
            # partial log that must be redone (ADVICE r3 low)
            done = [p for p in glob.glob(osp.join(st["dir"], "eval",
                                                  "out_*_test.log"))
                    if "Final Avg Report" in open(p).read()]
            if done:
                log.infov("eval for %s already on disk (%s); skipping",
                          st["dir"], done[0])
                continue
            log.infov("=== eval %s ===", st["dir"])
            try:
                evaler_cli.main([
                    "--dataset_type", "vizdoom",
                    "--dataset_path", wargs.dataset_path,
                    "--num_k", str(wargs.num_k),
                    "--quiet", "--pred_program", "--model", st["model"],
                    "--train_dir", st["dir"],
                    "--output_dir", st["dir"] + "/eval"])
            except Exception:  # a failed eval must not kill later stages
                log.error("eval for %s FAILED; continuing suite",
                          st["dir"], exc_info=True)
            gc.collect()
    log.infov("RUNNER DONE (%d stages)", len(stages))


if __name__ == "__main__":
    main()
