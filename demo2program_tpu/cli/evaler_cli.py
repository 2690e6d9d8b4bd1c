"""Evaluation entry point.

Flag parity with the reference `evaler.py:362-425` (the `--unseen_test` flag
is parsed-but-unused there — SURVEY.md §6 quirk (e) — and kept that way).
"""

from demo2program_tpu.cli.flags import base_parser
from demo2program_tpu.data.dataset import create_default_splits
from demo2program_tpu.eval.evaler import Evaler
from demo2program_tpu.utils import log


def main(argv=None):
    from demo2program_tpu.cli._jax_setup import setup
    setup()
    p = base_parser()
    p.set_defaults(batch_size=20)
    p.add_argument("--dataset_split", type=str, default="test",
                   choices=["train", "test", "val"])
    p.add_argument("--train_dir", type=str, default="",
                   help="evaluate the newest checkpoint in this train_dir")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=0,
                   help="number of batches; 0 = the whole split")
    p.add_argument("--no_loss", action="store_true", default=False)
    p.add_argument("--pred_program", action="store_true", default=False)
    p.add_argument("--result_data", action="store_true", default=False)
    p.add_argument("--result_data_path", type=str, default="result.npz")
    p.add_argument("--id_list", type=str, default=None)
    p.add_argument("--unseen_test", action="store_true", default=False)
    p.add_argument("--quiet", action="store_true", default=False)
    p.add_argument("--unroll_type", type=str, default="greedy",
                   choices=["greedy", "syntax_greedy", "syntax_sample",
                            "beam"],
                   help="program decoding mode; syntax_* constrain each step "
                        "to grammar-legal tokens via the on-device pushdown; "
                        "beam = on-device beam search (--beam_width)")
    p.add_argument("--beam_width", type=int, default=5)
    p.add_argument("--execution_rerank", action="store_true", default=False,
                   help="with --unroll_type beam: report, as the decoded "
                        "program, the highest-scoring beam that reproduces "
                        "all SEEN demos (execution-guided selection; uses "
                        "no test-demo information)")
    p.add_argument("--rerank_k", type=int, default=0,
                   help="verify reranked beams against this many stored "
                        "seen demos instead of --num_k (vizdoom only; the "
                        "model still conditions on num_k demos — the extra "
                        "demos are part of the same task instance and carry "
                        "no test-demo information). 0 = use num_k")
    p.add_argument("--no_write_summary", action="store_true", default=False)
    p.add_argument("--summary_file", type=str, default=None)
    p.add_argument("--sweep_steps", type=str, default="",
                   help="comma-separated checkpoint steps to evaluate in ONE "
                        "process (requires --train_dir): the jitted eval "
                        "graph compiles once and each checkpoint only pays "
                        "its restore. Steps whose out_<step>_<split>.log "
                        "already contains a Final Avg Report are skipped; "
                        "missing checkpoint dirs are skipped with a warning")
    args = p.parse_args(argv)
    args.write_summary = not args.no_write_summary
    if args.output_dir is None:
        args.output_dir = args.train_dir or "."

    if args.dataset_type == "karel":
        splits = create_default_splits(args.dataset_path, num_k=args.num_k,
                                       is_train=False)
    else:
        from demo2program_tpu.data.vizdoom_dataset import (
            create_vizdoom_splits)
        splits = create_vizdoom_splits(args.dataset_path, num_k=args.num_k,
                                       is_train=False)
    target = dict(zip(["train", "test", "val"], splits))[args.dataset_split]
    if args.id_list:
        from demo2program_tpu.data.dataset import check_data_id
        with open(args.id_list) as f:
            wanted = [line.strip() for line in f if line.strip()]
        check_data_id(target, wanted)
        target._ids = wanted

    if not args.max_steps > 0:
        args.max_steps = len(target.ids) // args.batch_size

    if args.sweep_steps:
        import os
        import re
        if not args.train_dir:
            raise SystemExit("--sweep_steps requires --train_dir")
        steps = [int(s) for s in args.sweep_steps.split(",") if s.strip()]
        todo = []
        for step in steps:
            ck = os.path.join(os.path.abspath(args.train_dir), "ckpt",
                              str(step), "default")
            if not os.path.isdir(ck):
                log.warn("sweep: no checkpoint at step %d; skipping", step)
                continue
            out = os.path.join(args.output_dir,
                               f"out_{step}_{args.dataset_split}.log")
            try:
                if re.search(r"Final Avg Report", open(out).read()):
                    log.info("sweep: step %d already evaluated; skipping",
                             step)
                    continue
            except OSError:
                pass
            todo.append((step, ck))
        if not todo:
            log.infov("sweep: nothing to do")
            return
        args.checkpoint = todo[0][1]
        evaler = Evaler(args, target)
        log.warning("dataset: %s", args.dataset_path)
        for step, ck in todo:
            if ck != evaler.checkpoint:
                evaler.set_checkpoint(ck)
            evaler.eval_run()
        return

    evaler = Evaler(args, target)
    log.warning("dataset: %s", args.dataset_path)
    evaler.eval_run()


if __name__ == "__main__":
    main()
