"""Training entry point.

Usage parity with the reference (`trainer.py:243-291`):

  python -m demo2program_tpu.cli.trainer_cli \
      --model full --dataset_type karel \
      --dataset_path datasets/karel_dataset --num_k 10
"""

from demo2program_tpu.cli.flags import base_parser, add_train_flags
from demo2program_tpu.data.dataset import create_default_splits
from demo2program_tpu.train.trainer import Trainer
from demo2program_tpu.utils import log


def _stage_already_done(train_dir):
    """True when `train_dir` holds a checkpoint at (or past) its recorded
    resume.json target — relaunching such a stage would pay the full input
    setup (for ViZDoom, a multi-GB device cache load+push) only to log
    "Nothing to do". Lets idempotent suite scripts re-invoke completed
    stages for free."""
    import json
    import os
    import os.path as osp
    resume = osp.join(train_dir or "", "resume.json")
    ckpt_dir = osp.join(train_dir or "", "ckpt")
    if not (train_dir and osp.exists(resume) and osp.isdir(ckpt_dir)):
        return False
    try:
        target = int(json.load(open(resume))["target_step"])
    except (ValueError, KeyError, OSError):
        return False
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return bool(steps) and max(steps) >= target


def main(argv=None):
    from demo2program_tpu.cli._jax_setup import setup
    setup()
    parser = add_train_flags(base_parser())
    args = parser.parse_args(argv)

    if _stage_already_done(args.train_dir):
        log.infov("Nothing to do: %s already reached its resume.json "
                  "target", args.train_dir)
        return

    if args.dataset_type == "karel":
        ds_train, ds_test, ds_val = create_default_splits(
            args.dataset_path, num_k=args.num_k)
    else:
        from demo2program_tpu.data.vizdoom_dataset import (
            create_vizdoom_splits)
        ds_train, ds_test, ds_val = create_vizdoom_splits(
            args.dataset_path, num_k=args.num_k)

    trainer = Trainer(args, ds_train, ds_test)
    log.warning("dataset: %s, learning_rate: %f",
                args.dataset_path, args.learning_rate)
    trainer.train(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
