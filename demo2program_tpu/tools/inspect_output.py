"""Prediction browser over evaler out_* store dumps (.npz, or .hdf5).

Parity target: `karel_env/tool/inspect_output.py` — joins an evaler output
file with the dataset, showing ground-truth vs predicted programs,
syntax/execution verdicts, and optionally replaying the predicted program's
rollout in ASCII. `--no_input` prints a non-interactive digest.
"""

import argparse
import os

import numpy as np

from demo2program_tpu.data.store import open_store
from demo2program_tpu.dsl import karel_interp, karel_parser
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.envs import KarelWorld
from demo2program_tpu.tools.karel_render import state2str


def _dec(v):
    return v.decode() if isinstance(v, bytes) else str(v)


def show_prediction(data, out, data_id, vocab, replay=False):
    gt = vocab.intseq2str(data[data_id]["program"][()])
    o = out[data_id]
    print(f"\n[id: {data_id}]")
    print(f"gt:     {gt}")
    print(f"pred:   {_dec(o['program_prediction'][()])} "
          f"(syntax {_dec(o['program_syntax'][()])}, "
          f"exec {int(o['program_num_execution_correct'][()])} correct)")
    print(f"greedy: {_dec(o['greedy_prediction'][()])} "
          f"(syntax {_dec(o['greedy_syntax'][()])}, "
          f"exec {int(o['greedy_num_execution_correct'][()])} correct)")
    if replay:
        code = _dec(o["greedy_prediction"][()])
        ast, ok = karel_parser.parse(code)
        if not ok:
            print("greedy prediction does not parse; cannot replay")
            return
        s0 = data[data_id]["s_h"][()][0, 0]
        world = KarelWorld(s0.copy())
        _, success = karel_interp.execute(ast, world)
        print(f"replay on demo 0 initial state (success={success}):")
        for t, s in enumerate(world.s_h):
            print(f"step {t}:")
            print(state2str(s))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_hdf5", required=True)
    p.add_argument("--output_hdf5", required=True)
    p.add_argument("--id", type=str, default=None)
    p.add_argument("--replay", action="store_true", default=False)
    p.add_argument("--no_input", action="store_true", default=False)
    args = p.parse_args(argv)

    vocab = KarelVocab()
    with open_store(args.data_hdf5) as data, \
            open_store(args.output_hdf5) as out:
        ids = [args.id] if args.id else \
            [k for k in out.keys() if k != "data_info"]
        for data_id in ids:
            show_prediction(data, out, data_id, vocab, replay=args.replay)
            if args.no_input:
                continue
            if input("[enter: next, q: quit] ").strip() == "q":
                break


if __name__ == "__main__":
    main()
