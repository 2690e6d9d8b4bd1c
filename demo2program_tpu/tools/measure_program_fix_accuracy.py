"""Edit-distance-tolerant accuracy sweep over an evaler --result_data dump.

Parity target: `vizdoom_env/measure_program_fix_accuracy.py` — for every
prediction, computes the token-level edit distance to the ground truth and
the execution correctness on the unseen test demos, then reports, for
d = 0..19, the fraction of programs that are sequence-correct OR within edit
distance d, and execution-correct OR within d (`:84-90`). Used to estimate
how often predictions are "one edit away" from a working program.

Works for both domains; ViZDoom execution needs the engine, Karel execution
runs on the on-device VM.
"""

import argparse

import numpy as np

from demo2program_tpu.data.store import open_store
from demo2program_tpu.utils import log


def levenshtein(a, b):
    """Token-sequence edit distance (replaces the `editdistance` dep)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def sweep(sequence_match, execute_correct, edit_distances, max_d=20):
    """-> list of (d, seq_acc, exe_acc) rows (`:84-90`)."""
    seqm = np.asarray(sequence_match, np.int32)
    exec_ = np.asarray(execute_correct, np.int32)
    dist = np.asarray(edit_distances, np.int32)
    rows = []
    for d in range(max_d):
        close = (dist <= d).astype(np.int32)
        rows.append((d,
                     float(np.clip(seqm + close, 0, 1).mean()),
                     float(np.clip(exec_ + close, 0, 1).mean())))
    return rows


def _karel_execution(result_file, data_file, vocab):
    from demo2program_tpu.tools.eval_execution import batch_check
    ids = [k for k in result_file.keys() if k != "data_info"]
    programs, demos, lens = [], [], []
    for did in ids:
        prog_len = int(result_file[did]["pred_program_len"][()])
        tokens = np.argmax(result_file[did]["pred_program"][()],
                           axis=0)[:prog_len]
        programs.append(vocab.intseq2str(tokens))
        demos.append(data_file[did]["test_s_h"][()])
        lens.append(data_file[did]["test_s_h_len"][()])
    outs = batch_check(programs, ids, demos, lens, vocab)
    k = demos[0].shape[0]
    return ids, programs, [o.num_correct == k for o in outs]


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--result_file", type=str, default="result.npz")
    p.add_argument("--data_file", type=str,
                   default="datasets/karel_dataset/data.npz")
    p.add_argument("--dataset_type", type=str, default="karel",
                   choices=["karel", "vizdoom"])
    p.add_argument("--engine_config", type=str,
                   default="vizdoom_env/asset/default.cfg")
    args = p.parse_args(argv)

    fr = open_store(args.result_file)
    ft = open_store(args.data_file)

    if args.dataset_type == "karel":
        from demo2program_tpu.dsl.karel_vocab import KarelVocab
        vocab = KarelVocab()
        ids, programs, execute_correct = _karel_execution(fr, ft, vocab)
    else:
        from demo2program_tpu.dsl.vizdoom_vocab import VizDoomDSLVocab
        from demo2program_tpu.eval.vizdoom_scorer import VizdoomScorer
        from demo2program_tpu.models.common import ModelConfig
        info = ft["data_info"]
        ptype = info["perception_type"][()]
        ptype = ptype.decode() if isinstance(ptype, bytes) else str(ptype)
        vocab = VizDoomDSLVocab(perception_type=ptype)
        pos_keys = [k.decode() if isinstance(k, bytes) else str(k)
                    for k in info["vizdoom_pos_keys"][()]]
        cfg = ModelConfig(
            dataset_type="vizdoom", perception_type=ptype,
            vizdoom_pos_keys=tuple(pos_keys),
            h=int(info["s_h_h"][()]), w=int(info["s_h_w"][()]),
            depth=int(info["s_h_c"][()]),
            k=int(info["num_demo_per_program"][()]),
            test_k=int(info["num_test_demo_per_program"][()]))
        scorer = VizdoomScorer(cfg, vocab,
                               engine_config=args.engine_config)
        ids = [k for k in fr.keys() if k != "data_info"]
        programs, execute_correct = [], []
        for did in ids:
            prog_len = int(fr[did]["pred_program_len"][()])
            tokens = np.argmax(fr[did]["pred_program"][()],
                               axis=0)[:prog_len]
            programs.append(vocab.intseq2str(tokens))
            tk = cfg.test_k
            nc, _ = scorer.execution(
                tokens[None], np.array([prog_len]), np.zeros(1),
                ft[did]["test_s_h"][()][None],
                ft[did]["test_s_h_len"][()][None],
                ft[did]["test_vizdoom_init_pos"][()][None],
                ft[did]["test_vizdoom_init_pos_len"][()][None])
            execute_correct.append(nc[0] == tk)

    seq_match, distances = [], []
    for did, prog in zip(ids, programs):
        gt = vocab.intseq2str(ft[did]["program"][()])
        seq_match.append(prog == gt)
        distances.append(levenshtein(prog.split(), gt.split()))

    for d, seq_acc, exe_acc in sweep(seq_match, execute_correct, distances):
        print(f"edit distance: {d}, seq_acc: {seq_acc}, exe_acc: {exe_acc}")

    fr.close()
    ft.close()


if __name__ == "__main__":
    main()
