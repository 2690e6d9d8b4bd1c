"""Offline re-scoring of dumped program predictions.

Parity target: `karel_env/tool/eval_execution.py` — takes the dataset's
data.hdf5 and an evaler out_*.hdf5 dump, re-executes the teacher-forced and
greedy predictions against the seen (train) and unseen (test) demos, and
reports syntax accuracy, execution-accuracy histograms, and 100%-correct
rates; optionally dumps a merged result hdf5 (`--dump`) or a log (`--log`).

Unlike the reference (one serial Python rollout per program x demo), all
rollouts for a result table run as one batched VM call on device.
"""

import argparse
import collections
import os

import numpy as np

from demo2program_tpu.data.store import NpzWriter, open_store
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.dsl.karel_bytecode import compile_tokens, \
    DEFAULT_MAX_CODE_LEN
from demo2program_tpu.ops import vm
from demo2program_tpu.ops.grids import decode_states


CheckProgramOutput = collections.namedtuple(
    "CheckProgramOutput",
    ("data_id", "program", "syntax", "num_correct", "demo_correctness"))


class EvaluationResult:
    """Accumulates CheckProgramOutputs; summary parity with
    `tool/eval_execution.py:70-120`."""

    def __init__(self, name):
        self.name = name
        self.outputs = {}

    def add(self, out):
        self.outputs[out.data_id] = out

    def result_string(self):
        outs = list(self.outputs.values())
        n = len(outs)
        syntax_acc = np.mean([o.syntax for o in outs]) if n else 0.0
        num_demo = max((len(o.demo_correctness) for o in outs), default=0)
        hist = np.zeros(num_demo + 1)
        for o in outs:
            hist[int(o.num_correct)] += 1
        hist = hist / max(n, 1)
        all_correct = float(hist[-1]) if num_demo else 0.0
        hist_str = ", ".join(f"{v:.3f}" for v in hist)
        return ("[{name}] n: {n}, syntax_acc: {syntax: .3f}, "
                "100%-exec-correct: {allc: .3f}\n"
                "  #correct-of-k histogram: [{hist}]\n").format(
            name=self.name, n=n, syntax=syntax_acc, allc=all_correct,
            hist=hist_str)

    def get(self, data_id):
        return self.outputs[data_id]


def batch_check(programs, data_ids, demos, demo_lens, vocab, make_error=True,
                pad_n=None, pad_T=None):
    """Re-execute `programs[i]` against demos[i] (k, T, h, w, 16) on device.

    pad_n / pad_T fix the compiled shapes so repeated calls share one jit
    compilation. Returns a list of CheckProgramOutput.
    """
    import jax.numpy as jnp

    n_real = len(programs)
    n = pad_n or n_real
    k = demos[0].shape[0]
    h, w = demos[0].shape[2], demos[0].shape[3]
    T = pad_T or max(d.shape[1] for d in demos)

    codes = np.zeros([n, DEFAULT_MAX_CODE_LEN, 2], np.int32)
    ok = np.zeros(n, bool)
    for i, prog in enumerate(programs):
        ids = vocab.str2intseq(prog) if all(
            t in vocab.token2int for t in prog.split()) else []
        codes[i], ok[i] = (compile_tokens(ids, vocab)
                           if ids else (codes[i], False))

    demo_np = np.zeros([n, k, T, h, w, demos[0].shape[-1]], np.uint8)
    lens = np.ones([n, k], np.int32)
    for i, d in enumerate(demos):
        demo_np[i, :, :d.shape[1]] = d
        lens[i] = demo_lens[i]

    dec = decode_states(jnp.asarray(demo_np))

    def flat(a):
        return np.asarray(a).reshape((n * k,) + a.shape[2:])

    out = vm.run_and_compare(
        jnp.asarray(np.repeat(codes, k, axis=0)),
        jnp.asarray(flat(dec["wall"][:, :, 0])),
        jnp.asarray(flat(dec["y"][:, :, 0])),
        jnp.asarray(flat(dec["x"][:, :, 0])),
        jnp.asarray(flat(dec["d"][:, :, 0])),
        jnp.asarray(flat(dec["markers"][:, :, 0])),
        jnp.asarray(flat(dec["y"])), jnp.asarray(flat(dec["x"])),
        jnp.asarray(flat(dec["d"])), jnp.asarray(flat(dec["markers"])),
        jnp.asarray(lens.reshape(-1)),
        make_error=make_error, h=h, w=w)
    correct = np.asarray(out["correct"]).reshape(n, k) & ok[:, None]

    results = []
    for i in range(n_real):
        results.append(CheckProgramOutput(
            data_ids[i], programs[i], bool(ok[i]),
            int(correct[i].sum()), correct[i]))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_hdf5", required=True)
    p.add_argument("--output_hdf5", required=True)
    p.add_argument("--log", action="store_true", default=False)
    p.add_argument("--output_log_path", type=str, default=None)
    p.add_argument("--dump", action="store_true", default=False)
    p.add_argument("--new_hdf5_path", type=str, default=None)
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args(argv)

    vocab = KarelVocab()
    results = {name: EvaluationResult(name) for name in [
        "train_tf_result", "test_tf_result",
        "train_greedy_result", "test_greedy_result"]}

    with open_store(args.data_hdf5) as fd, \
            open_store(args.output_hdf5) as fo:
        ids = [k for k in fo.keys() if k != "data_info"]
        pad_T = int(fd["data_info"]["max_demo_length"][()])
        for lo in range(0, len(ids), args.batch):
            chunk = ids[lo:lo + args.batch]
            tf_progs, greedy_progs = [], []
            train_demos, train_lens, test_demos, test_lens = [], [], [], []
            for did in chunk:
                out = fo[did]
                data = fd[did]
                tf_progs.append(_dec(out["program_prediction"][()]))
                greedy_progs.append(_dec(out["greedy_prediction"][()]))
                train_demos.append(data["s_h"][()])
                train_lens.append(data["s_h_len"][()])
                test_demos.append(data["test_s_h"][()])
                test_lens.append(data["test_s_h_len"][()])
            for name, progs, demos, lens in [
                    ("train_tf_result", tf_progs, train_demos, train_lens),
                    ("test_tf_result", tf_progs, test_demos, test_lens),
                    ("train_greedy_result", greedy_progs, train_demos,
                     train_lens),
                    ("test_greedy_result", greedy_progs, test_demos,
                     test_lens)]:
                for out in batch_check(progs, chunk, demos, lens, vocab,
                                       pad_n=args.batch, pad_T=pad_T):
                    results[name].add(out)

    report = ""
    for r in results.values():
        report += r.result_string()
    print(report)
    if args.log:
        path = args.output_log_path or f"{args.output_hdf5}.eval_exe.log"
        with open(path, "w") as f:
            f.write(report)
    if args.dump:
        path = args.new_hdf5_path or f"{args.output_hdf5}.eval_exe.npz"
        correctness = ["wrong", "correct"]
        with NpzWriter(path) as nf:
            for did in results["train_tf_result"].outputs:
                grp = nf.create_group(did)
                for prefix, tr, te in [
                        ("program", results["train_tf_result"],
                         results["test_tf_result"]),
                        ("greedy", results["train_greedy_result"],
                         results["test_greedy_result"])]:
                    o, ot = tr.get(did), te.get(did)
                    pred_key = ("program_prediction" if prefix == "program"
                                else "greedy_prediction")
                    grp[pred_key] = o.program
                    grp[f"{prefix}_syntax"] = correctness[int(o.syntax)]
                    grp[f"{prefix}_is_correct_execution"] = \
                        o.demo_correctness
                    grp[f"{prefix}_num_execution_correct"] = o.num_correct
                    grp[f"test_{pred_key}"] = ot.program
                    grp[f"test_{prefix}_syntax"] = correctness[int(ot.syntax)]
                    grp[f"test_{prefix}_is_correct_execution"] = \
                        ot.demo_correctness
                    grp[f"test_{prefix}_num_execution_correct"] = \
                        ot.num_correct
        print(f"Dumped result file: {path}")


def _dec(v):
    return v.decode() if isinstance(v, bytes) else str(v)


if __name__ == "__main__":
    main()
