"""Classify ViZDoom prediction errors from an evaler dump.

Makes the round-2/3 error analyses reproducible: every non-exact decode in
an `out_<step>_<split>.txt` dump (written by `eval/evaler.py`, format parity
with the reference's `evaler.py:164-208` artifact) is bucketed by WHERE the
predicted token sequence differs from the ground truth:

  species_only    all differing positions are monster-name <-> monster-name
                  swaps (Demon/HellKnight/Revenant) — program structure,
                  branch bodies, polarity and predicate types all correct;
                  a visual species-identification error, not a program-
                  inference error
  predicate_only  diffs confined to non-monster percept tokens (ISTHERE/
                  INTARGET/EXIST, distance/horizontal arguments, `not`)
  percept_mixed   diffs confined to percept positions but spanning both of
                  the above
  structural      anything else: different length, or diffs touching
                  actions / control flow

Because the dataset generator verifies every ground-truth program against
its own demos (`data/vizdoom_generator.py`, reference
`vizdoom_env/generator.py:147-169`), a species_only error becomes the exact
gt program once species are corrected — so `exact_or_species_only` is the
sequence-accuracy ceiling of a species oracle, and (with the sibling
`.npz` or `.hdf5` dump's per-seen-demo execution bits)
`seen_exec_or_species_only` is the matching execution ceiling.

Usage:
  python -m demo2program_tpu.tools.doom_error_analysis \
      --dump train_dir/X/eval/out_100000_test.txt [--decode greedy|pred]
"""

import argparse
import json
import os
import re

from demo2program_tpu.data.store import open_store
from demo2program_tpu.dsl.vizdoom_defs import (
    ACTION_LIST, MERGE_DISTANCE_VOCAB, MERGE_HORIZONTAL_VOCAB, MONSTER_LIST)

MONSTERS = set(MONSTER_LIST)
# percept machinery: predicate heads, their arguments, polarity
PERCEPT = ({"ISTHERE", "INTARGET", "EXIST", "not", "MyAmmo"}
           | set(MERGE_DISTANCE_VOCAB) | set(MERGE_HORIZONTAL_VOCAB))


def parse_dump(path):
    """Yield (id, gt_tokens, pred_tokens, greedy_tokens) per dump entry."""
    entry = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            m = re.match(r"\[id: (.+)\]", line)
            if m:
                if entry.get("id"):
                    yield entry
                entry = {"id": m.group(1)}
            elif line.startswith("gt:"):
                entry["gt"] = line[3:].split()
            elif line.startswith("pred"):
                entry["pred"] = line.split(":", 1)[1].split()
            elif line.startswith("greedy"):
                # `greedy(error):` marks a syntax-invalid decode — still an
                # entry (it classifies as structural)
                entry["greedy"] = line.split(":", 1)[1].split()
    if entry.get("id"):
        yield entry


def classify(gt, pred):
    if gt == pred:
        return "exact"
    if len(gt) != len(pred):
        return "structural"
    kinds = set()
    for a, b in zip(gt, pred):
        if a == b:
            continue
        if a in MONSTERS and b in MONSTERS:
            kinds.add("species")
        elif a in PERCEPT and b in PERCEPT:
            kinds.add("predicate")
        else:
            kinds.add("structural")
    if "structural" in kinds:
        return "structural"
    if kinds == {"species"}:
        return "species_only"
    if kinds == {"predicate"}:
        return "predicate_only"
    return "percept_mixed"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bucket doom eval errors by token-diff class")
    ap.add_argument("--dump", required=True,
                    help="out_<step>_<split>.txt from the evaler")
    ap.add_argument("--decode", default="greedy",
                    choices=["greedy", "pred"],
                    help="which decode to analyze (default: greedy)")
    args = ap.parse_args(argv)

    counts = {"exact": 0, "species_only": 0, "predicate_only": 0,
              "percept_mixed": 0, "structural": 0}
    ids_by_class = {k: [] for k in counts}
    n = 0
    for entry in parse_dump(args.dump):
        gt, pred = entry.get("gt"), entry.get(args.decode)
        if gt is None or pred is None:
            continue
        n += 1
        c = classify(gt, pred)
        counts[c] += 1
        ids_by_class[c].append(entry["id"])

    wrong = n - counts["exact"]
    out = {
        "dump": args.dump, "decode": args.decode, "n": n,
        "exact": counts["exact"], "wrong": wrong,
        "of_wrong": {k: {"count": counts[k],
                         "frac": round(counts[k] / wrong, 3) if wrong else 0}
                     for k in ("species_only", "predicate_only",
                               "percept_mixed", "structural")},
        "exact_or_species_only": round(
            (counts["exact"] + counts["species_only"]) / n, 3) if n else 0,
    }

    # execution ceiling: per-seen-demo bits live in the sibling store dump
    stores = [args.dump.replace(".txt", ext) for ext in (".npz", ".hdf5")]
    store_path = next((p for p in stores if os.path.exists(p)), None)
    if store_path:
        key = ("greedy_is_correct_execution" if args.decode == "greedy"
               else "program_is_correct_execution")
        species_ids = set(ids_by_class["species_only"])
        n_exec = n_correct = n_oracle = 0
        with open_store(store_path) as f:
            for gid in f:
                if key not in f[gid]:
                    continue
                n_exec += 1
                ok = bool(f[gid][key][()].all())
                n_correct += ok
                n_oracle += ok or (gid in species_ids)
        if n_exec:
            out["seen_exec"] = round(n_correct / n_exec, 3)
            out["seen_exec_or_species_only"] = round(n_oracle / n_exec, 3)

    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
