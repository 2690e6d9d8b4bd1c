"""Merge seed-sharded ViZDoom datasets into one.

Parity target: `vizdoom_env/merge_datasets.py` — dataset generation is
embarrassingly parallel across seeds (`vizdoom_env/generate_dataset.sh`);
this merges the shards, re-numbering ids and re-checking that per-shard
metadata agrees; max_demo_length / max_program_length /
vizdoom_max_init_pos_len take the max across shards, and split sizes add up.
"""

import argparse
import os

import numpy as np

from demo2program_tpu.data.store import NpzWriter, data_file, open_store
from demo2program_tpu.utils import log

_CONSISTENT_KEYS = ["num_program_tokens", "num_action_tokens",
                    "s_h_h", "s_h_w", "s_h_c", "perception_type"]
# num_demo counts take the max across shards (`merge_datasets.py:61-63`)
_MAX_KEYS = ["max_demo_length", "max_program_length",
             "vizdoom_max_init_pos_len", "num_demo_per_program",
             "num_test_demo_per_program"]
_SUM_KEYS = ["num_train", "num_test", "num_val"]


def merge(shard_dirs, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    out = NpzWriter(os.path.join(out_dir, "data.npz"))
    id_out = open(os.path.join(out_dir, "id.txt"), "w")

    meta = {}
    count = 0
    for shard_idx, shard in enumerate(shard_dirs):
        f = open_store(data_file(shard))
        info = f["data_info"]
        for key in _CONSISTENT_KEYS:
            v = info[key][()]
            if key in meta and not np.array_equal(meta[key], v):
                raise ValueError(
                    f"inconsistent data_info[{key}] across shards: "
                    f"{meta[key]!r} vs {v!r} ({shard})")
            meta.setdefault(key, v)
        for key in _MAX_KEYS:
            meta[key] = max(meta.get(key, -1), int(info[key][()]))
        for key in _SUM_KEYS:
            meta[key] = meta.get(key, 0) + int(info[key][()])
        if "percepts" in info and "percepts" not in meta:
            meta["percepts"] = info["percepts"][()]
        if "vizdoom_pos_keys" in info and "vizdoom_pos_keys" not in meta:
            meta["vizdoom_pos_keys"] = info["vizdoom_pos_keys"][()]

        with open(os.path.join(shard, "id.txt")) as fp:
            ids = [s.strip() for s in fp if s.strip()]
        for old_id in ids:
            # shard-index prefix, as the reference does
            # (`merge_datasets.py:95-96`)
            new_id = f"{shard_idx}_{old_id}"
            grp = out.create_group(new_id)
            for key in f[old_id].keys():
                grp[key] = f[old_id][key][()]
            id_out.write(new_id + "\n")
            count += 1
        f.close()
        log.info("merged %s (%d ids so far)", shard, count)

    info = out.create_group("data_info")
    for key, v in meta.items():
        info[key] = v
    out.close()
    id_out.close()
    log.info("merged %d shards -> %s (%d examples)", len(shard_dirs),
             out_dir, count)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("shards", nargs="+")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    merge(args.shards, args.out_dir)


if __name__ == "__main__":
    main()
