"""Dataset reader with reference-loader parity (data/store.py: `data.npz`,
or a reference `data.hdf5`).

Parity target: `karel_env/dataset_karel.py` (the ViZDoom variant adds
init-pos tensors, handled by the vizdoom subclass later). Every padding /
one-hot convention below is load-bearing for metric parity:

  * program one-hot: [num_program_tokens, max_program_len] bool
    (`dataset_karel.py:45-46`)
  * action one-hot: [max_demo_len, num_action_tokens+1]; the <e> end token
    occupies index num_action_tokens (`:66-77`).
    QUIRK (replicated): the reference marks actual tokens AND the zero
    padding of the per-program a_h matrix (which argmax-decodes to action 0
    'move'), then puts <e> at row `a_h.shape[1]` — the per-PROGRAM max
    action length — for every demo, not at each demo's own length
    (`:69-76`: `len(a_h_tokens)` is the padded row length). Demos shorter
    than their program's longest demo are therefore supervised with 'move'
    padding inside the loss mask. We reproduce this exactly.
  * demo_len is the state-history length (actions + 1); the action decoders
    use it as their sequence length too (`model_full.py:173`)
  * num_k slices the leading demo axis of seen-demo tensors only (`:111-115`)

Split membership: id.txt order → first num_train / next num_test / next
num_val, each shuffled by a fixed RandomState(123) (`dataset_karel.py:11,
143-160`) so runs are comparable with the reference.
"""

import json
import os
import os.path as osp
import time

import numpy as np

from demo2program_tpu.data.store import data_file, open_store
from demo2program_tpu.utils import log

_SPLIT_RNG_SEED = 123


def _scalar(ds):
    v = ds[()]
    if isinstance(v, bytes):
        return v.decode()
    return v


_PRELOAD_LIMIT_BYTES = int(os.environ.get(
    "D2P_PRELOAD_LIMIT_BYTES", 3 * 1024 ** 3))
_PRELOAD_CACHE = {}

_COMPACT_CACHE_NAME = "compact_cache_v1.npz"
_COMPACT_STORES = {}


def _store_fingerprint(store):
    """(size, mtime_ns) of the backing store file — cheap identity for
    sidecar staleness checks."""
    st = os.stat(store.filename)
    return np.array([st.st_size, st.st_mtime_ns], np.int64)


class _CompactStore:
    """File-level store of the compact wire arrays for every item, packed as
    a few large numpy arrays so batch assembly is vectorized fancy-indexing
    instead of 32 python-level item loads. Built once per dataset into a
    sidecar `compact_cache_v1.npz` (initial frames + action rows only), then
    loads take seconds."""

    def __init__(self, dataset_path, store, max_demo_len):
        path = osp.join(dataset_path, _COMPACT_CACHE_NAME)
        # staleness guard: the sidecar records the data file's (size,
        # mtime_ns); a regenerated/extended dataset invalidates the cache
        # instead of silently serving stale demos
        self._fp = _store_fingerprint(store)
        if osp.exists(path):
            z = np.load(path, allow_pickle=False)
            if ("h5_fingerprint" in z.files
                    and np.array_equal(z["h5_fingerprint"], self._fp)):
                self.arr = {k: z[k] for k in z.files}
                self.index = {id_: i
                              for i, id_ in enumerate(self.arr["ids"])}
                return
            log.warn("compact cache %s is stale (data file changed); "
                     "rebuilding", path)
        self._build(path, store, max_demo_len)

    @staticmethod
    def _compact_of(grp, max_demo_len):
        out = {}
        for pfx, s_key, a_key in (("", "s_h", "a_h"),
                                  ("test_", "test_s_h", "test_a_h")):
            first = grp[s_key][:, :1][:, 0]       # (n, h, w, 16)
            n, h, w, _ = first.shape
            out[pfx + "wall"] = first[:, :, :, 4].astype(np.uint8)
            out[pfx + "marker"] = np.argmax(
                first[:, :, :, 5:], axis=-1).astype(np.uint8)
            flat = np.argmax(first[:, :, :, :4].reshape(n, h * w * 4),
                             axis=-1)
            out[pfx + "agent"] = np.stack(
                [flat // (w * 4), (flat // 4) % w, flat % 4],
                axis=1).astype(np.uint8)
            a_rows = grp[a_key][()]
            a_raw = np.zeros((n, max_demo_len), np.int8)
            a_raw[:, :a_rows.shape[1]] = a_rows
            out[pfx + "a_raw"] = a_raw
            out[pfx + "a_row_len"] = np.int32(a_rows.shape[1])
            out[pfx + "demo_len"] = grp[
                ("test_s_h_len" if pfx else "s_h_len")][()].astype(np.int16)
        return out

    def _build(self, path, store, max_demo_len):
        log.info("building compact cache %s ...", path)
        t0 = time.time()
        ids = [k for k in store.keys() if k != "data_info"]
        Lmax = max(store[i]["program"].shape[0] for i in ids)
        cols = {k: [] for k in (
            "program", "program_len", "wall", "marker", "agent", "a_raw",
            "a_row_len", "demo_len", "test_wall", "test_marker",
            "test_agent", "test_a_raw", "test_a_row_len", "test_demo_len")}
        for id_ in ids:
            grp = store[id_]
            prog = grp["program"][()]
            padded = np.zeros(Lmax, np.int32)
            padded[:len(prog)] = prog
            cols["program"].append(padded)
            cols["program_len"].append(np.int32(len(prog)))
            for k, v in self._compact_of(grp, max_demo_len).items():
                cols[k].append(v)
        arrs = {k: np.stack(v) for k, v in cols.items()}
        arrs["ids"] = np.array(ids)
        arrs["h5_fingerprint"] = self._fp
        try:
            np.savez(path, **arrs)
            log.info("compact cache built in %.1f s (%d items)",
                     time.time() - t0, len(ids))
        except OSError:
            log.warn("compact cache not writable; keeping in memory only")
        self.arr = arrs
        self.index = {id_: i for i, id_ in enumerate(ids)}

    def __contains__(self, id_):
        return id_ in self.index


class _PreloadedFile:
    """Materializes every group's arrays into numpy once; per-read overhead
    of the store dominates the input pipeline, so datasets under the preload
    limit are served straight from RAM."""

    def __init__(self, store, ids):
        self._groups = {}
        for id_ in ids:
            g = store[id_]
            self._groups[id_] = {k: g[k][()] for k in g.keys()}

    def __getitem__(self, id_):
        return self._groups[id_]

    def __contains__(self, id_):
        return id_ in self._groups


class KarelDataset:
    def __init__(self, ids, dataset_path, name="default", num_k=10,
                 is_train=True):
        self._ids = list(ids)
        self.name = name
        self.num_k = num_k
        self.is_train = is_train
        self.dataset_path = dataset_path

        filename = data_file(dataset_path)
        log.info("Reading %s ...", filename)
        self.data = open_store(filename)
        info = self.data["data_info"]
        self.dsl_type = _scalar(info["dsl_type"])
        self.num_demo = int(_scalar(info["num_demo_per_program"]))
        self.max_demo_len = int(_scalar(info["max_demo_length"]))
        self.max_program_len = int(_scalar(info["max_program_length"]))
        self.num_program_tokens = int(_scalar(info["num_program_tokens"]))
        self.num_action_tokens = int(_scalar(info["num_action_tokens"]))
        self.env_type = (_scalar(info["env_type"])
                         if "env_type" in info else None)
        self._store = self._maybe_preload(filename)

    def _maybe_preload(self, filename):
        fsize = os.path.getsize(filename)
        if fsize > _PRELOAD_LIMIT_BYTES:
            return self.data
        # one preload per FILE, shared by the train/test/val split objects
        # (create_default_splits constructs three datasets over one file)
        key = os.path.abspath(filename)
        if key not in _PRELOAD_CACHE:
            log.info("preloading %s (%.0f MB) into memory", filename,
                     fsize / 1e6)
            t0 = time.time()
            ids = [k for k in self.data.keys() if k != "data_info"]
            _PRELOAD_CACHE[key] = _PreloadedFile(self.data, ids)
            log.info("preloaded %d groups in %.1f s", len(ids),
                     time.time() - t0)
        return _PRELOAD_CACHE[key]

    # -- single-example load --------------------------------------------------
    def _action_onehots(self, a_h_rows):
        """Reference-exact action one-hot construction incl. the padded-'move'
        + fixed <e> position quirk (`dataset_karel.py:66-94`)."""
        out = []
        row_len = a_h_rows.shape[1]
        for row in a_h_rows:
            oh = np.zeros([self.max_demo_len, self.num_action_tokens + 1],
                          dtype=bool)
            oh[np.arange(row_len), row] = True
            oh[row_len, self.num_action_tokens] = True  # <e>
            out.append(oh)
        onehot = np.stack(out, axis=0)
        tokens = np.argmax(onehot, axis=2)
        return onehot, tokens

    def get_data(self, id_):
        grp = self._store[id_]
        program_tokens = grp["program"][()]
        program = np.zeros(
            [self.num_program_tokens, self.max_program_len], dtype=bool)
        program[program_tokens, np.arange(len(program_tokens))] = True
        padded_program_tokens = np.zeros(
            [self.max_program_len], dtype=program_tokens.dtype)
        padded_program_tokens[:len(program_tokens)] = program_tokens

        def pad_demo(arr):
            sz = arr.shape
            out = np.zeros([sz[0], self.max_demo_len] + list(sz[2:]),
                           dtype=arr.dtype)
            out[:, :sz[1]] = arr
            return out

        demo = pad_demo(grp["s_h"][()])
        test_demo = pad_demo(grp["test_s_h"][()])

        per_key = "p_v_h" if "p_v_h" in grp else "per"
        test_per_key = "test_p_v_h" if "test_p_v_h" in grp else "test_per"
        per = pad_demo(grp[per_key][()])
        test_per = pad_demo(grp[test_per_key][()])

        a_h, a_h_tokens = self._action_onehots(grp["a_h"][()])
        test_a_h, test_a_h_tokens = self._action_onehots(grp["test_a_h"][()])

        program_len = np.array([len(program_tokens)], dtype=np.float32)
        demo_len = grp["s_h_len"][()]
        test_demo_len = grp["test_s_h_len"][()]

        k = self.num_k
        return {
            "id": id_,
            # one-hot/bool tensors travel host->device as uint8 and are cast
            # to float on device (a quarter of the reference's float32 bytes)
            "program": program.astype(np.uint8),
            "program_tokens": padded_program_tokens.astype(np.int32),
            "s_h": demo[:k].astype(np.uint8),
            "test_s_h": test_demo.astype(np.uint8),
            "a_h": a_h[:k].astype(np.uint8),
            "a_h_tokens": a_h_tokens[:k].astype(np.int32),
            "test_a_h": test_a_h.astype(np.uint8),
            "test_a_h_tokens": test_a_h_tokens.astype(np.int32),
            "program_len": program_len.astype(np.float32),
            "demo_len": demo_len[:k].astype(np.float32),
            "test_demo_len": test_demo_len.astype(np.float32),
            "per": per[:k].astype(np.uint8),
            "test_per": test_per.astype(np.uint8),
        }

    # -- compact wire format ---------------------------------------------------
    @property
    def compact_store(self):
        """Lazy file-level _CompactStore shared by all splits."""
        key = osp.abspath(self.data.filename)
        if key not in _COMPACT_STORES:
            _COMPACT_STORES[key] = _CompactStore(
                self.dataset_path, self.data, self.max_demo_len)
        return _COMPACT_STORES[key]

    def get_batch_compact(self, id_list):
        """Compact wire-format batch: token ids + initial states + raw
        action rows only; full tensors are rebuilt on device inside the
        jitted step (ops/reconstruct.py). Assembled by vectorized
        fancy-indexing of the sidecar compact cache — no per-item python
        work. Bit-identical to stacked get_data items after expansion
        (tests/test_reconstruct.py)."""
        cs = self.compact_store
        a = cs.arr
        idx = np.fromiter((cs.index[i] for i in id_list), np.int64,
                          count=len(id_list))
        k = self.num_k
        L = self.max_program_len
        return {
            "id": np.asarray(id_list),
            "program_tokens": a["program"][idx][:, :L],
            "program_len": a["program_len"][idx][:, None].astype(np.float32),
            "demo_len": a["demo_len"][idx][:, :k].astype(np.float32),
            "test_demo_len": a["test_demo_len"][idx].astype(np.float32),
            "c_wall": a["wall"][idx][:, :k],
            "c_marker": a["marker"][idx][:, :k],
            "c_agent": a["agent"][idx][:, :k],
            "c_a_raw": a["a_raw"][idx][:, :k],
            "c_a_row_len": a["a_row_len"][idx][:, None],
            "test_c_wall": a["test_wall"][idx],
            "test_c_marker": a["test_marker"][idx],
            "test_c_agent": a["test_agent"][idx],
            "test_c_a_raw": a["test_a_raw"][idx],
            "test_c_a_row_len": a["test_a_row_len"][idx][:, None],
        }

    def get_data_compact(self, id_):
        """Single compact item (tests / tools); batches use
        get_batch_compact."""
        batch = self.get_batch_compact([id_])
        return {k: (v[0] if k != "id" else id_) for k, v in batch.items()}

    @property
    def ids(self):
        return self._ids

    def __len__(self):
        return len(self._ids)

    def __repr__(self):
        return f"KarelDataset ({self.name}, {len(self)} examples)"


def check_data_id(dataset, data_id):
    """Validate that requested ids exist in the dataset
    (`input_ops_karel.py:7-21`)."""
    if not data_id:
        return
    wrong = [i for i in data_id if i not in dataset.data]
    if wrong:
        raise RuntimeError("There are %d invalid ids, including %s" % (
            len(wrong), wrong[:5]))


def all_ids(dataset_path, rng_seed=_SPLIT_RNG_SEED):
    with open_store(data_file(dataset_path)) as f:
        num_train = int(_scalar(f["data_info"]["num_train"]))
        num_test = int(_scalar(f["data_info"]["num_test"]))
        num_val = int(_scalar(f["data_info"]["num_val"]))
    # Optional per-directory override: a `splits.json` with
    # {"num_train", "num_test", "num_val"} re-partitions id.txt without
    # touching the data file. Lets a "subset view" dir (symlinked data file
    # + reordered id.txt) train on fewer programs while keeping the original
    # held-out test ids — used to trade train-split size against num_k
    # under the device-cache budget (train/device_cache.py).
    sp = osp.join(dataset_path, "splits.json")
    if osp.exists(sp):
        ov = json.load(open(sp))
        num_train = int(ov.get("num_train", num_train))
        num_test = int(ov.get("num_test", num_test))
        num_val = int(ov.get("num_val", num_val))
    with open(osp.join(dataset_path, "id.txt")) as fp:
        ids_total = [s.strip() for s in fp.readlines() if s.strip()]

    ids_train = ids_total[:num_train]
    ids_test = ids_total[num_train:num_train + num_test]
    ids_val = ids_total[num_train + num_test:num_train + num_test + num_val]

    # fixed-seed shuffles, in the reference's call order
    # (`dataset_karel.py:156-158` sharing one RandomState(123))
    rs = np.random.RandomState(rng_seed)
    rs.shuffle(ids_train)
    rs.shuffle(ids_test)
    rs.shuffle(ids_val)
    return ids_train, ids_test, ids_val


def create_default_splits(dataset_path, num_k=10, is_train=True,
                          dataset_cls=None):
    cls = dataset_cls or KarelDataset
    ids_train, ids_test, ids_val = all_ids(dataset_path)
    return (cls(ids_train, dataset_path, "train", num_k, is_train),
            cls(ids_test, dataset_path, "test", num_k, is_train),
            cls(ids_val, dataset_path, "val", num_k, is_train))
