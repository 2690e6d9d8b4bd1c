"""Device mesh + sharding rules.

The reference is strictly single-GPU (`trainer.py:134-138` pins
device_count={'GPU': 1}; no tf.distribute anywhere — SURVEY.md §2.6). The
parallelism is therefore a new design, not a port:

  * one mesh axis 'data': the batch is sharded across all devices;
    parameters and optimizer state are replicated. jit inserts the gradient
    all-reduce from the sharding annotations.
  * the k demos per task are an internal batch axis, folded into the leading
    dim inside the models (models/encoder.py) — they shard with the batch.
  * TP/PP/EP are deliberately out of scope: the largest model is ~30M params
    with sequence lengths <= 50; there is nothing to partition (documented
    rather than silently missing, SURVEY.md §2.6).

Multi-chip behaviour is validated on a virtual CPU mesh
(tests + __graft_entry__.dryrun_multichip).
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices=None, axis_name="data"):
    devices = jax.devices()
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devices)} JAX devices are visible "
                f"(platform={devices[0].platform}); for CPU testing set "
                f"JAX_PLATFORMS=cpu and "
                f"XLA_FLAGS=--xla_force_host_platform_device_count=N")
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis_name,))


def batch_sharding(mesh, axis_name="data"):
    """Leading-axis (batch) sharding for input pytrees."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh, axis_name="data"):
    """device_put a host batch dict with the batch axis sharded."""
    sh = batch_sharding(mesh, axis_name)
    return {k: (jax.device_put(v, sh) if k != "id" else v)
            for k, v in batch.items()}


def make_mesh_2d(dp, demo_par, axis_names=("data", "demo")):
    """2D mesh: batch sharded over `data`, the k seen demos additionally
    sharded over `demo` — the demo axis is an internal batch axis
    (SURVEY.md §2.6), so at large k (ViZDoom k=40) it gives a second
    parallelism dimension without any model partitioning."""
    devices = jax.devices()
    if len(devices) < dp * demo_par:
        raise ValueError(f"need {dp * demo_par} devices, have {len(devices)}")
    arr = np.array(devices[:dp * demo_par]).reshape(dp, demo_par)
    return Mesh(arr, axis_names)


# seen-demo tensors carry (bs, k, ...) and shard on both axes; everything
# else shards on the batch axis only. Includes the compact wire-format keys
# (ops/reconstruct.py) so replay/expansion also runs demo-sharded.
_DEMO_AXIS_KEYS = ("s_h", "a_h", "a_h_tokens", "per", "demo_len",
                   "init_pos", "init_pos_len",
                   "c_wall", "c_marker", "c_agent", "c_a_raw")


def shard_batch_2d(batch, mesh):
    out = {}
    for k, v in batch.items():
        if k == "id":
            out[k] = v
        elif k in _DEMO_AXIS_KEYS:
            out[k] = jax.device_put(
                v, NamedSharding(mesh, P("data", "demo")))
        else:
            out[k] = jax.device_put(v, NamedSharding(mesh, P("data")))
    return out
