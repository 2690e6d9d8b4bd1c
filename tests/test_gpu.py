"""Checks that need an NVIDIA GPU. They skip on the CPU; `python
chip_smoke.py` runs the same checks on the card at the reference width."""

import numpy as np
import pytest

import chip_smoke
from tests.test_data import tiny_dataset_dir  # noqa: F401 (fixture)

pytestmark = pytest.mark.gpu


def test_train_step_gpu_matches_cpu(gpu_device, tiny_dataset_dir):  # noqa: F811
    import types

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.train.trainer import config_from_dataset

    ds, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = types.SimpleNamespace(
        model="full", dataset_type="karel", batch_size=4,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=20000)
    cfg = config_from_dataset(args, ds)
    batch = ds.get_batch_compact(ds.ids[:4])
    del batch["id"]
    rel, _ = chip_smoke.compare_train_step(gpu_device, cfg, batch)
    assert max(rel["highest"]) <= chip_smoke.NUMERICS_RTOL, rel


def test_vm_matches_host_interpreter_on_gpu(gpu_device, tiny_dataset_dir):  # noqa: F811
    import types

    import jax

    from demo2program_tpu.data.dataset import create_default_splits
    from demo2program_tpu.data.store import data_file, open_store
    from demo2program_tpu.dsl.karel_vocab import KarelVocab
    from demo2program_tpu.train.trainer import config_from_dataset

    ds, _, _ = create_default_splits(tiny_dataset_dir, num_k=3)
    args = types.SimpleNamespace(
        model="full", dataset_type="karel", batch_size=4,
        num_lstm_cell_units=32, demo_aggregation="avgpool",
        scheduled_sampling=False, scheduled_sampling_decay_steps=20000)
    cfg = config_from_dataset(args, ds)
    vocab = KarelVocab()
    rng = np.random.RandomState(0)
    ids = list(ds.ids)
    with open_store(data_file(tiny_dataset_dir)) as store, \
            jax.default_device(gpu_device):
        gt = [vocab.intseq2str(store[i]["program"][()]) for i in ids]
        for programs in (gt, [chip_smoke.perturbed(p, rng) for p in gt]):
            np.testing.assert_array_equal(
                chip_smoke.scorer_verdicts(cfg, ds, ids, programs),
                chip_smoke.host_verdicts(cfg, store, ids, programs))
