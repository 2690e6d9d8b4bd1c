"""Pre-build the doom device-cache disk sidecar on CPU only.

The device-cache build (train/device_cache.py) reads every item of the
dataset store before the first training step can run. This script does that
read pass ahead of time on the CPU — no accelerator work, safe to run while
the accelerator trains on another dataset — so the next trainer launch
mmap-loads the packed .npy sidecar.

Usage: python scripts/build_doom_cache_sidecar.py <dataset_path> [num_k]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from demo2program_tpu.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu.train.device_cache import DoomDeviceCache


def main():
    path = sys.argv[1]
    num_k = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    train, _, _ = create_vizdoom_splits(path, num_k=num_k)
    dc = DoomDeviceCache.__new__(DoomDeviceCache)  # build/load only, no push
    arrays = dc._load_or_build(train, include_test_actions=True)
    total = sum(v.nbytes for v in arrays.values())
    print(f"sidecar ready: {len(arrays)} arrays, {total/1e9:.2f} GB")


if __name__ == "__main__":
    main()
