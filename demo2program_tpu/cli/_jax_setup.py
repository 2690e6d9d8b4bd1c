"""Common JAX runtime setup for CLI entry points.

The CLIs run on whatever backend JAX selects (set `JAX_PLATFORMS` to choose
one) and log it at start. The persistent compilation cache lives in
`JAX_COMPILATION_CACHE_DIR` when that is set, and otherwise in `.jax_cache/`
at the root of the checkout.
"""

import os
import os.path as osp

import jax

from demo2program_tpu.utils import log

REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DEFAULT_CACHE_DIR = osp.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir():
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup():
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    dev = jax.devices()[0]
    log.info("JAX %s backend=%s device_kind=%r count=%d", jax.__version__,
             jax.default_backend(), dev.device_kind, jax.device_count())
