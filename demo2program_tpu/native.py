"""ctypes bindings for the native batch Karel engine (native/karel_engine.cpp).

The shared library is compiled on demand with g++ (cached next to the
source); `available()` reports whether a toolchain/library is usable, and
callers fall back to the pure-Python interpreter when it is not.

`run_batch` executes bytecode from dsl/karel_bytecode.py — identical
instruction semantics to the host interpreter and the on-device VM,
property-tested in tests/test_native.py.
"""

import ctypes
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "karel_engine.cpp")
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libkarel.so")

_lib = None
_load_error = None


def _build():
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _LIB_PATH, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.karel_run_batch.restype = ctypes.c_int
        lib.karel_run_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ]
        _lib = lib
    except Exception as e:  # toolchain missing etc.
        _load_error = e
    return _lib


def available():
    return _load() is not None


def run_batch(bytecode, walls, markers0, agent0, prog_idx,
              make_error=True, max_record=32):
    """Execute a batch of rollouts.

    bytecode: (n_progs, L, 2) int32; walls: (n, h, w) bool;
    markers0: (n, h, w) int; agent0: (n, 3) int (y, x, d);
    prog_idx: (n,) int mapping rollout -> program.

    Returns dict(success (n,), length (n,), n (n,), actions (n, max_record-1),
    agent (n, max_record, 3), markers (n, max_record, h, w)).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_load_error}")
    bytecode = np.ascontiguousarray(bytecode, np.int32)
    walls = np.ascontiguousarray(walls, np.uint8)
    markers0 = np.ascontiguousarray(markers0, np.int8)
    agent0 = np.ascontiguousarray(agent0, np.int32)
    prog_idx = np.ascontiguousarray(prog_idx, np.int32)
    n_progs, code_len = bytecode.shape[0], bytecode.shape[1]
    n, h, w = walls.shape

    success = np.zeros(n, np.uint8)
    length = np.zeros(n, np.int32)
    n_budget = np.zeros(n, np.int32)
    actions = np.zeros((n, max_record - 1), np.int8)
    agent = np.zeros((n, max_record, 3), np.int32)
    markers = np.zeros((n, max_record, h, w), np.int8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.karel_run_batch(
        ptr(bytecode, ctypes.c_int32), n_progs, code_len,
        ptr(walls, ctypes.c_uint8), ptr(markers0, ctypes.c_int8),
        ptr(agent0, ctypes.c_int32), ptr(prog_idx, ctypes.c_int32),
        n, h, w, int(make_error), max_record,
        ptr(success, ctypes.c_uint8), ptr(length, ctypes.c_int32),
        ptr(n_budget, ctypes.c_int32), ptr(actions, ctypes.c_int8),
        ptr(agent, ctypes.c_int32), ptr(markers, ctypes.c_int8))
    if rc != 0:
        raise RuntimeError(f"karel_run_batch failed with rc={rc}")
    return {"success": success.astype(bool), "length": length,
            "n": n_budget, "actions": actions, "agent": agent,
            "markers": markers}
