"""Native C++ engine vs host interpreter equivalence."""

import numpy as np
import pytest

from demo2program_tpu import native
from demo2program_tpu.dsl import karel_interp, karel_parser
from demo2program_tpu.dsl.karel_bytecode import compile_ast
from demo2program_tpu.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu.dsl.karel_vocab import KarelVocab, ENV_ACTION_TO_TOKEN
from demo2program_tpu.envs import KarelWorld, KarelStateGenerator

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native engine")


def _decode(s):
    ys, xs, ds = np.where(s[:, :, :4])
    markers = np.argmax(s[:, :, 5:], axis=-1).astype(np.int8)
    return int(ys[0]), int(xs[0]), int(ds[0]), markers


def test_native_matches_host_on_random_programs():
    sampler = KarelProgramSampler(seed=17)
    sgen = KarelStateGenerator(seed=17)
    cases = []
    while len(cases) < 96:
        code = sampler.random_code()
        ast, ok = karel_parser.parse(code)
        try:
            bc = compile_ast(ast)
        except Exception:
            continue
        s0, *_ = sgen.generate_single_state()
        cases.append((code, ast, bc, s0))

    n = len(cases)
    codes = np.stack([c[2] for c in cases])
    walls = np.stack([c[3][:, :, 4] for c in cases])
    markers0 = np.zeros((n, 8, 8), np.int8)
    agent0 = np.zeros((n, 3), np.int32)
    for i, (_, _, _, s0) in enumerate(cases):
        y, x, d, m = _decode(s0)
        agent0[i] = (y, x, d)
        markers0[i] = m
    out = native.run_batch(codes, walls, markers0, agent0,
                           np.arange(n), make_error=True, max_record=32)

    for i, (code, ast, _, s0) in enumerate(cases):
        world = KarelWorld(s0.copy(), make_error=True)
        hn, hs = karel_interp.execute(ast, world)
        assert out["success"][i] == hs, code
        assert out["n"][i] == hn, code
        if hs:
            assert out["length"][i] == len(world.s_h), code
            L = min(len(world.s_h), 32)
            # action trace
            assert (out["actions"][i, :L - 1]
                    == np.array(world.a_h[:L - 1], np.int8)).all(), code
            # full state trace (pose + markers)
            for t in range(L):
                y, x, d, m = _decode(world.s_h[t])
                assert tuple(out["agent"][i, t]) == (y, x, d), (code, t)
                assert (out["markers"][i, t] == m).all(), (code, t)


def test_native_no_error_mode():
    vocab = KarelVocab()
    code = "DEF run m( move move m)"
    ast, _ = karel_parser.parse(code)
    bc = compile_ast(ast)[None]
    # agent facing the north wall at row 1
    wall = np.zeros((1, 8, 8), np.uint8)
    wall[0, 0, :] = wall[0, 7, :] = wall[0, :, 0] = wall[0, :, 7] = 1
    agent0 = np.array([[1, 4, 0]], np.int32)
    markers0 = np.zeros((1, 8, 8), np.int8)
    out = native.run_batch(bc, wall, markers0, agent0, np.zeros(1, int),
                           make_error=False)
    assert out["success"][0]
    assert out["length"][0] == 3
    # first move blocked -> 180 turn to south; second move walks south
    assert tuple(out["agent"][0, 1]) == (1, 4, 2)
    assert tuple(out["agent"][0, 2]) == (2, 4, 2)


def test_generator_backends_produce_identical_datasets(tmp_path):
    from demo2program_tpu.data.store import data_file, open_store
    from demo2program_tpu.data.karel_generator import (
        GeneratorConfig, generate)

    dirs = {}
    for backend in ("python", "native"):
        d = str(tmp_path / backend)
        cfg = GeneratorConfig(
            dir_name=d, num_train=4, num_test=2, num_val=2,
            num_demo_per_program=3, num_test_demo_per_program=2,
            min_demo_length=4, max_demo_length=12, seed=99)
        generate(cfg, progress_every=0, backend=backend)
        dirs[backend] = d

    ids = open(f"{dirs['python']}/id.txt").read()
    assert ids == open(f"{dirs['native']}/id.txt").read()
    with open_store(data_file(dirs["python"])) as fp, \
            open_store(data_file(dirs["native"])) as fn:
        for id_ in [k for k in fp.keys() if k != "data_info"]:
            for key in fp[id_]:
                a, b = fp[id_][key][()], fn[id_][key][()]
                assert np.array_equal(a, b), (id_, key)


def test_native_throughput_sanity():
    """The engine must execute a few thousand rollouts quickly (smoke, not a
    benchmark)."""
    import time
    sampler = KarelProgramSampler(seed=3)
    sgen = KarelStateGenerator(seed=3)
    code = "DEF run m( WHILE c( frontIsClear c) w( move w) turnLeft m)"
    ast, _ = karel_parser.parse(code)
    bc = compile_ast(ast)[None]
    n = 5000
    walls = np.zeros((n, 8, 8), np.uint8)
    walls[:, 0, :] = walls[:, 7, :] = walls[:, :, 0] = walls[:, :, 7] = 1
    agent0 = np.tile(np.array([[4, 1, 1]], np.int32), (n, 1))
    markers0 = np.zeros((n, 8, 8), np.int8)
    t0 = time.perf_counter()
    out = native.run_batch(bc, walls, markers0, agent0,
                           np.zeros(n, int))
    dt = time.perf_counter() - t0
    assert out["success"].all()
    # generous bound: the suite may share the host with a training run
    assert dt < 10.0, f"native engine too slow: {dt:.3f}s for {n} rollouts"
