"""Karel dataset generator — writes the reference's dataset schema in ONE
pass, into `data.npz` (data/store.py).

The reference builds its dataset in three sequential scripts
(`karel_env/generator.py` → `append_demonstration.py` → `add_per.py`); we
produce the identical on-disk schema in a single pass so reference datasets
drop into our loader and vice versa:

  <id>/program        int8   [prog_len]          token ids
  <id>/s_h            bool   [N, Tmax_prog, h, w, 16]
  <id>/s_h_len        int16  [N]
  <id>/a_h            int8   [N, Tmax_prog-1]
  <id>/a_h_len        int16  [N]
  <id>/test_*         same, for unseen test demos
  <id>/per            bool   [N, Tmax_prog, 5]   perception vectors
  <id>/test_per       bool
  data_info/{max_demo_length, dsl_type, max_program_length,
             num_program_tokens, num_demo_per_program, num_action_tokens,
             num_train, num_test, num_val, num_test_demo_per_program}

ids follow the reference format 'no_{i}_prog_len_{L}_max_s_h_len_{T}'
(`generator.py:129-130`) and id.txt ordering defines the train/test/val
split (`dataset_karel.py:143-160`).

Acceptance rules mirror the reference (`generator.py:76-143`): unique
programs only, token length <= max_program_length, >= num_demo_per_program
demos of length in [min_demo_length, max_demo_length] within
max_demo_generation_trial attempts.

Known deliberate divergence: the reference's *generation-time* executor uses
a PLY-closure interpreter with post-order call counting
(`dsl_base.py:37-47`), subtly different from the eval-time dsl_parse budget.
We use the single exact dsl_parse-semantics interpreter everywhere; both cut
off runaway programs around 100 calls, and since accepted demos must have
<= 20 states the acceptance sets differ only on pathological programs.
"""

import os
from dataclasses import dataclass, field

import numpy as np

from demo2program_tpu.envs import KarelWorld, KarelStateGenerator
from demo2program_tpu.envs.karel import batch_to_states
from demo2program_tpu.dsl import karel_interp, karel_parser
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu.data.store import NpzWriter
from demo2program_tpu.utils import log


@dataclass
class GeneratorConfig:
    dir_name: str = "datasets/karel_dataset"
    height: int = 8
    width: int = 8
    num_train: int = 25000
    num_test: int = 5000
    num_val: int = 5000
    wall_prob: float = 0.1
    seed: int = 123
    max_program_length: int = 50
    max_program_stmt_depth: int = 6
    max_program_nesting_depth: int = 4
    min_max_demo_length_for_program: int = 2
    min_demo_length: int = 8
    max_demo_length: int = 20
    num_demo_per_program: int = 10
    num_test_demo_per_program: int = 5
    max_demo_generation_trial: int = 100
    max_test_demo_generation_trial: int = 10000


_TRIAL_CHUNK = 64

# facing deltas for trace-side perception reconstruction (karel.py:66-91)
_DELTAS = {
    "front": np.array([[-1, 0], [0, 1], [1, 0], [0, -1]]),
    "left": np.array([[0, -1], [-1, 0], [0, 1], [1, 0]]),
    "right": np.array([[0, 1], [1, 0], [0, -1], [-1, 0]]),
}


def _clear(wall, y, x, d, which, h, w):
    dy, dx = _DELTAS[which][d]
    ny, nx = y + dy, x + dx
    if ny < 0 or ny >= h or nx < 0 or nx >= w:
        return False
    return not wall[ny, nx]


def _trace_to_arrays(wall, agent, markers, length, h, w):
    """Native-engine trace -> (s_h (L,h,w,16) bool, per (L,5) bool)."""
    L = int(length)
    s = np.zeros((L, h, w, 16), bool)
    s[:, :, :, 4] = wall
    s[:, :, :, 5:] = np.eye(11, dtype=bool)[markers[:L]]
    per = np.zeros((L, 5), bool)
    for t in range(L):
        y, x, d = agent[t]
        s[t, y, x, d] = True
        mk = markers[t, y, x] > 0
        per[t] = [_clear(wall, y, x, d, "front", h, w),
                  _clear(wall, y, x, d, "left", h, w),
                  _clear(wall, y, x, d, "right", h, w),
                  mk, not mk]
    return s, per


def _roll_demos(ast, sgen, cfg, num_needed, max_trials, bytecode=None,
                use_native=False):
    """Sample initial states and execute `ast`, keeping demos whose state
    history length lies in [min_demo_length, max_demo_length].

    States are sampled in fixed chunks so the accepted-demo set is identical
    for the python and native backends (both consume the same rng stream)."""
    s_h_list, a_h_list, per_list = [], [], []
    trials = 0
    h, w = cfg.height, cfg.width
    while len(s_h_list) < num_needed and trials < max_trials:
        chunk = min(_TRIAL_CHUNK, max_trials - trials)
        trials += chunk
        walls, markers0, agent0 = sgen.generate_batch(
            chunk, h, w, cfg.wall_prob)
        if use_native:
            from demo2program_tpu import native
            out = native.run_batch(
                bytecode[None], walls, markers0, agent0,
                np.zeros(chunk, np.int32), make_error=True,
                max_record=cfg.max_demo_length)
            for i in range(chunk):
                if len(s_h_list) >= num_needed:
                    break
                if not out["success"][i]:
                    continue
                L = int(out["length"][i])
                if not (cfg.min_demo_length <= L <= cfg.max_demo_length):
                    continue
                s_h, per = _trace_to_arrays(
                    walls[i], out["agent"][i], out["markers"][i], L, h, w)
                s_h_list.append(s_h)
                a_h_list.append(out["actions"][i, :L - 1].copy())
                per_list.append(per)
        else:
            for s0 in batch_to_states(walls, markers0, agent0):
                if len(s_h_list) >= num_needed:
                    break
                world = KarelWorld(s0, make_error=True)
                _, success = karel_interp.execute(ast, world)
                if not success:
                    continue
                if not (cfg.min_demo_length <= len(world.s_h)
                        <= cfg.max_demo_length):
                    continue
                s_h_list.append(np.stack(world.s_h, axis=0))
                a_h_list.append(np.array(world.a_h, dtype=np.int8))
                per_list.append(np.stack(world.p_v_h, axis=0))
    return s_h_list, a_h_list, per_list


def _pad_stack(arrs, dtype):
    """Stack variable-length [T, ...] arrays padded to the max T."""
    n = len(arrs)
    tmax = max(a.shape[0] for a in arrs)
    out = np.zeros((n, tmax) + arrs[0].shape[1:], dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out


def generate(cfg: GeneratorConfig, progress_every=500, backend="auto"):
    """backend: 'auto' (native C++ engine when buildable), 'native',
    'python'. Both backends produce identical datasets for a given seed."""
    os.makedirs(cfg.dir_name, exist_ok=True)
    num_total = cfg.num_train + cfg.num_test + cfg.num_val

    if backend == "auto":
        from demo2program_tpu import native
        use_native = native.available()
    elif backend == "native":
        use_native = True
    else:
        use_native = False
    if use_native:
        log.info("karel generator: using the native C++ engine")

    vocab = KarelVocab()
    sampler = KarelProgramSampler(seed=cfg.seed)
    sgen = KarelStateGenerator(seed=cfg.seed)

    f = NpzWriter(os.path.join(cfg.dir_name, "data.npz"))
    id_file = open(os.path.join(cfg.dir_name, "id.txt"), "w")

    count = 0
    max_demo_len_seen = -1
    max_prog_len_seen = -1
    seen_programs = set()
    while count < num_total:
        code = sampler.random_code(
            max_depth=cfg.max_program_stmt_depth,
            max_nesting_depth=cfg.max_program_nesting_depth)
        if code in seen_programs:
            continue
        program_seq = np.array(vocab.str2intseq(code), dtype=np.int8)
        if program_seq.shape[0] > cfg.max_program_length:
            continue
        ast, ok = karel_parser.parse(code)
        assert ok, code
        bytecode = None
        if use_native:
            from demo2program_tpu.dsl.karel_bytecode import (
                BytecodeTooLong, compile_ast)
            try:
                bytecode = compile_ast(ast)
            except BytecodeTooLong:
                continue  # cannot roll demos for it either way

        s_h_list, a_h_list, per_list = _roll_demos(
            ast, sgen, cfg, cfg.num_demo_per_program,
            cfg.max_demo_generation_trial, bytecode, use_native)
        if len(s_h_list) < cfg.num_demo_per_program:
            continue
        len_s_h = np.array([s.shape[0] for s in s_h_list], dtype=np.int16)
        if len_s_h.max() < cfg.min_max_demo_length_for_program:
            continue

        # unseen test demos — no accept-rate gate, just a safety cap
        # (`append_demonstration.py:90-104` loops unboundedly)
        t_s_h, t_a_h, t_per = _roll_demos(
            ast, sgen, cfg, cfg.num_test_demo_per_program,
            cfg.max_test_demo_generation_trial, bytecode, use_native)
        if len(t_s_h) < cfg.num_test_demo_per_program:
            continue
        len_t_s_h = np.array([s.shape[0] for s in t_s_h], dtype=np.int16)

        seen_programs.add(code)
        id_ = "no_{}_prog_len_{}_max_s_h_len_{}".format(
            count, program_seq.shape[0], int(len_s_h.max()))
        id_file.write(id_ + "\n")
        grp = f.create_group(id_)
        grp["program"] = program_seq
        grp["s_h_len"] = len_s_h
        grp["a_h_len"] = np.array([a.shape[0] for a in a_h_list],
                                  dtype=np.int16)
        grp["s_h"] = _pad_stack(s_h_list, bool)
        grp["a_h"] = _pad_stack(a_h_list, np.int8)
        grp["per"] = _pad_stack(per_list, bool)
        grp["test_s_h_len"] = len_t_s_h
        grp["test_a_h_len"] = np.array([a.shape[0] for a in t_a_h],
                                       dtype=np.int16)
        grp["test_s_h"] = _pad_stack(t_s_h, bool)
        grp["test_a_h"] = _pad_stack(t_a_h, np.int8)
        grp["test_per"] = _pad_stack(t_per, bool)

        max_demo_len_seen = max(max_demo_len_seen,
                                int(len_s_h.max()), int(len_t_s_h.max()))
        max_prog_len_seen = max(max_prog_len_seen, program_seq.shape[0])
        count += 1
        if progress_every and count % progress_every == 0:
            log.info("generated %d / %d programs", count, num_total)

    info = f.create_group("data_info")
    info["max_demo_length"] = max_demo_len_seen
    info["dsl_type"] = "prob"
    info["max_program_length"] = max_prog_len_seen
    info["num_program_tokens"] = len(vocab.int2token)
    info["num_demo_per_program"] = cfg.num_demo_per_program
    info["num_test_demo_per_program"] = cfg.num_test_demo_per_program
    info["num_action_tokens"] = vocab.num_action_tokens
    info["num_train"] = cfg.num_train
    info["num_test"] = cfg.num_test
    info["num_val"] = cfg.num_val
    f.close()
    id_file.close()
    log.info("dataset generated under %s with %d samples (%d train / %d "
             "test / %d val)", cfg.dir_name, num_total, cfg.num_train,
             cfg.num_test, cfg.num_val)
