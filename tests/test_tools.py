"""Tool-suite tests: renderer, offline eval_execution, hit analysis,
edit-distance sweep, dataset viewer."""

import numpy as np
import pytest

from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.envs import KarelWorld
from demo2program_tpu.tools.karel_render import state2str, state2image
from demo2program_tpu.tools.hit_analysis import hit_count
from demo2program_tpu.tools.measure_program_fix_accuracy import (
    levenshtein, sweep)
from demo2program_tpu.tools.eval_execution import (
    EvaluationResult, batch_check)

from tests.test_karel_env import empty_room
from tests.test_data import tiny_dataset_dir  # noqa: F401


def test_render_ascii_and_image():
    s = empty_room(y=2, x=3, d=1, markers=[(4, 4, 2)])
    txt = state2str(s, color=False)
    lines = txt.split("\n")
    assert len(lines) == 8
    assert lines[2][3] == ">"
    assert lines[4][4] == "o"
    assert lines[0] == "#" * 8
    img = state2image(s, grid_size=8)
    assert img.shape == (64, 64, 3)
    # agent tile differs from empty tile
    assert not np.allclose(img[16:24, 24:32], 1.0)


def test_hit_analysis_dead_branch():
    vocab = KarelVocab()
    code = ("DEF run m( IFELSE c( markersPresent c) i( pickMarker i) "
            "ELSE e( turnLeft e) m)")
    exe, ok = hit_count(code, domain="karel")
    assert ok
    w = KarelWorld(empty_room(markers=[(4, 4, 1)]))  # marker under agent
    hits, n, success = exe(w)
    assert success
    toks = code.split()
    hits_by_tok = dict(zip(toks, hits.tolist()))
    # taken branch hit, dead branch untouched
    assert hits[toks.index("pickMarker")] == 1
    assert hits[toks.index("turnLeft")] == 0
    assert hits[toks.index("IFELSE")] == 1

    # while-loop body hit once per iteration
    code2 = "DEF run m( WHILE c( markersPresent c) w( pickMarker w) m)"
    exe2, ok2 = hit_count(code2, domain="karel")
    w2 = KarelWorld(empty_room(markers=[(4, 4, 3)]))
    hits2, _, success2 = exe2(w2)
    assert success2
    toks2 = code2.split()
    assert hits2[toks2.index("pickMarker")] == 3
    assert hits2[toks2.index("markersPresent")] == 4  # 3 true + 1 false


def test_levenshtein_and_sweep():
    assert levenshtein("abc", "abc") == 0
    assert levenshtein(list("kitten"), list("sitting")) == 3
    rows = sweep([1, 0, 0], [1, 0, 1], [0, 2, 5], max_d=6)
    d0 = rows[0]
    assert d0[1] == pytest.approx(1 / 3)  # seq: match or dist 0
    assert d0[2] == pytest.approx(2 / 3)  # exec-correct or dist 0
    d2 = rows[2]
    assert d2[1] == pytest.approx(2 / 3)  # second program within d=2
    assert d2[2] == pytest.approx(1.0)
    d5 = rows[5]
    assert d5[1] == d5[2] == pytest.approx(1.0)


def test_batch_check_ground_truth_and_corrupted(tiny_dataset_dir):  # noqa: F811
    from demo2program_tpu.data.store import data_file, open_store
    vocab = KarelVocab()
    with open_store(data_file(tiny_dataset_dir)) as f:
        ids = [k for k in f.keys() if k != "data_info"][:4]
        programs = [vocab.intseq2str(f[i]["program"][()]) for i in ids]
        demos = [f[i]["s_h"][()] for i in ids]
        lens = [f[i]["s_h_len"][()] for i in ids]
    outs = batch_check(programs, ids, demos, lens, vocab)
    k = demos[0].shape[0]
    for o in outs:
        assert o.syntax and o.num_correct == k

    # corrupt: garbage + a wrong-but-valid program
    bad = ["not a program", "DEF run m( turnLeft turnLeft m)",
           programs[2], programs[3]]
    outs2 = batch_check(bad, ids, demos, lens, vocab)
    assert not outs2[0].syntax and outs2[0].num_correct == 0
    assert outs2[1].syntax
    res = EvaluationResult("t")
    for o in outs2:
        res.add(o)
    s = res.result_string()
    assert "syntax_acc" in s and "histogram" in s


def test_visualize_data_noninteractive(tiny_dataset_dir, capsys):  # noqa: F811
    from demo2program_tpu.tools.visualize_data import main
    main(["--dataset_path", tiny_dataset_dir, "--no_input",
          "--max_demos", "1"])
    out = capsys.readouterr().out
    assert "program: DEF run m(" in out
    assert "initial state:" in out


def test_doom_error_analysis(tmp_path):
    from demo2program_tpu.tools.doom_error_analysis import classify, main

    gt = "DEF run m( IF c( ISTHERE Revenant c) i( MOVE_LEFT i) m)".split()
    species = [t if t != "Revenant" else "Demon" for t in gt]
    predicate = [t if t != "ISTHERE" else "INTARGET" for t in gt]
    structural = [t if t != "MOVE_LEFT" else "ATTACK" for t in gt]
    mixed = [t if t != "Revenant" else "Demon" for t in predicate]
    assert classify(gt, gt) == "exact"
    assert classify(gt, species) == "species_only"
    assert classify(gt, predicate) == "predicate_only"
    assert classify(gt, structural) == "structural"
    assert classify(gt, mixed) == "percept_mixed"
    assert classify(gt, gt[:-2]) == "structural"  # length mismatch

    dump = tmp_path / "out_1_test.txt"
    dump.write_text(
        f"[id: a]\ngt: {' '.join(gt)}\npred: {' '.join(gt)}\n"
        f"greedy: {' '.join(species)}\n"
        f"[id: b]\ngt: {' '.join(gt)}\npred(error): {' '.join(structural)}\n"
        f"greedy(error): {' '.join(structural)}\n")
    out = main(["--dump", str(dump)])
    assert out["n"] == 2 and out["exact"] == 0
    assert out["of_wrong"]["species_only"]["count"] == 1
    assert out["of_wrong"]["structural"]["count"] == 1
    assert out["exact_or_species_only"] == 0.5
    out_pred = main(["--dump", str(dump), "--decode", "pred"])
    assert out_pred["exact"] == 1
