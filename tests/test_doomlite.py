"""DoomLite software-engine tests: determinism, puke-init protocol, label
geometry, combat/pickup state machines, and real-engine dataset generation
(replacing the round-1 hand-rolled fakes as the source of ViZDoom fixtures).
"""

import numpy as np
import pytest

from demo2program_tpu.data.vizdoom_generator import (
    DoomStateGenerator, VizdoomGeneratorConfig, generate)
from demo2program_tpu.envs import doomlite
from demo2program_tpu.envs.vizdoom import FRAME_SKIP, Vizdoom_env


def make_world(perception_type="simple"):
    w = Vizdoom_env(perception_type=perception_type, engine="doomlite")
    w.init_game()
    return w


def test_bit_deterministic_across_instances():
    s = DoomStateGenerator(seed=3).generate_initial_state()
    actions = ["TURN_LEFT", "MOVE_FORWARD", "ATTACK", "TURN_RIGHT",
               "MOVE_BACKWARD"]
    hists = []
    for _ in range(2):
        w = make_world()
        w.new_episode(s)
        for a in actions:
            w.state_transition(a)
        hists.append((list(w.s_h), list(w.p_v_h), list(w.a_h)))
        w.end_game()
    for a, b in zip(hists[0][0], hists[1][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(hists[0][1], hists[1][1]):
        np.testing.assert_array_equal(a, b)
    assert hists[0][2] == hists[1][2]


def test_puke_layout_and_player_teleport():
    g = doomlite.DoomGame()
    g.init()
    g.new_episode()
    g.send_game_command("puke 20 -100 200")
    assert (g.px, g.py) == (-100.0, 200.0)
    g.send_game_command("puke 21 -50 300")    # demon slot 0
    g.send_game_command("puke 7 -60 310")     # revenant slot 2
    g.send_game_command("puke 16 -70 320")    # hellknight slot 1
    g.send_game_command("puke 12 -80 330")    # ammo slot 2
    active = {(a.kind, a.slot) for a in g.actors if a.active}
    assert active == {("Demon", 0), ("Revenant", 2), ("HellKnight", 1)}
    assert [(i.kind, i.slot) for i in g.items if i.active] == [("MyAmmo", 2)]


def test_label_geometry_straight_ahead():
    """A demon placed straight ahead must be labelled centred on screen with
    size shrinking with distance."""
    g = doomlite.DoomGame()
    g.init()
    g.new_episode()
    g.send_game_command("puke 20 0 100")   # player at (0, 100), facing 90°N
    widths = []
    for i, dist in enumerate((150.0, 300.0)):
        g.send_game_command(f"puke {21 + i} 0 {100 + dist}")
    st = g.get_state()
    demons = [l for l in st.labels if l.object_name == "Demon"]
    assert len(demons) == 2
    for lab in demons:
        cx = lab.x + lab.width / 2
        assert abs(cx - 80) < 2.0
        widths.append(lab.width)
    near = max(demons, key=lambda l: l.width)
    far = min(demons, key=lambda l: l.width)
    assert near.object_position_y < far.object_position_y
    # screen center under the near demon's bbox -> INTARGET
    assert near.x < 80 < near.x + near.width


def test_behind_player_not_labelled():
    g = doomlite.DoomGame()
    g.init()
    g.new_episode()
    g.send_game_command("puke 20 0 300")
    g.send_game_command("puke 21 0 100")   # 200 units SOUTH, facing north
    st = g.get_state()
    assert not any(l.object_name == "Demon" for l in st.labels)


def test_attack_kills_and_alerts():
    g = doomlite.DoomGame()
    g.init()
    g.new_episode()
    g.send_game_command("puke 20 0 100")
    g.send_game_command("puke 21 0 250")   # demon dead ahead
    g.send_game_command("puke 22 120 100")  # demon off to the side
    vec = np.array([b == "ATTACK" for b in doomlite.BUTTONS])
    none = np.zeros(len(doomlite.BUTTONS), bool)
    # 15 pistol shots (10 dmg each) kill the 150hp demon
    for _ in range(15):
        g.make_action(vec, 1)
        g.make_action(none, 40)
    target = next(a for a in g.actors if a.kind == "Demon" and a.slot == 0)
    side = next(a for a in g.actors if a.kind == "Demon" and a.slot == 1)
    assert not target.active          # killed, leaves the label buffer
    assert g.killcount == 1
    assert side.alerted               # weapon noise alerts the other demon
    st = g.get_state()
    assert not any(l.object_name == "Demon" and l.object_id == 0
                   for l in st.labels)


def test_ammo_pickup_and_variables():
    g = doomlite.DoomGame()
    g.init()
    g.new_episode()
    gv = dict(zip(doomlite.GAME_VARIABLES, g._game_variables()))
    assert gv["SELECTED_WEAPON"] == 2 and gv["AMMO2"] == 50
    g.send_game_command("puke 20 0 100")
    g.send_game_command("puke 10 0 140")   # ammo 40 units ahead
    fwd = np.array([b == "MOVE_FORWARD" for b in doomlite.BUTTONS])
    g.make_action(fwd, 5)
    gv = dict(zip(doomlite.GAME_VARIABLES, g._game_variables()))
    assert gv["AMMO2"] == 60 and gv["ITEMCOUNT"] == 1
    assert not any(i.active for i in g.items)


def test_frame_capture_contract():
    """state_transition records exactly one frame per macro action with the
    reference's capture timing (`vizdoom_env.py:115-135`)."""
    w = make_world()
    s = DoomStateGenerator(seed=5).generate_initial_state()
    w.new_episode(s)
    assert len(w.s_h) == 1 and len(w.p_v_h) == 1 and w.a_h == []
    for i, a in enumerate(FRAME_SKIP):
        if a == "NONE":
            continue
        w.state_transition(a)
        assert len(w.s_h) == len(w.a_h) + 1
    w.end_game()


def test_species_distinguishable_after_downsize():
    """The three monster species must stay far apart in RGB after the 80x80
    INTER_AREA downsize at near AND far range — the v1 palette's muted hues
    collapsed under distance fade and the trained ifelse models confused
    species (the dominant test error, RESULTS.md round 2)."""
    from demo2program_tpu.data.vizdoom_generator import downsize

    def mean_sprite_colour(kind, dist):
        g = doomlite.DoomGame()
        g.init()
        g.new_episode()
        g.send_game_command("puke 20 0 100")
        base = doomlite.PUKE_BASE[kind]
        g.send_game_command(f"puke {base} 0 {100 + dist}")
        st = g.get_state()
        lab = next(l for l in st.labels if l.object_name == kind)
        img = downsize(np.transpose(st.screen_buffer, (1, 2, 0)))
        y = int((lab.y + lab.height / 2) * 80 / 120)
        x = int((lab.x + lab.width / 2) * 80 / 160)
        return img[y, x].astype(float)

    for dist in (150.0, 450.0):
        cols = {k: mean_sprite_colour(k, dist)
                for k in ("Demon", "HellKnight", "Revenant")}
        kinds = list(cols)
        for i in range(3):
            for j in range(i + 1, 3):
                diff = np.abs(cols[kinds[i]] - cols[kinds[j]]).max()
                assert diff > 60, (dist, kinds[i], kinds[j], cols)


def test_v3_silhouettes_distinct_and_v2_frozen():
    """sprite_style='v3' carves species-unique silhouettes (Demon: narrow
    head; HellKnight: horned top; Revenant: split legs) while the default
    v2 rendering stays bit-identical — stored v2 datasets are compared
    frame-bitwise against live replays, so v2 must never change."""
    from demo2program_tpu.data.vizdoom_generator import downsize

    def frame(kind, style, dist=150.0):
        g = doomlite.DoomGame()
        if style != "v2":
            g.set_sprite_style(style)
        g.init()
        g.new_episode()
        g.send_game_command("puke 20 0 100")
        base = doomlite.PUKE_BASE[kind]
        g.send_game_command(f"puke {base} 0 {100 + dist}")
        st = g.get_state()
        lab = next(l for l in st.labels if l.object_name == kind)
        return np.transpose(st.screen_buffer, (1, 2, 0)), lab

    kinds = ("Demon", "HellKnight", "Revenant")
    for kind in kinds:
        # v2 path is untouched by the style plumbing
        f_default, _ = frame(kind, "v2")
        g2 = doomlite.DoomGame()
        g2.set_sprite_style("v2")
        assert g2.sprite_style == "v2"
        f3, lab = frame(kind, "v3")
        assert not np.array_equal(f_default, f3), kind  # carve visible
        # carves stay off the bbox centre: centre pixel keeps species hue
        cy = int(lab.y + lab.height / 2)
        cx = int(lab.x + lab.width / 2)
        assert np.array_equal(f_default[cy, cx], f3[cy, cx]), kind

    # silhouette signatures stay pairwise distinct after the 80x80
    # downsize: compare where each sprite's bbox differs from the v2 fill
    # (top-half vs bottom-half carve mass separates all three kinds)
    sig = {}
    for kind in kinds:
        f2, lab = frame(kind, "v2")
        f3, _ = frame(kind, "v3")
        d2, d3 = downsize(f2).astype(int), downsize(f3).astype(int)
        diff = (np.abs(d2 - d3).sum(-1) > 30)
        ys, xs = np.nonzero(diff)
        assert len(ys) >= 2, kind
        # carve position relative to the sprite bbox centre (downsized)
        cy = (lab.y + lab.height / 2) * 80.0 / 120.0
        top_mass = (ys <= cy).mean()
        width_spread = (xs.max() - xs.min()) / max(diff.shape[1], 1)
        sig[kind] = (top_mass, width_spread)
    # Revenant carves the bottom; the other two carve the top
    assert sig["Revenant"][0] < 0.5 < sig["Demon"][0]
    assert sig["HellKnight"][0] > 0.5
    # Demon carves both corners (wide); HellKnight carves the centre only
    assert sig["Demon"][1] > sig["HellKnight"][1]

    with pytest.raises(ValueError):
        doomlite.DoomGame().set_sprite_style("v9")


@pytest.fixture(scope="session")
def tiny_doom_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("doom_tiny")
    cfg = VizdoomGeneratorConfig(
        dir_name=str(d), num_train=4, num_test=2, num_val=1,
        num_demo_per_program=4, num_test_demo_per_program=2,
        perception_type="simple", seed=7)
    generate(cfg)
    return str(d)


def test_generated_dataset_schema_and_replay(tiny_doom_dataset):
    """Real-engine dataset: schema parity + every stored demo replays
    bit-exactly from its stored init positions (the execution-accuracy
    ground truth)."""
    from demo2program_tpu.data.store import data_file, open_store
    from demo2program_tpu.dsl import vizdoom_interp, vizdoom_parser
    from demo2program_tpu.dsl.vizdoom_vocab import VizDoomDSLVocab

    vocab = VizDoomDSLVocab(perception_type="simple")
    w = make_world()
    with open_store(data_file(tiny_doom_dataset)) as f:
        info = f["data_info"]
        pos_keys = [k.decode() if isinstance(k, bytes) else k
                    for k in info["vizdoom_pos_keys"][()]]
        ids = [k for k in f if k != "data_info"]
        g = f[ids[0]]
        code = vocab.intseq2str(g["program"][()])
        ast, ok = vizdoom_parser.parse(code)
        assert ok
        init_pos = g["vizdoom_init_pos"][()]
        init_len = g["vizdoom_init_pos_len"][()]
        for k in range(2):
            init = {}
            for p, key in enumerate(pos_keys):
                arr = init_pos[k, p, :init_len[k, p]]
                init[key] = (arr[0].tolist() if key == "player_pos"
                             else arr.tolist())
            w.new_episode(init)
            _, success = vizdoom_interp.execute(ast, w)
            assert success
            stored_len = g["s_h_len"][()][k]
            assert len(w.s_h) == stored_len
            from demo2program_tpu.data.vizdoom_generator import downsize
            for t, frame in enumerate(w.s_h):
                np.testing.assert_array_equal(
                    downsize(frame).astype(np.int16), g["s_h"][k, t])
            pv = np.stack(w.p_v_h)
            np.testing.assert_array_equal(
                pv, g["p_v_h"][()][k, :stored_len])
    w.end_game()
