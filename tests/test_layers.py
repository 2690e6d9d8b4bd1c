"""The explicit-parameter layers (models/nn.py) against the flax.linen
modules the models were first written with, on the same parameters, and
the model parameter trees' names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demo2program_tpu.models import nn


def _rand(shape, seed=0):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape),
                       jnp.float32)


def _apply(fn, params, stats=None, train=False):
    updates = jax.tree_util.tree_map(lambda a: a, stats or {})
    s = nn.Scope(params, stats or {}, train, updates=updates)
    return fn(s), updates


@pytest.fixture
def linen():
    return pytest.importorskip("flax.linen")


def test_dense_matches_flax(linen):
    x = _rand((5, 7))
    m = linen.Dense(3)
    v = m.init(jax.random.key(0), x)
    got, _ = _apply(lambda s: nn.dense(s, x, 3), v["params"])
    np.testing.assert_array_equal(got, m.apply(v, x))


def test_conv_matches_flax(linen):
    x = _rand((2, 8, 8, 16))
    m = linen.Conv(32, (3, 3), strides=(2, 2), padding="SAME")
    v = m.init(jax.random.key(0), x)
    got, _ = _apply(lambda s: nn.conv(s, x, 32), v["params"])
    np.testing.assert_allclose(got, m.apply(v, x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(linen, train):
    x = _rand((6, 4, 5)) * 3 + 1
    m = linen.BatchNorm(use_running_average=not train, momentum=0.9,
                        epsilon=1e-3)
    v = m.init(jax.random.key(0), x)
    params = {"scale": _rand((5,), 1), "bias": _rand((5,), 2)}
    stats = {"mean": _rand((5,), 3), "var": jnp.abs(_rand((5,), 4))}
    ref, ref_upd = m.apply({"params": params, "batch_stats": stats}, x,
                           mutable=["batch_stats"])
    got, upd = _apply(lambda s: nn.batch_norm(s, x), params, stats, train)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(upd[k], ref_upd["batch_stats"][k],
                                   rtol=1e-6, atol=1e-6)
    assert v["batch_stats"]["var"].shape == (5,)


def test_lstm_step_matches_flax(linen):
    x, c, h = _rand((4, 6), 0), _rand((4, 8), 1), _rand((4, 8), 2)
    m = linen.OptimizedLSTMCell(8)
    v = m.init(jax.random.key(0), (c, h), x)
    (rc, rh), rout = m.apply(v, (c, h), x)
    s = nn.Scope(v["params"], {}, False)
    (gc, gh), gout = nn.lstm_step(nn.lstm_params(s, 6, 8), (c, h), x)
    for a, b in ((gc, rc), (gh, rh), (gout, rout)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_init_creates_named_params_with_flax_initialisers():
    x = jnp.ones((3, 4))
    s = nn.Scope({}, {}, True, rng=jax.random.key(0))
    nn.fc_bn(s.child("fc1"), x, 6)
    nn.lstm_params(s.child("OptimizedLSTMCell_0"), 4, 6)
    names = sorted(jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_flatten_with_path(s.params)[0])
    assert "['fc1']['Dense_0']['kernel']" in names
    assert "['fc1']['BNAct_0']['BatchNorm_0']['scale']" in names
    assert "['OptimizedLSTMCell_0']['hf']['bias']" in names
    assert "['OptimizedLSTMCell_0']['ii']['kernel']" in names
    assert "['OptimizedLSTMCell_0']['ii']['bias']" not in names
    assert s.stats["fc1"]["BNAct_0"]["BatchNorm_0"]["var"].tolist() \
        == [1.0] * 6
    wh = s.params["OptimizedLSTMCell_0"]["hf"]["kernel"]
    np.testing.assert_allclose(wh @ wh.T, np.eye(6), atol=1e-5)  # orthogonal
    assert not s.params["fc1"]["Dense_0"]["bias"].any()


def test_apply_rejects_missing_params():
    s = nn.Scope({}, {}, False)
    with pytest.raises(KeyError, match="Dense_0/kernel"):
        nn.dense(s.child("Dense_0"), jnp.ones((2, 3)), 4)


def test_full_model_param_tree_names():
    from demo2program_tpu.models.common import ModelConfig
    from demo2program_tpu.models.full import FullModel
    cfg = ModelConfig(model="full", batch_size=2, num_lstm_cell_units=8,
                      k=2, test_k=2, max_demo_len=4, max_program_len=5)
    batch = {
        "s_h": jnp.zeros((2, 2, 4, 8, 8, 16), jnp.uint8),
        "demo_len": jnp.full((2, 2), 3.0),
        "program_tokens": jnp.zeros((2, 5), jnp.int32),
        "a_h_tokens": jnp.zeros((2, 2, 4), jnp.int32),
        "per": jnp.zeros((2, 2, 4, 5), jnp.uint8),
    }
    v = jax.eval_shape(lambda: FullModel(cfg, True).init(
        jax.random.key(0), batch, include_greedy=False))
    tops = {k: sorted(v["params"][k]) for k in v["params"]}
    assert tops == {
        "encoder": ["demo_c_summary", "demo_encoder", "demo_h_summary",
                    "second_path"],
        "program_decoder": ["core"],
        "action_decoder": ["core"],
        "per_decoder": ["OptimizedLSTMCell_0", "output_projection",
                        "per_embed"],
    }
    assert sorted(v["params"]["program_decoder"]["core"]) == [
        "cell", "embedding", "output_projection"]
    assert v["params"]["program_decoder"]["core"]["embedding"].shape \
        == (cfg.dim_program_token + 1, 8)
