"""Explicit-parameter layers: the model families' building blocks in plain
JAX.

Parameters live in nested dicts whose names and initialisers follow the
layouts the models were first written with (`Dense_0/kernel`,
`BatchNorm_0/scale`, `OptimizedLSTMCell_0/hi/kernel`, ...), so a parameter
tree keeps one schema across checkpoints and tools.

A `Scope` is one node of that tree. In init mode (constructed with an rng)
`Scope.param` creates each parameter the first time a layer asks for it,
which lets one forward function serve both initialisation and application.
Batch-norm running statistics live in a parallel `batch_stats` tree; in
training mode the updated statistics are written to `Scope.updates`.

Recurrences fetch their parameters before the `lax.scan`, so scan bodies are
pure functions of arrays.
"""

import zlib

import jax
import jax.numpy as jnp
from jax.nn import initializers

lecun_normal = initializers.lecun_normal()
zeros = initializers.zeros
ones = initializers.ones


class Scope:
    """One node of the (params, batch_stats) trees of a model application."""

    def __init__(self, params, stats, train, rng=None, updates=None,
                 path=()):
        self.params = params
        self.stats = stats
        self.train = train
        self.rng = rng
        self.updates = updates
        self.path = path

    @property
    def initializing(self):
        return self.rng is not None

    def child(self, name):
        def sub(tree):
            if tree is None:
                return None
            if self.initializing:
                return tree.setdefault(name, {})
            return tree.get(name, {})
        return Scope(sub(self.params), sub(self.stats), self.train,
                     self.rng, sub(self.updates), self.path + (name,))

    def _key(self, name):
        # a stable per-path key: Python's str hash is salted per process
        tag = zlib.crc32("/".join(self.path + (name,)).encode())
        return jax.random.fold_in(self.rng, tag)

    def param(self, name, init, shape):
        if self.initializing and name not in self.params:
            self.params[name] = init(self._key(name), shape, jnp.float32)
        if name not in self.params:
            raise KeyError(f"missing parameter {'/'.join(self.path)}/{name}")
        return self.params[name]

    def stat(self, name, init, shape):
        if self.initializing and name not in self.stats:
            self.stats[name] = init(None, shape, jnp.float32)
        return self.stats[name]

    def set_stat(self, name, value):
        if self.updates is not None:
            self.updates[name] = value


class Model:
    """A model family: `forward(scope, batch, **kw)` behind the
    init / apply interface of a variables dict
    `{"params": ..., "batch_stats": ...}`."""

    def __init__(self, cfg, train):
        self.cfg = cfg
        self.train = train

    def forward(self, scope, batch, **kwargs):
        raise NotImplementedError

    def init(self, key, batch, /, **kwargs):
        def run(key, batch):
            scope = Scope({}, {}, self.train, rng=key)
            self.forward(scope, batch, **kwargs)
            return {"params": scope.params, "batch_stats": scope.stats}
        return jax.jit(run)(key, batch)

    def apply(self, variables, batch, mutable=(), **kwargs):
        """Returns the outputs, plus `{"batch_stats": updated}` when
        "batch_stats" is in `mutable` (training-mode statistics)."""
        stats = variables.get("batch_stats", {})
        updates = jax.tree_util.tree_map(lambda a: a, stats)
        scope = Scope(variables["params"], stats, self.train,
                      updates=updates)
        out = self.forward(scope, batch, **kwargs)
        if "batch_stats" in mutable:
            return out, {"batch_stats": updates}
        return out


def promote(*xs):
    """Cast the operands to their common dtype (a bf16 input against f32
    params computes in f32, as the layers always have)."""
    dtype = jnp.result_type(*xs)
    return [jnp.asarray(x, dtype) for x in xs]


def dense(s, x, features, use_bias=True):
    kernel = s.param("kernel", lecun_normal, (x.shape[-1], features))
    if not use_bias:
        x, kernel = promote(x, kernel)
        return x @ kernel
    bias = s.param("bias", zeros, (features,))
    x, kernel, bias = promote(x, kernel, bias)
    return x @ kernel + bias


def conv(s, x, features):
    """NHWC 3x3 convolution, stride 2, 'SAME' padding (the reference's
    slim defaults as its models call them)."""
    w = s.param("kernel", lecun_normal, (3, 3, x.shape[-1], features))
    b = s.param("bias", zeros, (features,))
    x, w, b = promote(x, w, b)
    y = jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + b


def batch_norm(s, x, momentum=0.9, epsilon=1e-3):
    """Batch norm over every axis but the last. Training mode normalises
    with the batch statistics (computed in at least float32) and records
    the running averages; evaluation mode uses the running averages."""
    features = x.shape[-1]
    ra_mean = s.stat("mean", zeros, (features,))
    ra_var = s.stat("var", ones, (features,))
    scale = s.param("scale", ones, (features,))
    bias = s.param("bias", zeros, (features,))
    if s.train:
        axes = tuple(range(x.ndim - 1))
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, (xf * xf).mean(axes) - mean * mean)
        if not s.initializing:
            s.set_stat("mean", momentum * ra_mean + (1 - momentum) * mean)
            s.set_stat("var", momentum * ra_var + (1 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    y = (x - mean) * (jax.lax.rsqrt(var + epsilon) * scale) + bias
    return y.astype(jnp.result_type(x, scale, bias))


def lrelu(x, leak=0.2):
    f1 = 0.5 * (1 + leak)
    f2 = 0.5 * (1 - leak)
    return f1 * x + f2 * jnp.abs(x)


def bn_act(s, x, activation="lrelu"):
    """activation -> batch norm (the reference order, `models/ops.py:14-24`
    of the reference: the activation comes FIRST)."""
    if activation == "lrelu":
        x = lrelu(x)
    return batch_norm(s.child("BatchNorm_0"), x)


def conv_bn(s, x, features):
    """conv + (lrelu -> BN); the reference conv2d."""
    x = conv(s.child("Conv_0"), x, features)
    return bn_act(s.child("BNAct_0"), x)


def fc_bn(s, x, features, activation="lrelu"):
    """dense + (activation -> BN); the reference fc."""
    x = dense(s.child("Dense_0"), x, features)
    return bn_act(s.child("BNAct_0"), x, activation)


_GATES = ("i", "f", "g", "o")


def lstm_params(s, in_dim, units):
    """The LSTM cell's parameters, concatenated over the gates (i, f, g, o)
    into one input kernel, one recurrent kernel and one bias."""
    orthogonal = initializers.orthogonal()
    wi = [s.child("i" + g).param("kernel", lecun_normal, (in_dim, units))
          for g in _GATES]
    wh = [s.child("h" + g).param("kernel", orthogonal, (units, units))
          for g in _GATES]
    bh = [s.child("h" + g).param("bias", zeros, (units,)) for g in _GATES]
    return {"wi": jnp.concatenate(wi, -1), "wh": jnp.concatenate(wh, -1),
            "bh": jnp.concatenate(bh, -1)}


def lstm_step(p, carry, x):
    """One LSTM step: ((c, h), x) -> ((c', h'), h')."""
    c, h = carry
    hh, wh, bh = promote(h, p["wh"], p["bh"])
    xx, wi = promote(x, p["wi"])
    z = (hh @ wh + bh) + xx @ wi
    i, f, g, o = jnp.split(z, 4, axis=-1)
    new_c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    new_h = jax.nn.sigmoid(o) * jnp.tanh(new_c)
    return (new_c, new_h), new_h


def embedding(s, num, features):
    return s.param("embedding", initializers.uniform(scale=0.02),
                   (num, features))


def embed(table, ids):
    """one_hot(ids) @ table: an id of len(table) (out of range) embeds to
    zeros, which the teacher-forced start token relies on."""
    return jax.nn.one_hot(ids, table.shape[0], dtype=table.dtype) @ table


def time_major_scan(step, carry, xs):
    """lax.scan over axis 1 of every leaf of `xs`, outputs stacked on
    axis 1."""
    xs = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), xs)
    carry, ys = jax.lax.scan(step, carry, xs)
    return carry, jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), ys)
