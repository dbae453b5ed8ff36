"""The Keras frontend of the port against the JAX package's on the CPU.

Each of ``tests/test_keras_frontend.py``'s eight cases runs through both
frontends: the same layer DAG (the layers' name counters reset, so the
layers carry the same names), the JAX model's weights copied into the
port's by layer name once both are built, then the same data. Gates:
outputs atol 1e-5, losses rtol 1e-5 (float32 in another summation
order), accuracy counts equal, ``summary`` text equal, shapes and errors
as JAX's.
"""
import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.frontends import keras as jkeras
from flexflow_tpu.frontends.keras import layers as jlayers
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.frontends import keras as tkeras
from flexflow_tpu_torch.frontends.keras import layers as tlayers
from flexflow_tpu_torch.runtime.convert import params_from_numpy

from torch_port_cnn import named

pytestmark = pytest.mark.torch_port

BOTH = ((jkeras, JFFConfig, {}), (tkeras, FFConfig, {"device": "cpu"}))


def _cfg(cls, bs=32):
    kw = {"workers_per_node": 1} if cls is JFFConfig else {}
    return cls(batch_size=bs, epochs=1, printing_interval=1000, **kw)


def _build(make, compile_kw, bs):
    """The model ``make(keras)`` builds, in both frontends, compiled with
    ``compile_kw(keras)``, built at batch ``bs``, the port holding the
    JAX model's weights."""
    models = []
    for keras, cfg_cls, extra in BOTH:
        for lay in (jlayers, tlayers):
            lay._name_counters.clear()
        m = make(keras)
        m.compile(config=_cfg(cfg_cls, bs), **compile_kw(keras), **extra)
        m._ensure_built(bs)
        models.append(m)
    jm, tm = models
    carry_keras(jm, tm)
    return jm, tm


def carry_keras(jm, tm):
    ex = jm.ffmodel.executor
    tm.ffmodel.set_weights(params_from_numpy(named(jm.ffmodel, ex.params)))


def assert_same_weights(jm, tm, atol=1e-5):
    for layer in jm.layers:
        jw, tw = jm.get_layer_weights(layer.name), tm.get_layer_weights(layer.name)
        assert set(jw) == set(tw), layer.name
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], atol=atol, rtol=0, err_msg=f"{layer.name}.{k}")


def assert_same_perf(tp, jp, rtol=1e-5):
    assert (tp.train_all, tp.train_correct) == (jp.train_all, jp.train_correct)
    for k in ("cce_loss", "sparse_cce_loss", "mse_loss"):
        np.testing.assert_allclose(getattr(tp, k), getattr(jp, k), rtol=rtol, err_msg=k)


def test_sequential_mlp_trains():
    (x, y), _ = jkeras.datasets.mnist.load_data(n_train=256, n_test=8)
    (tx, ty), _ = tkeras.datasets.mnist.load_data(n_train=256, n_test=8)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(ty, y)
    x = x.reshape(256, 784).astype(np.float32) / 255.0
    y = y.astype(np.int32)
    jm, tm = _build(
        lambda k: k.Sequential([k.Dense(64, activation="relu", input_shape=(784,)), k.Dense(10),
                                k.Activation("softmax")]),
        lambda k: dict(optimizer=k.SGD(learning_rate=0.05), loss="sparse_categorical_crossentropy",
                       metrics=["accuracy", "sparse_categorical_crossentropy"]), 32)
    jh = jm.fit(x, y, epochs=2, batch_size=32, verbose=False)
    th = tm.fit(x, y, epochs=2, batch_size=32, verbose=False)
    assert len(th) == len(jh) == 2
    for a, b in zip(th, jh):
        assert_same_perf(a, b)
    assert_same_perf(tm.evaluate(x, y, batch_size=32), jm.evaluate(x, y, batch_size=32))
    assert_same_weights(jm, tm)


def test_functional_cnn_concat():
    """Two convolutions concatenated, pooled, flattened, a softmax head,
    Adam: one epoch, then ``predict`` (atol 1e-5)."""

    def make(k):
        inp = k.Input(shape=(3, 16, 16))
        a = k.Conv2D(8, 3, padding="same", activation="relu")(inp)
        b = k.Conv2D(8, 3, padding="same", activation="relu")(inp)
        c = k.Concatenate(axis=1)([a, b])
        c = k.MaxPooling2D()(c)
        c = k.Flatten()(c)
        return k.Model(inp, k.Dense(10, activation="softmax")(c))

    jm, tm = _build(make, lambda k: dict(optimizer=k.Adam(learning_rate=0.001),
                                         loss="sparse_categorical_crossentropy",
                                         metrics=["accuracy"]), 16)
    x = np.random.RandomState(0).rand(64, 3, 16, 16).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, size=(64,)).astype(np.int32)
    assert_same_perf(tm.fit(x, y, epochs=1, batch_size=16, verbose=False)[0],
                     jm.fit(x, y, epochs=1, batch_size=16, verbose=False)[0])
    tp, jp = tm.predict(x[:16]), jm.predict(x[:16])
    assert tp.shape == jp.shape == (16, 10)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)


def test_merge_layers_and_summary():
    def make(k):
        inp = k.Input(shape=(8,))
        d1 = k.Dense(8)(inp)
        d2 = k.Dense(8)(inp)
        s = k.Add()([d1, d2])
        m = k.Multiply()([d1, d2])
        return k.Model(inp, k.Dense(2, activation="softmax")(k.Subtract()([s, m])))

    jm, tm = _build(make, lambda k: dict(optimizer=k.SGD(), loss="mse"), 8)
    lines = {"jax": [], "port": []}
    jm.summary(print_fn=lines["jax"].append)
    tm.summary(print_fn=lines["port"].append)
    assert lines["port"] == lines["jax"] and any("dense" in ln for ln in lines["port"])
    rs = np.random.RandomState(4)
    x = rs.rand(16, 8).astype(np.float32)
    y = rs.rand(16, 2).astype(np.float32)
    assert_same_perf(tm.fit(x, y, epochs=1, batch_size=8, verbose=False)[0],
                     jm.fit(x, y, epochs=1, batch_size=8, verbose=False)[0])
    assert_same_weights(jm, tm)


def test_lr_scheduler_callback():
    jm, tm = _build(lambda k: k.Sequential([k.Dense(4, input_shape=(4,)), k.Activation("softmax")]),
                    lambda k: dict(optimizer=k.SGD(learning_rate=0.1), loss="mse"), 8)
    rs = np.random.RandomState(5)
    x = rs.rand(16, 4).astype(np.float32)
    y = rs.rand(16, 4).astype(np.float32)
    seen = {}
    for tag, m, keras in (("jax", jm, jkeras), ("port", tm, tkeras)):
        seen[tag] = []

        def schedule(epoch, out=seen[tag]):
            out.append(0.1 / (epoch + 1))
            return out[-1]

        m.fit(x, y, epochs=3, batch_size=8, verbose=False,
              callbacks=[keras.callbacks.LearningRateScheduler(schedule)])
    assert seen["port"] == seen["jax"] == [0.1, 0.05, 0.1 / 3]
    assert float(tm.ffmodel.executor.opt_state["lr"]) == float(jm.ffmodel.executor.opt_state["lr"])
    assert abs(float(tm.ffmodel.executor.opt_state["lr"]) - 0.1 / 3) < 1e-7
    assert_same_weights(jm, tm)


def test_embedding_reuters_mlp():
    (x, y), _ = tkeras.datasets.reuters.load_data(num_words=100, maxlen=16, n_train=64, n_test=8)
    (jx, jy), _ = jkeras.datasets.reuters.load_data(num_words=100, maxlen=16, n_train=64, n_test=8)
    np.testing.assert_array_equal(x, jx)

    jm, tm = _build(
        lambda k: k.Sequential([k.InputLayer(shape=(16,), dtype="int32"), k.Embedding(100, 8),
                                k.Flatten(), k.Dense(46, activation="softmax")]),
        lambda k: dict(optimizer=k.Adam(), loss="sparse_categorical_crossentropy",
                       metrics=["accuracy"]), 16)
    assert_same_perf(tm.fit(x, y.astype(np.int32), epochs=1, batch_size=16, verbose=False)[0],
                     jm.fit(x, y.astype(np.int32), epochs=1, batch_size=16, verbose=False)[0])
    assert_same_weights(jm, tm)


def test_weights_survive_batch_size_change():
    """A predict at another batch size rebuilds the model, its weights
    (and the optimizer state) carried by layer name; then training goes
    on as JAX's."""
    jm, tm = _build(lambda k: k.Sequential([k.Dense(4, input_shape=(4,)), k.Activation("softmax")]),
                    lambda k: dict(optimizer=k.SGD(learning_rate=0.1, momentum=0.9), loss="mse"), 8)
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    y = np.random.RandomState(1).rand(16, 4).astype(np.float32)
    for m in (jm, tm):
        m.fit(x, y, epochs=1, batch_size=8, verbose=False)
    w_before = tm.layers[0].get_weights(tm)
    tp, jp = tm.predict(x[:12]), jm.predict(x[:12])  # another batch size: a rebuild
    assert tp.shape == jp.shape == (12, 4) and tm._compiled_batch_size == 12
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    w_after = tm.layers[0].get_weights(tm)
    assert set(w_before) == {"kernel", "bias"}
    np.testing.assert_array_equal(w_before["kernel"], w_after["kernel"])
    assert tm.ffmodel.executor.opt_state["step"] == jm.ffmodel.executor.opt_state["step"] == 2
    assert_same_perf(tm.fit(x, y, epochs=1, batch_size=8, verbose=False)[0],
                     jm.fit(x, y, epochs=1, batch_size=8, verbose=False)[0])
    assert_same_weights(jm, tm)


def test_shared_layer_raises():
    for keras in (jkeras, tkeras):
        d = keras.Dense(4)
        inp = keras.Input(shape=(4,))
        d(inp)
        with pytest.raises(NotImplementedError, match="shared layers are not supported"):
            d(inp)


def test_same_padding_matches_keras_shapes():
    # pool 2 stride 2 on 32: Keras gives 16 (not 17)
    for keras in (jkeras, tkeras):
        inp = keras.Input(shape=(3, 32, 32))
        out = keras.MaxPooling2D(pool_size=2, strides=2, padding="same")(inp)
        assert out.shape == (None, 3, 16, 16)
        out2 = keras.Conv2D(4, 3, strides=2, padding="same")(inp)
        assert out2.shape == (None, 4, 16, 16)
        out3 = keras.AveragePooling2D(pool_size=3, strides=2, padding="same")(
            keras.Input(shape=(2, 7, 7)))
        assert out3.shape == (None, 2, 4, 4)
