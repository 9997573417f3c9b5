"""The port's single-device Keras training step
(``sparkdl_tpu_torch.parallel.keras_train`` over a trainable
``models.keras_model.KerasModel``) held to the JAX package's
``make_keras_train_step`` on a one-device mesh, on the CPU.

The JAX step on the 8 virtual CPU devices is data-parallel: its batch-norm
statistics are taken per shard and averaged, so it is not the oracle here.
On ``Mesh(jax.devices()[:1])`` it is Keras's own ``stateless_call(...,
training=True)`` step. Both packages read the same ``.keras`` file and take
one step on the same batch; compared are the loss, every trainable weight
after the step, and the moving mean and variance:

- sgd: the weights at ``rtol=1e-5, atol=1e-6`` (float32 sums in another
  order), the loss at ``rtol=1e-5``;
- adam and adamw: one step moves a weight by about ``lr * sign(g)``, and a
  gradient at float-noise level moves it by up to ``lr`` in either package,
  so each weight's change is held to the oracle's change in norm, within
  1e-3 of it;
- the moving statistics at ``rtol=1e-6, atol=1e-7`` (measured: 1.1e-7
  relative; torch's unbiased running variance would be 8.7e-6 off at these
  1152 values a channel); a frozen batch norm's (and a frozen model's) bit
  for bit unchanged, its weights too.
"""

import keras
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sparkdl_tpu.estimators import losses as jax_losses
from sparkdl_tpu.parallel.keras_train import (
    init_keras_train_state as jax_init_state,
    make_keras_train_step as jax_make_step,
)
from sparkdl_tpu.parallel.trainer import shard_batch
from sparkdl_tpu_torch.estimators import losses
from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file
from sparkdl_tpu_torch.parallel.keras_train import (
    KerasTrainState,
    init_keras_train_state,
    make_keras_train_step,
)

L = keras.layers
LR = {"sgd": 0.05, "adam": 1e-3, "adamw": 1e-3}
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
STAT_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_RTOL = 1e-5
ADAM_CHANGE_RTOL = 1e-3
BATCH, SIZE, CLASSES = 8, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _conv_bn(name: str = "sequential"):
    """conv (no bias) -> BN -> relu -> strided conv -> GAP -> Dense(softmax)."""
    return keras.Sequential([
        L.Input((SIZE, SIZE, 3)),
        L.Conv2D(6, 3, padding="same", use_bias=False, name="c1"),
        L.BatchNormalization(name="bn1"),
        L.Activation("relu", name="relu1"),
        L.Conv2D(8, 3, strides=2, activation="relu", name="c2"),
        L.GlobalAveragePooling2D(name="gap"),
        L.Dense(CLASSES, activation="softmax", name="head"),
    ], name=name)


def _nested(frozen_base: bool):
    """The fine-tune idiom: a Functional base (conv -> BN -> relu -> GAP)
    nested in a Sequential with a softmax head."""
    inp = keras.Input((SIZE, SIZE, 3))
    h = L.Conv2D(6, 3, padding="same", name="c1")(inp)
    h = L.BatchNormalization(name="bn1")(h)
    h = L.Activation("relu", name="relu1")(h)
    base = keras.Model(inp, L.GlobalAveragePooling2D(name="gap")(h), name="base")
    base.trainable = not frozen_base
    return keras.Sequential([base, L.Dense(CLASSES, activation="softmax", name="head")])


def _model(kind: str, seed: int = 0):
    keras.utils.set_random_seed(seed)
    if kind.startswith("nested"):
        model = _nested(frozen_base=kind == "nested_frozen_base")
        model.build((None, SIZE, SIZE, 3))
    else:
        model = _conv_bn()
        if kind == "frozen_bn":
            model.get_layer("bn1").trainable = False
    # moving statistics away from their initial 0 and 1, so that a frozen
    # BN's normalisation and the moving update are both seen
    rng = np.random.default_rng(seed + 1)
    for var in model.non_trainable_variables:
        if var.path.endswith("moving_mean"):
            var.assign(0.2 * rng.standard_normal(var.shape).astype(np.float32))
        elif var.path.endswith("moving_variance"):
            var.assign(rng.uniform(0.5, 1.5, var.shape).astype(np.float32))
    return model


def _batch(seed: int, weighted: bool):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "y": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
    if weighted:
        # the last two rows are padding
        batch["w"] = (np.arange(BATCH) < BATCH - 2).astype(np.float32)
    return batch


def _variables(model):
    """(layer path, variable index) -> Keras variable, through nested models."""
    out = {}
    for layer in model.layers:
        if hasattr(layer, "layers"):
            out.update({(layer.name, *k): v for k, v in _variables(layer).items()})
        else:
            out.update({(layer.name, i): v for i, v in enumerate(layer.weights)})
    return out


def _flatten(weights, prefix=()):
    out = {}
    for name, arrays in weights.items():
        if isinstance(arrays, dict):
            out.update(_flatten(arrays, prefix + (name,)))
        else:
            out.update({prefix + (name, i): a for i, a in enumerate(arrays)})
    return out


def jax_oracle_step(model, batch, optimizer: str, weighted: bool):
    """One step of the JAX package's ``make_keras_train_step`` on a
    one-device mesh: (loss, variable key -> value after the step)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    loss_fn = (jax_losses.get_per_sample_loss_fn if weighted else jax_losses.get_loss_fn)(
        "sparse_categorical_crossentropy")
    tx = jax_losses.get_optimizer(optimizer, LR[optimizer])
    state = jax_init_state(model, tx)
    step = jax_make_step(model, loss_fn, tx, mesh, weighted=weighted)
    state, loss = step(state, shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh))
    values = {id(v): np.asarray(t) for v, t in zip(model.trainable_variables, state.trainable)}
    values.update({id(v): np.asarray(t)
                   for v, t in zip(model.non_trainable_variables, state.non_trainable)})
    return float(loss), {k: values[id(v)] for k, v in _variables(model).items()}


def port_step(path, batch, optimizer: str, weighted: bool):
    """One step of the port on the file: (loss, key -> value, the module)."""
    module = KerasModel(*read_keras_file(path))
    loss_fn = (losses.get_per_sample_loss_fn if weighted else losses.get_loss_fn)(
        "sparse_categorical_crossentropy")
    state = init_keras_train_state(module, losses.get_optimizer(optimizer, LR[optimizer]))
    step = make_keras_train_step(loss_fn, weighted=weighted)
    state, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), _flatten(module.keras_weights()), state


def _check(kind, optimizer, weighted, tmp_path, seed=0):
    model = _model(kind, seed)
    path = str(tmp_path / f"{kind}.keras")
    model.save(path)
    start = _flatten(read_keras_file(path)[1])
    trainable = {k for k, v in _variables(model).items() if v.trainable}
    batch = _batch(seed + 2, weighted)
    got_loss, got, state = port_step(path, batch, optimizer, weighted)
    want_loss, want = jax_oracle_step(model, batch, optimizer, weighted)
    assert set(got) == set(want) == set(start)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for key in sorted(want):
        if key in trainable:
            if optimizer == "sgd":
                np.testing.assert_allclose(got[key], want[key], **SGD_TOL, err_msg=str(key))
            else:
                change = want[key] - start[key]
                err = np.linalg.norm((got[key] - start[key]) - change)
                assert err <= ADAM_CHANGE_RTOL * np.linalg.norm(change), (key, err)
        else:
            np.testing.assert_allclose(got[key], want[key], **STAT_TOL, err_msg=str(key))
    return start, got, trainable, state


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "mean"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("kind", ["trainable", "frozen_bn"])
def test_one_step_matches_the_jax_one_device_step(kind, optimizer, weighted, tmp_path):
    start, got, trainable, _ = _check(kind, optimizer, weighted, tmp_path)
    bn_stats = [("bn1", 2), ("bn1", 3)]
    if kind == "frozen_bn":
        # a frozen BN stays on its moving statistics, and its weights and
        # statistics do not move
        assert not {("bn1", i) for i in range(4)} & trainable
        for key in [("bn1", i) for i in range(4)]:
            np.testing.assert_array_equal(got[key], start[key])
    else:
        for key in bn_stats:
            assert not np.array_equal(got[key], start[key])


@pytest.mark.parametrize("kind", ["nested_trainable", "nested_frozen_base"])
def test_nested_model_step_matches_the_jax_one_device_step(kind, tmp_path):
    start, got, trainable, state = _check(kind, "sgd", True, tmp_path)
    base = [k for k in start if k[0] == "base"]
    assert len(base) == 6
    if kind == "nested_frozen_base":
        # model.trainable = False ANDs down the nesting: the base's weights
        # and statistics stay bit for bit; the head takes the step
        assert not set(base) & trainable
        for key in base:
            np.testing.assert_array_equal(got[key], start[key])
        assert len(state.opt_state.param_groups[0]["params"]) == 2
    else:
        assert len(state.opt_state.param_groups[0]["params"]) == 6
    assert not np.array_equal(got[("head", 0)], start[("head", 0)])


def test_weighted_step_ignores_zero_weight_rows(tmp_path):
    """Rows of weight 0 change nothing but the batch-norm statistics: the
    step on 6 real rows plus 2 pad rows, and the mean step on the 6 rows
    alone, give the same loss and head weights with a frozen BN (which sees
    no batch statistics)."""
    model = _model("frozen_bn")
    path = str(tmp_path / "m.keras")
    model.save(path)
    batch = _batch(3, weighted=True)
    real = {"x": batch["x"][:6], "y": batch["y"][:6]}
    padded = {**batch, "x": batch["x"].copy()}
    padded["x"][6:] = 100.0  # the pad rows' values must not matter
    loss_w, got_w, _ = port_step(path, padded, "sgd", weighted=True)
    loss_m, got_m, _ = port_step(path, real, "sgd", weighted=False)
    np.testing.assert_allclose(loss_w, loss_m, rtol=LOSS_RTOL)
    for key in got_m:
        np.testing.assert_allclose(got_w[key], got_m[key], **SGD_TOL, err_msg=str(key))


def test_train_state_optimizes_the_trainable_parameters_only(tmp_path):
    model = _model("frozen_bn")
    path = str(tmp_path / "m.keras")
    model.save(path)
    module = KerasModel(*read_keras_file(path))
    state = init_keras_train_state(module, losses.get_optimizer("sgd"))
    assert isinstance(state, KerasTrainState) and state.step == 0
    params = state.opt_state.param_groups[0]["params"]
    names = {id(p): n for n, p in module.named_parameters()}
    assert sorted(names[id(p)] for p in params) == sorted(
        n for n, p in module.named_parameters() if "bn1" not in n)
    assert len(model.trainable_variables) == len(params)
    # the step leaves the module in train mode and counts
    step = make_keras_train_step(losses.get_per_sample_loss_fn("sparse_categorical_crossentropy"),
                                 weighted=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, True).items()}
    state, loss = step(state, batch)
    assert state.step == 1 and module.training and loss.requires_grad is False


def test_dropout_draws_from_the_callers_generator():
    """Dropout under train(): Keras's inverted dropout, its mask from the
    generator the step is given (two generators on one seed agree); the
    identity at inference and at rate 0."""
    keras.utils.set_random_seed(0)
    model = keras.Sequential([L.Input((16,)), L.Dropout(0.5, name="drop"),
                              L.Dense(CLASSES, activation="softmax", name="head")])
    config = {"class_name": "Sequential", "config": model.get_config()}
    weights = {layer.name: layer.get_weights() for layer in model.layers}
    module = KerasModel(config, weights)
    x = torch.ones((4, 16))
    drop = module.layers["drop"]
    assert torch.equal(drop.call(x), x)
    module.train()
    a = drop.call(x, generator=torch.Generator().manual_seed(5))
    b = drop.call(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0} and 0 < (a == 0).sum() < a.numel()
    out = module(x, generator=torch.Generator().manual_seed(5))
    assert out.shape == (4, CLASSES)
    module.eval()
    np.testing.assert_allclose(module(x).detach().numpy(), np.asarray(model(x.numpy())),
                               rtol=1e-5, atol=1e-6)
