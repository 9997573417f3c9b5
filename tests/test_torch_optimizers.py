"""optax's rmsprop, adagrad, nadam, lamb and lion in the port against optax
itself, and a Keras fit with each against the JAX estimator's loop, on the
CPU.

Updates: five updates of a small tree (a matrix, a vector, a 3-d tensor and
a zero vector, for lamb's zero-norm rule) from one numpy seed, through the
port's optimizer and ``get_optimizer(name, lr)`` of the JAX package (optax
0.2.6): the weights agree at ``rtol=1e-5, atol=5e-6`` (float32 on both
sides; the bias corrections are rounded in another order, measured at most
2.1e-6 after five nadam updates at lr 0.05).

Fits: 2 epochs at batch 5 over 12 rows (a ragged last batch) of a
Flatten -> Dense model, the port's estimator against the JAX package's
one-device loop (``test_torch_keras_estimator.jax_fit``) at each
optimizer's Keras default learning rate: each weight's change from the start within 1e-3 of the oracle's change in
norm (an adaptive update moves a weight by about ``lr`` whatever its
gradient's size, so the weights are compared by their changes).
"""

import inspect

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.estimators.losses import get_optimizer as jax_get_optimizer
from sparkdl_tpu_torch.estimators import optimizers
from sparkdl_tpu_torch.estimators.losses import _DEFAULT_LR, get_optimizer
from sparkdl_tpu_torch.models.keras_model import read_keras_file
from test_torch_keras_estimator import (  # noqa: F401 (bright_rows: a fixture)
    _estimator,
    _frame,
    _tiny_model,
    bright_rows,
    jax_fit,
)
from test_torch_keras_train import _flatten

NAMES = ("rmsprop", "adagrad", "nadam", "lamb", "lion")
OPTAX_TOL = dict(rtol=1e-5, atol=5e-6)
CHANGE_RTOL = 1e-3
SHAPES = [(7, 3), (5,), (2, 3, 4), (4,)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _tree(seed):
    rng = np.random.RandomState(seed)
    weights = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    weights[-1][:] = 0  # a zero leaf: lamb's trust ratio is 1 there
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(5)]
    return weights, grads


def _port_updates(name, lr, weights, grads, opt=None):
    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in weights]
    opt = get_optimizer(name, lr)(params)
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    return params, opt


@pytest.mark.parametrize("lr", [0.05, 1e-3])
@pytest.mark.parametrize("name", NAMES)
def test_five_updates_match_optax(name, lr):
    weights, grads = _tree(5)
    params, _ = _port_updates(name, lr, weights, grads)
    tx = jax_get_optimizer(name, lr)
    tree = [jnp.asarray(w) for w in weights]
    state = tx.init(tree)
    for step in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step], state, tree)
        tree = optax.apply_updates(tree, updates)
    for p, want in zip(params, tree):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), **OPTAX_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_round_trips_through_a_checkpoint(name, tmp_path):
    """Two updates, the optimizer's ``state_dict`` through ``torch.save``
    into a fresh optimizer over copies of the weights, three more updates:
    bit for bit the five uninterrupted updates."""
    weights, grads = _tree(6)
    straight, _ = _port_updates(name, 0.05, weights, grads)
    first, opt = _port_updates(name, 0.05, weights, grads[:2])
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    params = [torch.nn.Parameter(p.detach().clone()) for p in first]
    resumed = get_optimizer(name, 0.05)(params)
    resumed.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert all(isinstance(v, torch.Tensor) for s in resumed.state.values() for v in s.values())
    for step in grads[2:]:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        resumed.step()
    for a, b in zip(params, straight):
        assert torch.equal(a, b)


_OPTAX_DEFAULTS = {
    "rmsprop": (optimizers.OptaxRMSprop, optax.rmsprop, {"decay": "decay", "eps": "eps",
                                                          "initial_scale": "initial_scale"}),
    "adagrad": (optimizers.OptaxAdagrad, optax.adagrad,
                {"initial_accumulator_value": "initial_accumulator_value", "eps": "eps"}),
    "nadam": (optimizers.OptaxNadam, optax.adam, {"eps": "eps"}),
    "lamb": (optimizers.OptaxLamb, optax.lamb, {"eps": "eps", "weight_decay": "weight_decay"}),
    "lion": (optimizers.OptaxLion, optax.lion, {"weight_decay": "weight_decay"}),
}


@pytest.mark.parametrize("name", NAMES)
def test_defaults_are_optax_and_keras(name):
    cls, optax_fn, names = _OPTAX_DEFAULTS[name]
    group = get_optimizer(name)([torch.nn.Parameter(torch.zeros(2))]).param_groups[0]
    assert isinstance(get_optimizer(name)([torch.nn.Parameter(torch.zeros(2))]), cls)
    assert group["lr"] == _DEFAULT_LR[name]
    optax_params = inspect.signature(optax_fn).parameters
    for ours, theirs in names.items():
        assert group[ours] == optax_params[theirs].default, ours
    if "betas" in group:
        assert group["betas"] == (optax_params["b1"].default, optax_params["b2"].default)


# -- a Keras fit with each, against the JAX estimator's loop ---------------------------

@pytest.mark.parametrize("name", NAMES)
def test_keras_fit_matches_the_jax_one_device_loop(bright_rows, tmp_path, name):
    _, path = _tiny_model(tmp_path, seed=1)
    params = {"epochs": 2, "batch_size": 5, "seed": 2}
    fitted = _estimator(path, kerasOptimizer=name, kerasFitParams=params).fit(
        _frame(bright_rows))
    want = jax_fit(path, bright_rows, 2, 5, 2, name, None,
                   "sparse_categorical_crossentropy", weighted=True)
    start = _flatten(read_keras_file(path)[1])
    got = _flatten(read_keras_file(fitted.getModelFile())[1])
    assert set(got) == set(want) == set(start) and len(fitted._training_losses) == 6
    assert np.isfinite(fitted._training_losses).all()
    for key in sorted(want):
        change, oracle = got[key] - start[key], want[key] - start[key]
        assert np.linalg.norm(oracle) > 0, key
        err = np.linalg.norm(change - oracle)
        assert err <= CHANGE_RTOL * np.linalg.norm(oracle), (key, err)
