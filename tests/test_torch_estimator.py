"""The port's ViT training path against the JAX package's.

ViT-Ti/16 at image_size=32 with 4 classes (the geometry of
tests/test_torch_vit.py), Flax-initialised with PRNGKey(0) and carried
across by ``vit_state_dict_from_flax``. The oracle is single-device and
built here from the JAX package's own pieces: ``jax.value_and_grad`` of
``(optax CE * w).sum() / w.sum()`` over ``sparkdl_tpu.models.vit.ViT`` with
its Pallas flash attention (interpret mode on the CPU) and
``get_optimizer("adam", lr)``. The JAX estimator's 8-device DP step is not
the oracle: its DP gradient test fails on the reference itself.

Tolerances: the loss and each gradient agree to ``atol=1e-5, rtol=1e-4``
(float32 on both sides, sums in another order over 12 blocks). After adam
steps the parameters cannot agree that closely everywhere: adam moves each
weight by about ``lr`` whatever its gradient's size, so a gradient at the
level of float32 noise moves its weight by up to ``lr`` in a direction the
noise decides. The key bias is such a weight (its gradient is exactly zero:
softmax does not change when every score of a row shifts by the same
``q . b_k``), and a few weights whose gradient crosses zero between steps
are others; where the noise flips such a gradient's sign, the two runs step
apart by up to ``2 * lr``. So after ``n`` adam steps: every weight lies
within ``2 * n * lr`` of the oracle's; in every leaf but the key bias (the
middle third of each ``qkv`` bias), the change from the start differs from
the oracle's change by at most 1% of its norm, so a leaf left unmoved or
moved wrongly fails; and the trained models' logits agree to
tests/test_ops.py's ViT tolerance ``atol=5e-4, rtol=5e-3``.

Checkpoint and resume: the JAX estimators' cases
(``tests/test_estimators.py``, ``tests/test_flax_estimator.py``,
``tests/test_fault_injection.py``) through the port, each held to an
uninterrupted fit of the port bit for bit (``torch.equal``): a resumed fit,
a preempted one resumed, fit(2) then fit(4), fit(4) then fit(2).
"""

import copy
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sparkdl_tpu.estimators.data import (
    in_memory_epoch_dataset as jax_in_memory_epoch_dataset,
)
from sparkdl_tpu.estimators.losses import _PER_SAMPLE_LOSSES as JAX_PER_SAMPLE
from sparkdl_tpu.estimators.losses import get_optimizer as jax_get_optimizer
from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu.ops import flash_attention as jax_flash_attention
from sparkdl_tpu_torch import TorchImageFileEstimator, TorchImageFileTransformer
from sparkdl_tpu_torch.estimators import checkpointing
from sparkdl_tpu_torch.estimators.data import epoch_batches
from sparkdl_tpu_torch.estimators.losses import (
    _PER_SAMPLE_LOSSES,
    get_optimizer,
    get_per_sample_loss_fn,
)
from sparkdl_tpu_torch.models.convert import (
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step
from sparkdl_tpu_torch.resilience import FaultPlan, Preempted, active_plan
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.utils.metrics import metrics

GEOMETRY = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
#: largest ||change - oracle's change|| / ||oracle's change|| of a leaf
#: after adam steps
ADAM_LEAF_RTOL = 1e-2
VIT_TOL = dict(atol=5e-4, rtol=5e-3)
LR = 1e-3
N_IMAGES = 6
CKPT_LOGGER = "sparkdl_tpu_torch.estimators.checkpointing"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(N_IMAGES, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def labels():
    return (np.arange(N_IMAGES) % 4).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params(images):
    variables = jax.jit(JaxViT(**GEOMETRY).init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def uris(tmp_path_factory, images):
    root = tmp_path_factory.mktemp("train_images")
    paths = []
    for i, img in enumerate(images):
        path = str(root / f"img_{i}.npy")
        np.save(path, img)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def train_df(uris, labels):
    session = TorchSession.builder.getOrCreate()
    return session.createDataFrame(
        [{"uri": u, "label": int(l)} for u, l in zip(uris, labels)], numPartitions=2
    )


def _jax_model():
    return JaxViT(**GEOMETRY, attn_impl=jax_flash_attention)


def _jax_loss(params, x, y, w):
    logits = _jax_model().apply(params, x)
    per = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    return (per * w).sum() / w.sum()


#: one jitted oracle step for every test: every batch has 4 rows, so it
#: compiles once
_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss))
_jax_forward = jax.jit(JaxViT(**GEOMETRY).apply)


@jax.jit
def _jax_adam_update(grads, opt_state, params):
    """``get_optimizer("adam", LR)``'s update, applied: one compiled program
    in place of a dispatch for every op of every parameter."""
    updates, opt_state = jax_get_optimizer("adam", LR).update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


@pytest.fixture(scope="module")
def jax_adam_run(flax_params, images, labels):
    """The single-device oracle: loss and gradients of the first step and
    the parameters after each of 3 adam steps on the first 4 images."""
    x, y = jnp.asarray(images[:4]), jnp.asarray(labels[:4])
    w = jnp.ones(4, jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    opt_state = jax_get_optimizer("adam", LR).init(params)
    first = None
    for _ in range(3):
        loss, grads = _jax_value_and_grad(params, x, y, w)
        if first is None:
            first = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
        params, opt_state = _jax_adam_update(grads, opt_state, params)
    return first, jax.tree_util.tree_map(np.asarray, params)


def _port_model(flax_params):
    model = ViT(**GEOMETRY, attn_impl="flash")
    model.load_state_dict(vit_state_dict_from_flax(flax_params), strict=True)
    return model.train()


def _ce_per_sample():
    est = TorchImageFileEstimator(device="cpu")
    return est._per_sample_loss()


def _batch(images, labels, w):
    return {"x": torch.from_numpy(images), "y": torch.from_numpy(labels),
            "w": torch.from_numpy(np.asarray(w, np.float32))}


def _grad_tree(model):
    return vit_flax_from_state_dict(
        {name: p.grad for name, p in model.named_parameters()}
    )


def _adam_leaf_parts(path, leaf):
    """The parts of a leaf whose adam change the oracle decides: the whole
    leaf, or a ``qkv`` bias without its key third (a zero gradient)."""
    name = jax.tree_util.keystr(path)
    if not name.endswith("['qkv']['bias']"):
        return {name: slice(None)}
    third = leaf.shape[-1] // 3
    return {f"{name}[q]": slice(0, third), f"{name}[v]": slice(2 * third, None)}


def _assert_adam_params_close(got, want, start, steps, images):
    """The tolerance of the module docstring for parameters after ``steps``
    adam steps from ``start``."""
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_start = dict(jax.tree_util.tree_leaves_with_path(start))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w, s = flat_want[path], flat_start[path]
        assert np.abs(g - w).max() <= 2 * steps * LR * 1.001, jax.tree_util.keystr(path)
        for name, part in _adam_leaf_parts(path, g).items():
            moved, oracle = (g - s)[..., part], (w - s)[..., part]
            err = np.linalg.norm(moved - oracle) / np.linalg.norm(oracle)
            assert err <= ADAM_LEAF_RTOL, f"{name}: {err:.3e}"
    x = jnp.asarray(images)
    np.testing.assert_allclose(np.asarray(_jax_forward(got, x)),
                               np.asarray(_jax_forward(want, x)), **VIT_TOL)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(
            g, flat_want[path], **tol, err_msg=jax.tree_util.keystr(path)
        )


# -- data: the epoch's batches ------------------------------------------------

@pytest.mark.parametrize("n,bs", [
    (24, 16), (7, 3), (5, 8), (2, 8), (12, 4), (1, 1), (9, 2), (30, 7),
], ids=["two_batches", "ragged", "one_short_batch", "pad_cycles_thrice",
        "exact", "one_row", "ragged_by_one", "ragged_wide"])
def test_epoch_batches_match_jax(n, bs):
    """Two epochs of permutations: equal index arrays, labels and weights,
    batch for batch, against ``in_memory_epoch_dataset`` at the estimator's
    ``ceil(n / bs)`` steps."""
    x = np.arange(n, dtype=np.float32)[:, None]
    y = np.arange(n, dtype=np.int32) * 10
    rng_port, rng_jax = np.random.RandomState(3), np.random.RandomState(3)
    steps = -(-n // bs)
    for _ in range(2):
        got = list(epoch_batches(rng_port.permutation(n), x, y, bs))
        want = list(jax_in_memory_epoch_dataset(rng_jax.permutation(n), x, y, bs, steps, True))
        assert len(got) == len(want) == steps
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"x", "y", "w"}
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key])


# -- losses and optimizers ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(_PER_SAMPLE_LOSSES))
def test_per_sample_losses_match_jax(name):
    rng = np.random.RandomState(4)
    y_pred = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        y_true = rng.randint(0, 5, size=6).astype(np.int32)
    else:
        y_true = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    got = get_per_sample_loss_fn(name)(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    want = JAX_PER_SAMPLE[name](jnp.asarray(y_true), jnp.asarray(y_pred))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_updates_match_optax(name):
    """Three updates of one tensor under the same gradients."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(7, 3).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = get_optimizer(name, 0.05)([param])
    tx = jax_get_optimizer(name, 0.05)
    jw, state = jnp.asarray(w0), None
    state = tx.init(jw)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


def test_optimizer_defaults_and_factories():
    param = torch.nn.Parameter(torch.zeros(2))
    adam = get_optimizer("adam")([param])
    assert adam.defaults["lr"] == 0.001 and adam.defaults["eps"] == 1e-8
    assert get_optimizer("adamw")([param]).defaults["weight_decay"] == 1e-4
    assert get_optimizer("sgd")([param]).defaults["lr"] == 0.01
    factory = lambda params: torch.optim.SGD(params, lr=0.5)  # noqa: E731
    assert get_optimizer(factory) is factory
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer("adadelta")


# -- one training step and three adam steps -----------------------------------

def test_train_step_matches_jax_oracle(flax_params, images, labels, jax_adam_run):
    (want_loss, want_grads), _ = jax_adam_run
    model = _port_model(flax_params)
    state = init_train_state(model, get_optimizer("adam", LR))
    step = make_train_step(_ce_per_sample())
    state, loss = step(state, _batch(images[:4], labels[:4], np.ones(4)))
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), want_loss, **GRAD_TOL)
    _assert_trees_close(_grad_tree(model), want_grads, **GRAD_TOL)


def test_three_adam_steps_match_jax_oracle(flax_params, images, labels, jax_adam_run):
    _, want_params = jax_adam_run
    model = _port_model(flax_params)
    state = init_train_state(model, get_optimizer("adam", LR))
    step = make_train_step(_ce_per_sample())
    batch = _batch(images[:4], labels[:4], np.ones(4))
    for _ in range(3):
        state, _ = step(state, batch)
    _assert_adam_params_close(vit_flax_from_state_dict(model.state_dict()),
                              want_params, flax_params, 3, images)


@pytest.mark.parametrize("fault", ["frozen", "reversed"])
def test_adam_check_catches_one_wrong_small_leaf(flax_params, images, jax_adam_run, fault):
    """The oracle's own parameters with one small leaf (the head bias, 4 of
    ~5.5M weights) left at its start or stepped the wrong way fail the
    check, though every weight stays within ``2 * n * lr``."""
    _, want = jax_adam_run
    got = copy.deepcopy(want)
    start = flax_params["params"]["head"]["bias"]
    moved = want["params"]["head"]["bias"] - start
    got["params"]["head"]["bias"] = start if fault == "frozen" else start - moved
    assert np.abs(got["params"]["head"]["bias"] - want["params"]["head"]["bias"]).max() \
        <= 2 * 3 * LR
    with pytest.raises(AssertionError, match=r"\['head'\]\['bias'\]"):
        _assert_adam_params_close(got, want, flax_params, 3, images)


def test_zero_weight_pad_rows_leave_the_gradient(flax_params, images, labels):
    """A ragged batch of 3 real rows cyclically padded to 4 with a weight-0
    row has the gradient of the 3 real rows alone."""
    step = make_train_step(_ce_per_sample())
    padded = _port_model(flax_params)
    idx = np.array([0, 1, 2, 0])
    step(init_train_state(padded, get_optimizer("sgd", 0.0)),
         _batch(images[idx], labels[idx], [1, 1, 1, 0]))
    real = _port_model(flax_params)
    step(init_train_state(real, get_optimizer("sgd", 0.0)),
         _batch(images[:3], labels[:3], np.ones(3)))
    for (name, a), (_, b) in zip(padded.named_parameters(), real.named_parameters()):
        # float32 sums over batches of 4 and 3 rows: GRAD_TOL
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL, msg=name)


def test_step_normalises_by_the_weights(flax_params, images, labels):
    """The loss is the weighted mean: uniform weights of 2 give the loss and
    gradients of weights of 1, the JAX oracle's."""
    step = make_train_step(_ce_per_sample())
    losses, grads = [], []
    for w in (np.ones(4), np.full(4, 2.0)):
        model = _port_model(flax_params)
        _, loss = step(init_train_state(model, get_optimizer("sgd", 0.0)),
                       _batch(images[:4], labels[:4], w))
        losses.append(loss.item())
        grads.append(model.head.weight.grad)
    want, _ = _jax_value_and_grad(flax_params, jnp.asarray(images[:4]),
                                  jnp.asarray(labels[:4]), jnp.ones(4, jnp.float32))
    np.testing.assert_allclose(losses, [float(want)] * 2, **GRAD_TOL)
    torch.testing.assert_close(grads[0], grads[1])


# -- the estimator ------------------------------------------------------------

def _estimator(flax_params, **kw):
    args = dict(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=ViT(**GEOMETRY, attn_impl="flash"),
        fitParams={"epochs": 2, "batch_size": 4, "learning_rate": LR, "seed": 0},
        initialVariables=flax_params, device="cpu",
    )
    args.update(kw)
    return TorchImageFileEstimator(**args)


@pytest.fixture(scope="module")
def fitted(flax_params, train_df):
    before = metrics.counter("estimator.steps").value
    transformer = _estimator(flax_params).fit(train_df)
    return transformer, metrics.counter("estimator.steps").value - before


def test_fit_rows_match_jax_forward_of_trained_params(fitted, train_df, uris, images):
    transformer, _ = fitted
    assert isinstance(transformer, TorchImageFileTransformer)
    tuned = vit_flax_from_state_dict(transformer.module.state_dict())
    want = np.asarray(_jax_forward(tuned, jnp.asarray(images)))
    rows = transformer.transform(train_df).collect()
    assert [r["uri"] for r in rows] == uris
    got = np.stack([r["out"].toArray() for r in rows])
    np.testing.assert_allclose(got, want, **VIT_TOL)


def test_fit_matches_the_jax_epoch_loop(fitted, flax_params, images, labels):
    """The fit's 4 steps (2 epochs x ceil(6/4), last batch padded) against
    the oracle stepping over the JAX package's own epoch batches."""
    transformer, steps = fitted
    assert steps == 4
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    opt_state = jax_get_optimizer("adam", LR).init(params)
    rng, losses = np.random.RandomState(0), []
    for _ in range(2):
        for b in jax_in_memory_epoch_dataset(
            rng.permutation(N_IMAGES), images, labels, 4, 2, weighted=True
        ):
            loss, grads = _jax_value_and_grad(params, b["x"], b["y"], b["w"])
            params, opt_state = _jax_adam_update(grads, opt_state, params)
            losses.append(float(loss))
    np.testing.assert_allclose(transformer._training_losses, losses, **GRAD_TOL)
    assert transformer._training_loss == transformer._training_losses[-1]
    _assert_adam_params_close(vit_flax_from_state_dict(transformer.module.state_dict()),
                              jax.tree_util.tree_map(np.asarray, params), flax_params, 4,
                              images)


def test_fit_leaves_the_callers_module_and_repeats(flax_params, train_df):
    module = ViT(**GEOMETRY, attn_impl="flash")
    before = copy.deepcopy(module.state_dict())
    est = _estimator(flax_params, module=module, initialVariables=None,
                     fitParams={"epochs": 1, "batch_size": 4, "seed": 3})
    first, second = est.fit(train_df), est.fit(train_df)
    for name, value in module.state_dict().items():
        assert torch.equal(value, before[name]), name
    assert first.module is not module and first.module is not second.module
    assert first._training_losses == second._training_losses
    for (name, a), b in zip(first.module.state_dict().items(),
                            second.module.state_dict().values()):
        assert torch.equal(a, b), name


def test_fit_takes_a_torch_state_dict_and_param_maps(flax_params, train_df):
    state = vit_state_dict_from_flax(flax_params)
    est = _estimator(state, fitParams={"epochs": 1, "batch_size": 6, "seed": 0})
    fitted = est.fit(train_df, [{est.fitParams: {"epochs": 1, "batch_size": 6}},
                                {est.optimizer: "sgd"}])
    assert len(fitted) == 2 and all(isinstance(f, TorchImageFileTransformer) for f in fitted)
    assert fitted[0]._training_losses == pytest.approx(fitted[1]._training_losses)


@pytest.fixture()
def group_of_one():
    """A gloo process group of this process alone, left after the test."""
    from sparkdl_tpu_torch.parallel import runner

    runner.initialize(device="cpu")
    try:
        yield runner
    finally:
        runner.shutdown()


@pytest.mark.parametrize("param,value", [
    ("shardingRules", [(".*", None)]), ("meshShape", (1, 1)),
])
def test_unported_options_raise(flax_params, train_df, fitted, group_of_one, param, value):
    # the parameters are ported: inside a group of one, rules that leave
    # every weight replicated (the DP x TP step on a (1, 1) mesh) and a
    # mesh shape without rules (ignored, as the JAX estimator ignores it)
    # fit as the one-card fit does
    got = _estimator(flax_params, **{param: value}).fit(train_df)
    want = fitted[0]
    np.testing.assert_allclose(got._training_losses, want._training_losses, rtol=1e-6)
    for name, t in want.module.state_dict().items():
        np.testing.assert_allclose(got.module.state_dict()[name].numpy(), t.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_a_mesh_shape_needs_as_many_ranks(flax_params, train_df, group_of_one):
    from sparkdl_tpu_torch.parallel.tp import VIT_TP_RULES

    with pytest.raises(ValueError, match=r"meshShape \(1, 2\) needs 2 devices, have 1"):
        _estimator(flax_params, shardingRules=VIT_TP_RULES, meshShape=(1, 2)).fit(train_df)


def test_sharding_rules_need_a_process_group(flax_params, train_df):
    from sparkdl_tpu_torch.parallel.tp import VIT_TP_RULES

    with pytest.raises(ValueError, match="process group"):
        _estimator(flax_params, shardingRules=VIT_TP_RULES).fit(train_df)


def test_non_integral_labels_raise(flax_params, uris):
    session = TorchSession.builder.getOrCreate()
    df = session.createDataFrame([{"uri": u, "label": 0.5} for u in uris[:2]])
    with pytest.raises(ValueError, match="non-integral"):
        _estimator(flax_params).fit(df)


def test_unknown_loss_raises(flax_params, train_df):
    with pytest.raises(ValueError, match="no per-sample form"):
        _estimator(flax_params, loss="hinge").fit(train_df)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchImageFileEstimator(module=ViT(**GEOMETRY))


def test_seeded_init_is_deterministic_and_flax_shaped():
    from sparkdl_tpu_torch.estimators.torch_image_file_estimator import init_parameters

    a, b = ViT(**GEOMETRY), ViT(**GEOMETRY)
    init_parameters(a, 7)
    init_parameters(b, 7)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    state = a.state_dict()
    assert torch.count_nonzero(state["cls_token"]) == 0
    assert torch.all(state["blocks.0.ln_1.weight"] == 1)
    w = state["blocks.0.qkv.weight"]
    assert abs(w.std().item() - 192 ** -0.5) < 0.01
    assert w.abs().max().item() <= 2 * 192 ** -0.5 / 0.87962566103423978 + 1e-6


def test_converter_inverse_round_trips(flax_params):
    back = vit_flax_from_state_dict(vit_state_dict_from_flax(flax_params))
    _assert_trees_close(back, flax_params, atol=0, rtol=0)
    state = vit_state_dict_from_flax(flax_params)
    state["surplus"] = torch.zeros(2)
    with pytest.raises(KeyError, match="unused keys"):
        vit_flax_from_state_dict(state)


# -- checkpoint and resume ------------------------------------------------------

def _ckpt_estimator(flax_params, epochs, ckpt=None, **kw):
    kw.setdefault("fitParams", {"epochs": epochs, "batch_size": 4, "learning_rate": LR,
                                "seed": 0})
    return _estimator(flax_params, checkpointDir=ckpt, **kw)


def _assert_same_weights(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


@pytest.fixture(scope="module")
def straight_fits(flax_params, train_df):
    """Uninterrupted fits of 1, 2 and 4 epochs, without checkpoints."""
    return {e: _ckpt_estimator(flax_params, e).fit(train_df) for e in (1, 2, 4)}


def _namespaces(ckpt):
    return sorted(os.listdir(ckpt))


def test_checkpointed_fit_resumes(flax_params, train_df, straight_fits, tmp_path, caplog):
    ckpt = str(tmp_path / "ck")
    _ckpt_estimator(flax_params, 1, ckpt).fit(train_df)
    (ns,) = _namespaces(ckpt)
    assert ns.startswith("torch_fit_")
    assert sorted(os.listdir(os.path.join(ckpt, ns))) == ["epoch_1"]
    steps = metrics.counter("estimator.steps").value
    with caplog.at_level(logging.INFO, logger=CKPT_LOGGER):
        resumed = _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)
    assert "resuming from checkpoint epoch 1" in caplog.text
    assert metrics.counter("estimator.steps").value - steps == 2
    _assert_same_weights(resumed, straight_fits[2])
    assert resumed._training_losses == straight_fits[2]._training_losses[2:]
    assert resumed._training_loss == straight_fits[2]._training_loss


def test_refit_with_more_epochs_resumes_exactly(flax_params, train_df, straight_fits,
                                                tmp_path):
    ckpt = str(tmp_path / "ck")
    _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)
    (ns,) = _namespaces(ckpt)
    resumed = _ckpt_estimator(flax_params, 4, ckpt).fit(train_df)
    assert _namespaces(ckpt) == [ns]  # extended in place, not a fresh namespace
    assert sorted(os.listdir(os.path.join(ckpt, ns))) == [f"epoch_{e}" for e in (1, 2, 3, 4)]
    _assert_same_weights(resumed, straight_fits[4])


def test_refit_with_fewer_epochs_restores_exact_epoch(flax_params, train_df, straight_fits,
                                                      tmp_path, caplog):
    ckpt = str(tmp_path / "ck")
    _ckpt_estimator(flax_params, 4, ckpt).fit(train_df)
    steps = metrics.counter("estimator.steps").value
    with caplog.at_level(logging.INFO, logger=CKPT_LOGGER):
        two = _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)
    assert "already at epoch 2" in caplog.text
    assert metrics.counter("estimator.steps").value == steps  # nothing trained
    _assert_same_weights(two, straight_fits[2])
    four = straight_fits[4].module.state_dict()
    assert any(not torch.equal(t, four[n]) for n, t in two.module.state_dict().items())


def test_checkpoints_namespaced_by_fit_config(flax_params, train_df, tmp_path):
    ckpt = str(tmp_path / "shared")
    _ckpt_estimator(flax_params, 1, ckpt).fit(train_df)
    other = _estimator(flax_params, checkpointDir=ckpt, fitParams={
        "epochs": 1, "batch_size": 3, "learning_rate": LR, "seed": 0}).fit(train_df)
    assert len(_namespaces(ckpt)) == 2
    assert len(other._training_losses) == 2  # trained, not resumed


def test_namespace_stable_across_equal_objects_and_apart_for_others(flax_params):
    def namespace(**kw):
        return _ckpt_estimator(flax_params, 2, **kw)._ckpt_namespace()

    base = namespace()
    assert namespace() == base  # a new ViT and a new estimator
    assert namespace(fitParams={"epochs": 9, "batch_size": 4, "learning_rate": LR,
                                "seed": 0}) == base
    assert namespace(module=ViT(**GEOMETRY, attn_impl="full")) != base
    assert namespace(module=ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16)) != base
    assert namespace(optimizer="sgd") != base
    assert namespace(loss="categorical_crossentropy") != base
    assert namespace(labelCol="other") != base


class _SGDFactory:
    def __init__(self, lr):
        self.lr = lr

    def __call__(self, params):
        return torch.optim.SGD(params, lr=self.lr)


def test_namespace_sees_callable_state_and_bodies(flax_params):
    def namespace(optimizer):
        return _ckpt_estimator(flax_params, 2, optimizer=optimizer)._ckpt_namespace()

    assert namespace(_SGDFactory(0.1)) == namespace(_SGDFactory(0.1))
    assert namespace(_SGDFactory(0.1)) != namespace(_SGDFactory(0.2))
    assert namespace(_SGDFactory(0.1).__call__) != namespace(_SGDFactory(0.2).__call__)
    f1 = lambda params: torch.optim.SGD(params, lr=0.1)  # noqa: E731
    f2 = lambda params: torch.optim.Adam(params, lr=0.1)  # noqa: E731
    assert namespace(f1) != namespace(f2)

    def k1(params, *, lr=0.1):
        return torch.optim.SGD(params, lr=lr)

    def k2(params, *, lr=0.2):
        return torch.optim.SGD(params, lr=lr)

    k2.__qualname__ = k1.__qualname__
    assert namespace(k1) != namespace(k2)


def test_namespace_survives_hash_randomisation():
    prog = (
        "import numpy as np, torch\n"
        "from sparkdl_tpu_torch import TorchImageFileEstimator, ViT\n"
        "def opt(params, kind='sgd'):\n"
        "    if kind in {'sgd', 'adam', 'adamw', 'lion'}:\n"
        "        return torch.optim.SGD(params, lr=0.1)\n"
        "est = TorchImageFileEstimator(inputCol='uri', outputCol='out', labelCol='label',\n"
        "    imageLoader=np.load, optimizer=opt, device='cpu',\n"
        "    module=ViT('ViT-Ti/16', num_classes=4, image_size=32, attn_impl='flash'),\n"
        "    fitParams={'epochs': 2, 'batch_size': 4, 'tags': {'x', 'y', 'z'}})\n"
        "print(est._ckpt_namespace())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    outs = {
        subprocess.run([sys.executable, "-c", prog], env={**env, "PYTHONHASHSEED": seed},
                       capture_output=True, text=True, check=True, timeout=120).stdout
        for seed in ("1", "2")
    }
    assert len(outs) == 1 and next(iter(outs)).startswith("torch_fit_")


def test_different_initial_variables_namespace_apart(flax_params, train_df, tmp_path):
    ckpt = str(tmp_path / "ck")
    other = copy.deepcopy(flax_params)
    other["params"]["head"]["bias"] = other["params"]["head"]["bias"] + 1.0
    _ckpt_estimator(flax_params, 1, ckpt).fit(train_df)
    _ckpt_estimator(other, 1, ckpt).fit(train_df)
    assert len(_namespaces(ckpt)) == 2
    # the digest is of the weights, whatever form they come in
    assert _ckpt_estimator(vit_state_dict_from_flax(flax_params), 1)._ckpt_namespace() == \
        _ckpt_estimator(flax_params, 1)._ckpt_namespace()
    assert _ckpt_estimator(None, 1)._ckpt_namespace() != \
        _ckpt_estimator(flax_params, 1)._ckpt_namespace()


@pytest.mark.parametrize("site,at", [("estimator.step", 3), ("estimator.epoch", 1)],
                         ids=["mid_epoch", "epoch_boundary"])
def test_preemption_resumes_bit_identical(flax_params, train_df, straight_fits, tmp_path,
                                          caplog, site, at):
    """Mid-epoch: the flag set at global step 3 (epoch 2's first) is raised
    at the next step boundary, so epoch 2 never completes. At the epoch
    boundary: flagged after epoch 1's steps, before its save, and raised at
    epoch 2's first step. Either way exactly epoch 1 is committed, and a
    re-fit resumes to the uninterrupted fit."""
    ckpt = str(tmp_path / "ck")
    est = _ckpt_estimator(flax_params, 2, ckpt)
    with active_plan(FaultPlan().add(site, preempt=True, at=at)):
        with pytest.raises(Preempted, match=f"injected preemption at '{site}'"):
            est.fit(train_df)
    assert checkpointing.committed_epochs(ckpt, est._ckpt_namespace()) == [1]
    with caplog.at_level(logging.INFO, logger=CKPT_LOGGER):
        resumed = _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)
    assert "resuming from checkpoint epoch 1" in caplog.text
    _assert_same_weights(resumed, straight_fits[2])
    assert resumed._training_loss == straight_fits[2]._training_loss


def test_an_error_after_a_save_still_commits_it(flax_params, train_df, tmp_path):
    ckpt = str(tmp_path / "ck")
    est = _ckpt_estimator(flax_params, 2, ckpt)
    with active_plan(FaultPlan().add("estimator.checkpoint_saved", error=OSError, at=1)):
        with pytest.raises(OSError, match="injected fault"):
            est.fit(train_df)
    assert checkpointing.committed_epochs(ckpt, est._ckpt_namespace()) == [1]


def test_a_failed_commit_does_not_replace_a_preemption(flax_params, train_df, tmp_path,
                                                       caplog):
    """Epoch 1's commit fails behind the fit, and a preemption lands before
    the next save: the fit still raises ``Preempted`` (what a scheduler
    wrapper catches to requeue the job), with the commit's error logged and
    noted on it."""
    blocker = tmp_path / "file"
    blocker.write_text("a file where the checkpoint directory would go")
    est = _ckpt_estimator(flax_params, 2, str(blocker))
    with active_plan(FaultPlan().add("estimator.checkpoint_saved", preempt=True, at=1)):
        with pytest.raises(Preempted, match="injected preemption") as info:
            est.fit(train_df)
    assert any("checkpoint commit failed" in note for note in info.value.__notes__)
    assert "the last checkpoint commit failed" in caplog.text


def test_a_torn_epoch_is_not_resumed(flax_params, train_df, straight_fits, tmp_path, caplog):
    ckpt = str(tmp_path / "ck")
    est = _ckpt_estimator(flax_params, 1, ckpt)
    est.fit(train_df)
    torn = Path(checkpointing.epoch_path(ckpt, est._ckpt_namespace(), 2))
    torn.mkdir()
    (torn / checkpointing.PAYLOAD).write_bytes(b"torn")
    with caplog.at_level(logging.INFO, logger=CKPT_LOGGER):
        resumed = _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)
    assert "resuming from checkpoint epoch 1" in caplog.text
    _assert_same_weights(resumed, straight_fits[2])
    assert (torn / checkpointing.MARKER).is_file()  # epoch 2 saved over the torn one


def test_a_committed_epoch_that_does_not_load_raises(flax_params, train_df, tmp_path):
    ckpt = str(tmp_path / "ck")
    est = _ckpt_estimator(flax_params, 1, ckpt)
    est.fit(train_df)
    path = checkpointing.epoch_path(ckpt, est._ckpt_namespace(), 1)
    Path(path, checkpointing.PAYLOAD).write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match=path):
        _ckpt_estimator(flax_params, 2, ckpt).fit(train_df)


def test_the_snapshot_holds_the_epoch_boundary_weights(flax_params, train_df, straight_fits,
                                                       tmp_path, monkeypatch):
    """The async-read trap on the CPU: the writer of epoch 1 is held back
    until epoch 2's steps have updated the weights and adam's moments in
    place; epoch 1's checkpoint still holds the weights of epoch 1's end."""
    real_save = checkpointing.torch.save
    target = metrics.counter("estimator.steps").value + 4

    def late_save(obj, fh):
        deadline = time.monotonic() + 60
        while metrics.counter("estimator.steps").value < target and time.monotonic() < deadline:
            time.sleep(0.01)
        real_save(obj, fh)

    monkeypatch.setattr(checkpointing.torch, "save", late_save)
    ckpt = str(tmp_path / "ck")
    est = _ckpt_estimator(flax_params, 2, ckpt)
    est.fit(train_df)
    assert metrics.counter("estimator.steps").value >= target
    saved = checkpointing.restore_epoch(ckpt, est._ckpt_namespace(), 1)["model"]
    want = straight_fits[1].module.state_dict()
    for name, tensor in want.items():
        assert torch.equal(saved[name], tensor), name
