"""The port's ViT fine-tuning in bfloat16 against the JAX package's.

``TorchImageFileEstimator(module=ViT(..., attn_impl="flash",
dtype=torch.bfloat16))`` against ``FlaxImageFileEstimator(module=ViT(...,
dtype=jnp.bfloat16, attn_impl=flash_attention))`` (the Pallas kernels in
interpret mode on the CPU), with the same Flax-initialised weights, rows,
loader and seed. The JAX fit runs on one device (``device_slice``): its
8-device step on the virtual CPU mesh is data-parallel, and the reference's
own DP gradient test fails. Geometry: a tiny ViT registered in both
packages' ``VIT_VARIANTS`` for the test (patch 8, dim 64, depth 2, 2 heads,
MLP 128) at 32x32.

Both packages keep float32 parameters and optimizer state and compute the
forward in bfloat16; they round in other places (the JAX CE runs
``log_softmax`` on bf16 logits, the port's in float32 on the widened
logits), so they are held at bf16 tolerances:

- the first step's gradients, each leaf within ``BF16_GRAD_RTOL`` of the
  JAX bf16 gradient's norm (floored at 1e-3 of the largest norm). The JAX
  bf16 gradients themselves lie up to 3.0e-2 of their norm from a float32
  gradient at this geometry (measured): the bound is bf16's own error;
- each step's loss (one epoch of one step each, the JAX estimator logging
  every epoch's loss to 4 decimals) within ``atol=2e-2, rtol=2e-2``;
- after 3 adam steps, each leaf's change from the start within
  ``BF16_LEAF_RTOL`` of the JAX change's norm, the key bias left out (its
  gradient is zero in exact arithmetic, so adam steps it on the sign of
  float noise). Adam moves each weight by about ``lr`` whatever its
  gradient's size, so a weight whose gradient lies within bf16's 3% of
  zero moves on the sign of a rounding: the leaves differ by 0.9-13.8%
  (measured), and a float32 fit of the port lies as far from the JAX bf16
  fit (up to 14%). The bound still fails a leaf left unmoved (1.0) or
  moved the other way (2.0).
"""

import logging
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sparkdl_tpu.estimators.flax_image_file_estimator import FlaxImageFileEstimator
from sparkdl_tpu.models import vit as jax_vit
from sparkdl_tpu.ops import flash_attention as jax_flash_attention
from sparkdl_tpu.parallel.trainer import device_slice
from sparkdl_tpu.sql.session import TPUSession
from sparkdl_tpu_torch import TorchImageFileEstimator
from sparkdl_tpu_torch.models import vit as port_vit
from sparkdl_tpu_torch.models.convert import vit_flax_from_state_dict, vit_state_dict_from_flax
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step
from sparkdl_tpu_torch.estimators.losses import get_optimizer
from sparkdl_tpu_torch.sql.session import TorchSession

TINY = (8, 64, 2, 2, 128)  # patch, dim, depth, heads, mlp_dim
GEOMETRY = dict(variant="tiny-test", num_classes=3, image_size=32)
N_IMAGES = 8
EPOCHS = 3
LR = 1e-3
BF16_LOSS_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_GRAD_RTOL = 5e-2
BF16_LEAF_RTOL = 0.25
# flash gradients of unit order, port against JAX, both bf16: each side
# rounds its gradients to bf16 once (2**-9 relative) from float32 sums taken
# in another order
BF16_ATTN_GRAD_TOL = dict(atol=1e-2, rtol=2e-2)
JAX_LOGGER = "sparkdl_tpu.estimators.flax_image_file_estimator"


@pytest.fixture(autouse=True, scope="module")
def _tiny_variant():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_VARIANTS, "tiny-test", TINY)
        mp.setitem(port_vit.VIT_VARIANTS, "tiny-test", TINY)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(3).rand(N_IMAGES, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def labels():
    return (np.arange(N_IMAGES) % 3).astype(np.int32)


@pytest.fixture(scope="module")
def rows(tmp_path_factory, images, labels):
    root = tmp_path_factory.mktemp("bf16_images")
    out = []
    for i, (img, label) in enumerate(zip(images, labels)):
        path = str(root / f"img_{i}.npy")
        np.save(path, img)
        out.append({"uri": path, "label": int(label)})
    return out


@pytest.fixture(scope="module")
def flax_params(images):
    variables = jax_vit.ViT(**GEOMETRY).init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    return jax.tree_util.tree_map(np.asarray, variables)


FIT_PARAMS = {"epochs": EPOCHS, "batch_size": N_IMAGES, "learning_rate": LR, "seed": 0}


@pytest.fixture(scope="module")
def jax_fit(rows, flax_params):
    """The JAX bf16 fit on one device: each epoch's loss (from its log) and
    the tuned parameters."""
    df = TPUSession.builder.getOrCreate().createDataFrame(rows)
    estimator = FlaxImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=jax_vit.ViT(**GEOMETRY, dtype=jnp.bfloat16, attn_impl=jax_flash_attention),
        optimizer="adam", fitParams=dict(FIT_PARAMS), initialVariables=flax_params,
    )
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(JAX_LOGGER)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with device_slice(jax.devices()[:1]):
            fitted = estimator.fit(df)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    losses = [float(m.group(1)) for r in records
              if (m := re.match(r"epoch \d+/\d+ loss=([-\d.]+)", r.getMessage()))]
    return losses, jax.tree_util.tree_map(np.asarray, fitted.variables)


@pytest.fixture(scope="module")
def port_fit(rows, flax_params):
    df = TorchSession.builder.getOrCreate().createDataFrame(rows)
    module = ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16)
    estimator = TorchImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=module, optimizer="adam", fitParams=dict(FIT_PARAMS),
        initialVariables=flax_params, device="cpu",
    )
    return estimator.fit(df)


def test_bf16_first_step_gradients_match_jax(flax_params, images, labels):
    """The training step's loss and gradients on 8 images, bf16 flash on
    both sides, the JAX side as its estimator's per-sample CE (optax on the
    bf16 logits)."""
    def jax_loss(params):
        logits = jax_vit.ViT(**GEOMETRY, dtype=jnp.bfloat16,
                             attn_impl=jax_flash_attention).apply(params, jnp.asarray(images))
        per = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return (per * 1.0).sum() / len(labels)

    want_loss, want = jax.value_and_grad(jax_loss)(flax_params)
    model = ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16)
    model.load_state_dict(vit_state_dict_from_flax(flax_params), strict=True)
    state = init_train_state(model.train(), get_optimizer("adam", LR))
    step = make_train_step(TorchImageFileEstimator(device="cpu")._per_sample_loss())
    _, loss = step(state, {"x": torch.from_numpy(images), "y": torch.from_numpy(labels),
                           "w": torch.ones(len(labels))})
    np.testing.assert_allclose(loss.item(), float(want_loss), **BF16_LOSS_TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(vit_flax_from_state_dict(
        {name: p.grad for name, p in model.named_parameters()})))
    norms = {path: float(np.linalg.norm(np.asarray(g, np.float32)))
             for path, g in jax.tree_util.tree_leaves_with_path(want)}
    floor = 1e-3 * max(norms.values())
    for path, g in jax.tree_util.tree_leaves_with_path(want):
        err = np.linalg.norm(got[path] - np.asarray(g, np.float32)) / max(norms[path], floor)
        assert err <= BF16_GRAD_RTOL, f"{jax.tree_util.keystr(path)}: {err:.3e}"


def test_bf16_fit_losses_match_jax(jax_fit, port_fit):
    want, _ = jax_fit
    got = port_fit._training_losses
    assert len(want) == len(got) == EPOCHS
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BF16_LOSS_TOL)


def test_bf16_fit_leaf_changes_match_jax(jax_fit, port_fit, flax_params):
    _, want = jax_fit
    got = vit_flax_from_state_dict(port_fit.module.state_dict())
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_start = dict(jax.tree_util.tree_leaves_with_path(flax_params))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        name = jax.tree_util.keystr(path)
        w, s = flat_want[path], flat_start[path]
        parts = {name: slice(None)}
        if name.endswith("['qkv']['bias']"):  # without the key third
            third = g.shape[-1] // 3
            parts = {f"{name}[q]": slice(0, third), f"{name}[v]": slice(2 * third, None)}
        for part_name, part in parts.items():
            moved, oracle = (g - s)[..., part], (w - s)[..., part]
            err = np.linalg.norm(moved - oracle) / np.linalg.norm(oracle)
            assert err <= BF16_LEAF_RTOL, f"{part_name}: {err:.3e}"


def test_bf16_fit_keeps_float32_weights_and_adam_state(flax_params, images, labels):
    """Parameters, their gradients and both adam moments stay float32; the
    forward computes in bf16; the loss comes back float32."""
    model = ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16)
    model.load_state_dict(vit_state_dict_from_flax(flax_params), strict=True)
    model.train()
    with torch.no_grad():
        assert model(torch.from_numpy(images[:2])).dtype == torch.bfloat16
    state = init_train_state(model, get_optimizer("adam", LR))
    step = make_train_step(TorchImageFileEstimator(device="cpu")._per_sample_loss())
    batch = {"x": torch.from_numpy(images[:4]), "y": torch.from_numpy(labels[:4]),
             "w": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    state, loss = step(state, batch)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    moments = [t for s in state.opt_state.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy"])
def test_bf16_per_sample_losses_are_float32(loss, flax_params, images, labels):
    """A bf16 module's per-sample losses are float32 whatever the loss, so
    the weighted mean over them is never taken in bf16."""
    model = ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16)
    model.load_state_dict(vit_state_dict_from_flax(flax_params), strict=True)
    y = torch.from_numpy(labels[:4])
    if loss != "sparse_categorical_crossentropy":
        y = torch.nn.functional.one_hot(y.long(), 3).float()
    per = TorchImageFileEstimator(loss=loss, device="cpu")._per_sample_loss()(
        model, {"x": torch.from_numpy(images[:4]), "y": y})
    assert per.shape == (4,) and per.dtype == torch.float32


def test_bf16_attention_keeps_lse_and_delta_float32():
    """In bf16 the flash forward's lse and the backward's ``delta`` stay
    float32 (the JAX kernels' f32 softmax statistics), and the gradients
    that reach q, k and v are of their type; the JAX flash gradients agree
    at the kernels' bf16 bound."""
    from sparkdl_tpu_torch.ops.flash_attention import attention_delta, flash_attention

    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 17, 2, 32).astype(np.float32))
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    do = torch.from_numpy(rng.randn(2, 17, 2, 32).astype(np.float32)).to(torch.bfloat16)
    assert attention_delta(out, do).dtype == torch.float32
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert all(g.dtype == torch.bfloat16 for g in grads)

    def jax_out(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_)

    as_jax = [jnp.asarray(t.detach().float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    _, vjp = jax.vjp(jax_out, *as_jax)
    want = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   **BF16_ATTN_GRAD_TOL)
