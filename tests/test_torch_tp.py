"""The port's DP x TP ViT fits against its DP fit and the JAX package's
``shardingRules=VIT_TP_RULES`` fit, in gloo groups of CPU processes.

A tiny ViT (patch 8, width 64, 2 blocks, 2 heads of 32, image 16,
registered in both packages) trains 2 full-batch SGD epochs over 8 rows
from the JAX package's PRNGKey(0) weights, carried across by
``vit_state_dict_from_flax``. Each group
(``tests/torch_fixtures/parallel_workers.py::vit_fits``) fits the same
estimator data-parallel and with ``shardingRules=VIT_TP_RULES`` at
``meshShape`` ``(1, 2)`` (2 ranks: ``qkv`` split by head group, one head a
rank) and ``(2, 2)`` (4 ranks). Full batches make the gradient independent
of how the rows are split. Held, at the JAX estimator's own TP bound
(``tests/test_flax_estimator.py``: rtol 5e-3, atol 5e-4), to the group's DP
fit and to ``FlaxImageFileEstimator`` with ``VIT_TP_RULES`` on a 2- or
4-device CPU mesh; every rank ends with the same weights. The (1, 2) fit
checkpoints: its committed epoch holds the unsharded layout, and a fit on
one process resumes from it; an adam fit checkpointed at epoch 1 (moments
gathered, then split again) and resumed to epoch 2 equals two epochs
uninterrupted bit for bit. Each group also fits DP with sequence-parallel
attention over all its ranks (``pad_tokens_for_sp``: Ulysses-flash at 2
ranks, ring at 4), every rank attending with its own rows; held to the
same fit on one process and to the JAX one-device fit.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.estimators import FlaxImageFileEstimator
from sparkdl_tpu.models import vit as jax_vit
from sparkdl_tpu.parallel.tp import VIT_TP_RULES as JAX_VIT_TP_RULES
from sparkdl_tpu.parallel.trainer import device_slice
from sparkdl_tpu.sql.session import TPUSession
from sparkdl_tpu_torch.estimators import TorchImageFileEstimator
from sparkdl_tpu_torch.models import vit as port_vit
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.sql.session import TorchSession

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
from dist_launch import run_group  # noqa: E402

VARIANT = "ViT-tp-test"
GEOMETRY = (8, 64, 2, 2, 128)
IMAGE, CLASSES, ROWS = 16, 2, 8
FIT_PARAMS = {"epochs": 2, "batch_size": ROWS, "learning_rate": 0.05, "seed": 0}
TP_TOL = dict(rtol=5e-3, atol=5e-4)
SHAPES = ((2, (1, 2)), (4, (2, 2)))
#: each group's sequence-parallel DP fit: Ulysses needs the 2 heads to
#: divide by the group's size
SP_IMPLS = {(1, 2): "ulysses-flash", (2, 2): "ring"}
#: the SP fit against the same fit on one process: the same sums in
#: another order
SP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def variant():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        mp.setitem(port_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        yield VARIANT


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_rows")
    rng = np.random.RandomState(3)
    out = []
    for i in range(ROWS):
        v = rng.rand(IMAGE, IMAGE, 3).astype(np.float32)
        v[:8, :8] += 0.7 * (i % 2)
        path = str(d / f"img_{i}.npy")
        np.save(path, v)
        out.append((path, i % 2))
    return out


@pytest.fixture(scope="module")
def flax_params(variant):
    module = jax_vit.ViT(variant=variant, num_classes=CLASSES, image_size=IMAGE)
    return module.init(jax.random.PRNGKey(0), np.zeros((1, IMAGE, IMAGE, 3), np.float32))


@pytest.fixture(scope="module")
def groups(variant, rows, flax_params, tmp_path_factory):
    initial = vit_state_dict_from_flax(flax_params)
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    out = {}
    for world, shape in SHAPES:
        out[shape] = run_group(
            world, "parallel_workers:vit_fits", str(tmp_path_factory.mktemp(f"tp{world}")),
            rows=rows, variant=variant, geometry=GEOMETRY, num_classes=CLASSES,
            image_size=IMAGE, fit_params=FIT_PARAMS, initial=initial, mesh_shape=shape,
            checkpoint_dir=ckpt if shape == (1, 2) else None,
            resume_dir=str(tmp_path_factory.mktemp("tp_resume")) if shape == (1, 2) else None,
            # the (2, 2) fits take the optimizer's multi-tensor update, as a
            # card does by default: DTensor and plain parameters apart
            foreach=shape == (2, 2), sp_impl=SP_IMPLS[shape])
    out["ckpt"] = ckpt
    return out


def jax_fit(variant, rows, flax_params, shape, **kw):
    df = TPUSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": int(l)} for u, l in rows])
    with device_slice(jax.devices()[:shape[0] * shape[1]]):
        fitted = FlaxImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
            module=jax_vit.ViT(variant=variant, num_classes=CLASSES, image_size=IMAGE),
            optimizer="sgd", fitParams=dict(FIT_PARAMS), initialVariables=flax_params, **kw,
        ).fit(df)
    return {k: v.numpy() for k, v in vit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, fitted.variables)).items()}


def jax_tp_fit(variant, rows, flax_params, shape):
    return jax_fit(variant, rows, flax_params, shape, shardingRules=JAX_VIT_TP_RULES,
                   meshShape=shape)


@pytest.mark.parametrize("shape", [s for _, s in SHAPES], ids=str)
def test_tp_fit_matches_the_dp_fit(groups, shape):
    for rank, result in enumerate(groups[shape]):
        np.testing.assert_allclose(result["tp"]["losses"], result["dp"]["losses"], **TP_TOL)
        for name, want in result["dp"]["weights"].items():
            np.testing.assert_allclose(result["tp"]["weights"][name], want,
                                       err_msg=f"{name}, rank {rank}", **TP_TOL)


@pytest.mark.parametrize("shape", [s for _, s in SHAPES], ids=str)
def test_tp_ranks_end_with_the_same_weights(groups, shape):
    first = groups[shape][0]["tp"]["weights"]
    for result in groups[shape][1:]:
        for name, want in first.items():
            np.testing.assert_array_equal(result["tp"]["weights"][name], want, err_msg=name)


@pytest.mark.parametrize("shape", [s for _, s in SHAPES], ids=str)
def test_tp_fit_matches_the_jax_tp_fit(groups, variant, rows, flax_params, shape):
    want = jax_tp_fit(variant, rows, flax_params, shape)
    got = groups[shape][0]["tp"]["weights"]
    assert set(got) == set(want)
    moved = 0
    initial = vit_state_dict_from_flax(flax_params)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TP_TOL)
        moved += not np.allclose(want[name], initial[name].numpy(), atol=1e-7)
    assert moved, "the fits never left their initial weights"


def test_tp_checkpoint_holds_the_unsharded_layout(groups, variant, rows, flax_params):
    root = groups["ckpt"]
    (namespace,) = os.listdir(root)
    payload = torch.load(os.path.join(root, namespace, "epoch_2", "payload.pt"),
                         weights_only=True)
    unsharded = port_vit.ViT(variant, num_classes=CLASSES, image_size=IMAGE).state_dict()
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == \
        {k: tuple(v.shape) for k, v in unsharded.items()}
    fitted = groups[(1, 2)][0]["tp"]["weights"]
    for name, t in payload["model"].items():
        np.testing.assert_array_equal(t.numpy(), fitted[name], err_msg=name)
    # a fit on one process, no group, resumes from the TP fit's epoch 2
    resumed = TorchImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=port_vit.ViT(variant, num_classes=CLASSES, image_size=IMAGE),
        optimizer="sgd", fitParams=dict(FIT_PARAMS),
        initialVariables=vit_state_dict_from_flax(flax_params), checkpointDir=root,
        device="cpu",
    ).fit(TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": l} for u, l in rows]))
    assert resumed._training_losses == []
    for name, t in resumed.module.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), fitted[name], err_msg=name)


def test_tp_adam_fit_resumes_bit_for_bit(groups):
    for result in groups[(1, 2)]:
        resumed, straight = result["resumed"], result["straight"]
        assert len(resumed["losses"]) == len(straight["losses"]) // 2
        assert resumed["losses"] == straight["losses"][len(resumed["losses"]):]
        for name, want in straight["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][name], want, err_msg=name)


@pytest.mark.parametrize("shape", [s for _, s in SHAPES], ids=str)
def test_sp_dp_fit_matches_one_process_and_jax(groups, variant, rows, flax_params, shape):
    """A DP fit whose attention is sequence-parallel over the same ranks:
    every rank holds its own rows, and the attention still keeps each image
    to its own tokens. Held to the one-process fit (the flash kernels'
    plain version for ``ulysses-flash``) and to the JAX one-device fit."""
    impl = SP_IMPLS[shape]
    initial = vit_state_dict_from_flax(flax_params)
    one = TorchImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=port_vit.ViT(variant, num_classes=CLASSES, image_size=IMAGE,
                            attn_impl="flash" if impl == "ulysses-flash" else "full"),
        optimizer="sgd", fitParams=dict(FIT_PARAMS), initialVariables=initial, device="cpu",
    ).fit(TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": l} for u, l in rows]))
    want_jax = jax_fit(variant, rows, flax_params, (1, 1))
    for rank, result in enumerate(groups[shape]):
        got = result["sp"]
        np.testing.assert_allclose(got["losses"], one._training_losses, **SP_TOL)
        for name, t in one.module.state_dict().items():
            np.testing.assert_allclose(got["weights"][name], t.numpy(),
                                       err_msg=f"{name}, rank {rank}", **SP_TOL)
            np.testing.assert_allclose(got["weights"][name], want_jax[name],
                                       err_msg=f"{name}, rank {rank}", **TP_TOL)
