"""The port's multi-process fits and transforms, on the cases of the JAX
package's ``tests/test_multihost.py``, in gloo groups of 2 CPU processes.

Each rank (``tests/torch_fixtures/parallel_workers.py``) joins the group
through ``runner.initialize`` (``SPARKDL_COORDINATOR`` and friends),
loads only its strided shard of the rows, and the estimators' steps
all-reduce. Oracles, as the JAX tests hold them:

- the ``KerasImageFileEstimator`` fit of a Dense model (full batch, so the
  gradient is the mean over the same rows however they are split) equals
  the same fit in this one process, and both ranks end identical; so does
  the streaming fit against the in-memory one;
- each rank transforms its own shard, and the shards put back together
  equal one transform of every row;
- a checkpointed fit whose rank 1 is killed mid-fit is started again as a
  fresh group and resumes from rank 0's committed epoch (the elastic
  restart);
- the DP x TP ViT fit (``VIT_TP_RULES`` at ``meshShape=(1, 2)``) equals the
  one-process fit, and the same configuration run again restores its
  committed epoch 2 instead of training;
- the batch-norm CNN: both ranks end with identical weights and moving
  statistics, equal to an oracle written here with Keras's
  ``stateless_call`` on JAX that normalizes each rank's batch on its own,
  takes the global mean gradient and averages the statistics.
"""

import os
import re
import sys
import time

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparkdl_tpu_torch.estimators import KerasImageFileEstimator, TorchImageFileEstimator  # noqa: E402
from sparkdl_tpu_torch.models import vit as port_vit  # noqa: E402
from sparkdl_tpu_torch.models.keras_model import read_keras_file  # noqa: E402
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
import parallel_workers as pw  # noqa: E402
from dist_launch import Group, run_group  # noqa: E402

N_ROWS, DIM = 16, 4
FIT_PARAMS = {"epochs": 3, "batch_size": N_ROWS, "learning_rate": 0.05, "seed": 0}
BN_IMG = 4
BN_FIT_PARAMS = {"epochs": 2, "batch_size": N_ROWS, "learning_rate": 0.05, "seed": 0}
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
VARIANT = "ViT-mh-test"
GEOMETRY = (8, 64, 2, 2, 128)
TP_IMAGE, TP_ROWS = 16, 8
TP_FIT_PARAMS = {"epochs": 2, "batch_size": TP_ROWS, "learning_rate": 0.05, "seed": 0}
TP_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The Dense model, the BN CNN and the tiny ViT's rows, on disk."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.RandomState(42)
    w_true = rng.randn(DIM).astype(np.float32)
    rows = []
    for i in range(N_ROWS):
        v = rng.randn(DIM).astype(np.float32)
        np.save(d / f"x_{i}.npy", v)
        rows.append((str(d / f"x_{i}.npy"), [float(v @ w_true)]))
    keras.utils.set_random_seed(7)
    keras.Sequential([keras.layers.Input(shape=(DIM,)), keras.layers.Dense(1)]).save(
        str(d / "model.keras"))

    rng = np.random.RandomState(11)
    w_img = rng.randn(BN_IMG * BN_IMG * 3).astype(np.float32)
    bn_rows = []
    for i in range(N_ROWS):
        v = rng.rand(BN_IMG, BN_IMG, 3).astype(np.float32)
        np.save(d / f"bn_{i}.npy", v)
        bn_rows.append((str(d / f"bn_{i}.npy"), [float(v.reshape(-1) @ w_img)]))
    keras.utils.set_random_seed(5)
    keras.Sequential([
        keras.layers.Input(shape=(BN_IMG, BN_IMG, 3)),
        keras.layers.Conv2D(4, 3, padding="same"),
        keras.layers.BatchNormalization(),
        keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(1),
    ]).save(str(d / "bn_model.keras"))

    rng = np.random.RandomState(3)
    vit_rows = []
    for i in range(TP_ROWS):
        v = rng.rand(TP_IMAGE, TP_IMAGE, 3).astype(np.float32)
        v[:8, :8] += 0.7 * (i % 2)
        np.save(d / f"img_{i}.npy", v)
        vit_rows.append((str(d / f"img_{i}.npy"), i % 2))
    return {"dir": str(d), "rows": rows, "bn_rows": bn_rows, "vit_rows": vit_rows}


def tp_kwargs(workdir, initial):
    return dict(rows=workdir["vit_rows"], variant=VARIANT, geometry=GEOMETRY, num_classes=2,
                image_size=TP_IMAGE, fit_params=TP_FIT_PARAMS, initial=initial,
                mesh_shape=(1, 2), checkpoint_dir=os.path.join(workdir["dir"], "tp_ckpt"),
                dp=False)


@pytest.fixture(scope="module")
def vit_initial():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        from sparkdl_tpu_torch.estimators.torch_image_file_estimator import init_parameters

        module = port_vit.ViT(VARIANT, num_classes=2, image_size=TP_IMAGE)
        init_parameters(module, 0)
        yield {k: v.clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def phases(workdir, vit_initial, tmp_path_factory):
    return run_group(2, "parallel_workers:keras_phases", str(tmp_path_factory.mktemp("mh")),
                     model_dir=workdir["dir"], rows=workdir["rows"], bn_rows=workdir["bn_rows"],
                     fit_params=FIT_PARAMS, bn_fit_params=BN_FIT_PARAMS,
                     tp=tp_kwargs(workdir, vit_initial))


def frame(rows):
    return TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": l} for u, l in rows])


def one_process_keras_fit(workdir, params, model="model.keras", rows="rows"):
    fitted = KerasImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        modelFile=os.path.join(workdir["dir"], model), kerasOptimizer="sgd", kerasLoss="mse",
        kerasFitParams=dict(params), device="cpu").fit(frame(workdir[rows]))
    return pw.flat_weights(read_keras_file(fitted.getModelFile())[1])


def assert_ranks_identical(phases, key):
    for name, want in phases[0][key].items():
        np.testing.assert_array_equal(phases[1][key][name], want, err_msg=str(name))


@pytest.mark.parametrize("key", ["fit", "streaming"])
def test_two_process_fit_matches_single_process(phases, workdir, key):
    assert_ranks_identical(phases, key)
    want = one_process_keras_fit(workdir, FIT_PARAMS)
    assert set(phases[0][key]) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(phases[0][key][name], w, err_msg=str(name), **FIT_TOL)


def test_two_process_transform_shards_match_single_process(phases, workdir):
    t = KerasImageFileTransformer(inputCol="uri", outputCol="out",
                                  modelFile=os.path.join(workdir["dir"], "model.keras"),
                                  imageLoader=np.load, device="cpu")
    df = TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u} for u, _ in workdir["rows"]])
    oracle = np.stack([np.asarray(r["out"].toArray()) for r in t.transform(df).collect()])
    got = np.full_like(oracle, np.nan)
    covered = np.zeros(N_ROWS, bool)
    for result in phases:
        got[result["transform"]["indices"]] = result["transform"]["outputs"]
        covered[result["transform"]["indices"]] = True
    assert covered.all(), "the ranks' shards must cover every row"
    assert len(phases[0]["transform"]["indices"]) == N_ROWS // 2
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_two_process_gspmd_tp_fit_matches_single_process(phases, workdir, vit_initial):
    for result in phases[1:]:
        for name, want in phases[0]["tp"]["tp"]["weights"].items():
            np.testing.assert_array_equal(result["tp"]["tp"]["weights"][name], want, err_msg=name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        one = TorchImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
            module=port_vit.ViT(VARIANT, num_classes=2, image_size=TP_IMAGE), optimizer="sgd",
            fitParams=dict(TP_FIT_PARAMS), initialVariables=vit_initial, device="cpu",
        ).fit(frame(workdir["vit_rows"]))
    got = phases[0]["tp"]["tp"]
    np.testing.assert_allclose(got["losses"], one._training_losses, **TP_TOL)
    for name, t in one.module.state_dict().items():
        np.testing.assert_allclose(got["weights"][name], t.numpy(), err_msg=name, **TP_TOL)


@pytest.fixture(scope="module")
def restarted(workdir, vit_initial, phases, tmp_path_factory):
    """The elastic restart: a checkpointed 300-epoch group, rank 1 killed
    once an epoch is committed, then a fresh group with the same
    configuration, which also re-runs the DP x TP fit of ``phases``."""
    ckpt = os.path.join(workdir["dir"], "elastic_ckpt")
    params = dict(FIT_PARAMS, epochs=300)
    work = str(tmp_path_factory.mktemp("elastic"))
    first = Group(2, "parallel_workers:keras_checkpointed_fit",
                  dict(model_dir=workdir["dir"], rows=workdir["rows"], fit_params=params,
                       checkpoint_dir=ckpt), work, name="phase1")
    try:
        deadline = time.monotonic() + 100
        seen = False
        while time.monotonic() < deadline and not seen:
            for _root, dirs, _files in os.walk(ckpt):
                seen = seen or any(re.fullmatch(r"epoch_\d+", d) for d in dirs)
            dead = [r for r, p in enumerate(first.procs) if p.poll() is not None]
            assert not dead, f"rank {dead} ended before any checkpoint:\n{first.log(dead[0])}"
            time.sleep(0.05)
        assert seen, "no checkpoint appeared"
        first.procs[1].kill()
        first.procs[1].wait(timeout=60)
    finally:
        first.kill()
    return run_group(2, "parallel_workers:keras_checkpointed_fit", work, model_dir=workdir["dir"],
                     rows=workdir["rows"], fit_params=params, checkpoint_dir=ckpt,
                     tp=tp_kwargs(workdir, vit_initial))


def test_elastic_restart_resumes_multihost_fit(restarted):
    for result in restarted:
        assert result["resumed"] and result["resumed"][0] > 0, result["resumed"]
    assert restarted[0]["resumed"] == restarted[1]["resumed"]
    for name, want in restarted[0]["weights"].items():
        np.testing.assert_array_equal(restarted[1]["weights"][name], want, err_msg=str(name))


def test_two_process_gspmd_tp_checkpoint_resume(restarted, phases):
    for result in restarted:
        assert result["tp_resumed"] == [2], result["tp_resumed"]
        assert result["tp"]["tp"]["losses"] == []
        for name, want in phases[0]["tp"]["tp"]["weights"].items():
            np.testing.assert_array_equal(result["tp"]["tp"]["weights"][name], want, err_msg=name)


def test_two_process_bn_cnn_fit_exact_oracle(phases, workdir):
    assert_ranks_identical(phases, "bn")
    nprocs, n_rows = 2, N_ROWS
    per_rank = n_rows // nprocs
    x_all = np.stack([np.load(u) for u, _ in workdir["bn_rows"]])
    y_all = np.asarray([l for _, l in workdir["bn_rows"]], np.float32)
    oracle = keras.saving.load_model(os.path.join(workdir["dir"], "bn_model.keras"),
                                     compile=False)
    trainable = [jnp.asarray(v.value) for v in oracle.trainable_variables]
    non_trainable = [jnp.asarray(v.value) for v in oracle.non_trainable_variables]
    seed, lr = BN_FIT_PARAMS["seed"], BN_FIT_PARAMS["learning_rate"]
    host_rows = [np.arange(pid, n_rows, nprocs) for pid in range(nprocs)]
    rngs = [np.random.RandomState((seed * 7919 + pid) % 2**32) for pid in range(nprocs)]
    for _ in range(BN_FIT_PARAMS["epochs"]):
        orders = [r.permutation(len(h)) for r, h in zip(rngs, host_rows)]
        global_idx = np.concatenate([h[o] for h, o in zip(host_rows, orders)])
        xb, yb = jnp.asarray(x_all[global_idx]), jnp.asarray(y_all[global_idx])

        def global_loss(tr):
            nts, total = [], 0.0
            for d in range(nprocs):
                sl = slice(d * per_rank, (d + 1) * per_rank)
                out, new_nt = oracle.stateless_call(tr, non_trainable, xb[sl], training=True)
                total = total + ((yb[sl] - out) ** 2).mean(axis=-1).sum()
                nts.append(new_nt)
            mean_nt = [jnp.mean(jnp.stack(vs), axis=0)
                       if jnp.issubdtype(vs[0].dtype, jnp.floating) else vs[0]
                       for vs in zip(*nts)]
            return total / n_rows, mean_nt

        (_, non_trainable), grads = jax.value_and_grad(global_loss, has_aux=True)(trainable)
        trainable = [t - lr * g for t, g in zip(trainable, grads)]
    for var, val in zip(oracle.trainable_variables, trainable):
        var.assign(np.asarray(val))
    for var, val in zip(oracle.non_trainable_variables, non_trainable):
        var.assign(np.asarray(val))
    want = {(layer.name, i): np.asarray(w) for layer in oracle.layers
            for i, w in enumerate(layer.get_weights())}
    got = phases[0]["bn"]
    assert set(got) == set(want)
    initial = keras.saving.load_model(os.path.join(workdir["dir"], "bn_model.keras"),
                                      compile=False)
    start = {(layer.name, i): np.asarray(w) for layer in initial.layers
             for i, w in enumerate(layer.get_weights())}
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=str(key), rtol=1e-4, atol=1e-5)
    # the moving statistics moved off their start (mean 0, variance 1)
    bn = [k for k in want if "batch_normalization" in k[0] and k[1] >= 2]
    assert bn and any(not np.allclose(got[k], start[k], atol=1e-7) for k in bn)
