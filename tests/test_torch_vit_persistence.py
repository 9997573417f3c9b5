"""Persistence of the fitted ``TorchImageFileTransformer``, as the JAX
package's ``FlaxImageFileTransformer`` saves and loads.

The module is pickled (class and attributes) with its weights taken from
the CPU; ``batchSize``, ``features_only`` and ``device`` are kept. A loaded
stage transforms the same rows bit for bit (``np.array_equal``): the same
module on the same weights and inputs runs the same float operations. The
JAX round trip is the oracle of the form: the JAX transformer's rows before
and after its own save are equal too, and the port's rows equal the JAX
rows on the same weights at tests/test_ops.py's ViT tolerance.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.estimators.flax_image_file_estimator import (
    FlaxImageFileTransformer as JaxTransformer,
)
from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu.sql.session import TPUSession
from sparkdl_tpu_torch import TorchImageFileEstimator, TorchImageFileTransformer
from sparkdl_tpu_torch.ml.pipeline import Pipeline, PipelineModel
from sparkdl_tpu_torch.ml.util import load_stage
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.sql.session import TorchSession

GEOMETRY = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)
VIT_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
N_IMAGES = 5


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
def uris(tmp_path_factory):
    root = tmp_path_factory.mktemp("persist_images")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_IMAGES):
        path = str(root / f"img_{i}.npy")
        np.save(path, rng.rand(32, 32, 3).astype(np.float32))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def df(uris):
    return TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": i % 4} for i, u in enumerate(uris)], numPartitions=2)


@pytest.fixture(scope="module")
def flax_params():
    variables = JaxViT(**GEOMETRY).init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _rows(stage, df, col="out"):
    return np.stack([r[col].toArray() for r in stage.transform(df).collect()])


def _stage(flax_params, placed=False, **kw):
    module = ViT(**GEOMETRY, attn_impl="flash")
    state = vit_state_dict_from_flax(flax_params)
    if placed:
        module.load_state_dict(state)
        state = None
    return TorchImageFileTransformer(inputCol="uri", outputCol="out", imageLoader=np.load,
                                     module=module, state_dict=state, device="cpu", **kw)


@pytest.mark.parametrize("transformed_first", [False, True],
                         ids=["state_dict_not_loaded", "after_a_transform"])
def test_saved_transformer_loads_bit_for_bit(flax_params, df, tmp_path, transformed_first):
    """Saved before its first transform (the given ``state_dict`` applied
    first) or after one, the loaded stage gives the same rows bit for bit,
    with its params and extras."""
    stage = _stage(flax_params, batchSize=2, features_only=True)
    if transformed_first:
        _rows(stage, df)
    stage.save(str(tmp_path / "vit"))
    want = _rows(stage, df)
    loaded = TorchImageFileTransformer.load(str(tmp_path / "vit"))
    assert isinstance(loaded, TorchImageFileTransformer)
    assert (loaded.batchSize, loaded.features_only, loaded.device) == (2, True, torch.device("cpu"))
    assert (loaded.getInputCol(), loaded.getOutputCol()) == ("uri", "out")
    assert loaded.getImageLoader() is np.load and loaded.uid == stage.uid
    assert want.shape == (N_IMAGES, 192)
    np.testing.assert_array_equal(_rows(loaded, df), want)
    for name, t in stage.module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[name], t), name


def test_fitted_transformer_round_trips(flax_params, df, tmp_path):
    """A transformer returned by ``fit`` saves and loads; its rows match."""
    fitted = TorchImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        module=ViT(**GEOMETRY, attn_impl="flash"), initialVariables=flax_params,
        fitParams={"epochs": 1, "batch_size": 4, "seed": 0}, device="cpu",
    ).fit(df)
    fitted.save(str(tmp_path / "fitted"))
    loaded = load_stage(str(tmp_path / "fitted"))
    np.testing.assert_array_equal(_rows(loaded, df), _rows(fitted, df))


def test_bf16_transformer_round_trips(flax_params, df, tmp_path):
    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=np.load,
        module=ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16),
        state_dict=vit_state_dict_from_flax(flax_params), device="cpu")
    stage.save(str(tmp_path / "bf16"))
    loaded = TorchImageFileTransformer.load(str(tmp_path / "bf16"))
    assert loaded.module.dtype == torch.bfloat16
    np.testing.assert_array_equal(_rows(loaded, df), _rows(stage, df))


def test_pipeline_model_holding_the_stage_round_trips(flax_params, df, tmp_path):
    stage = _stage(flax_params, placed=True)
    model = PipelineModel([stage])
    model.save(str(tmp_path / "pm"))
    loaded = PipelineModel.load(str(tmp_path / "pm"))
    np.testing.assert_array_equal(_rows(loaded, df), _rows(model, df))
    pipeline = Pipeline(stages=[stage])
    pipeline.save(str(tmp_path / "p"))
    back = load_stage(str(tmp_path / "p"))
    np.testing.assert_array_equal(_rows(back.getStages()[0], df), _rows(stage, df))


def test_card_stage_loads_on_the_cpu_when_asked(flax_params, df, tmp_path):
    """A stage saved on the card records ``device: cuda``: without a card it
    loads only with ``device="cpu"``, and its weights were saved from the
    CPU, so it then runs there."""
    stage = _stage(flax_params)
    stage.save(str(tmp_path / "vit"))
    meta_path = tmp_path / "vit" / "metadata.json"
    meta = json.loads(meta_path.read_text())
    assert meta["extra"]["device"] == "cpu"
    meta["extra"]["device"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchImageFileTransformer.load(str(tmp_path / "vit"))
    loaded = TorchImageFileTransformer.load(str(tmp_path / "vit"), device="cpu")
    assert loaded.device == torch.device("cpu")
    np.testing.assert_array_equal(_rows(loaded, df), _rows(stage, df))
    payload = torch.load(str(tmp_path / "vit" / "torch_model.pt"), weights_only=False)
    assert all(t.device.type == "cpu" for t in payload["state_dict"].values())
    assert all(p.device.type == "meta" for p in payload["module"].parameters())


def _lambda_attention():
    return lambda q, k, v: v


def test_unpicklable_module_is_refused_before_the_disk(flax_params, tmp_path):
    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=np.load,
        module=ViT(**GEOMETRY, attn_impl=_lambda_attention()), device="cpu")
    with pytest.raises(ValueError, match="does not pickle"):
        stage.save(str(tmp_path / "bad"))
    assert not (tmp_path / "bad").exists()


def test_rows_match_the_jax_transformer_and_its_round_trip(flax_params, uris, df, tmp_path):
    """The port's loaded stage against the JAX stage (and the JAX stage
    after its own save and load) on the same weights."""
    jax_df = TPUSession.builder.getOrCreate().createDataFrame(
        [{"uri": u} for u in uris], numPartitions=2)
    jax_stage = JaxTransformer(inputCol="uri", outputCol="out", imageLoader=np.load,
                               module=JaxViT(**GEOMETRY), variables=flax_params)
    jax_rows = _rows(jax_stage, jax_df)
    jax_stage.save(str(tmp_path / "jax"))
    np.testing.assert_array_equal(_rows(JaxTransformer.load(str(tmp_path / "jax")), jax_df),
                                  jax_rows)
    stage = _stage(flax_params)
    stage.save(str(tmp_path / "port"))
    np.testing.assert_allclose(_rows(TorchImageFileTransformer.load(str(tmp_path / "port")), df),
                               jax_rows, **VIT_TOL)


def test_saved_directory_holds_the_module_file(flax_params, tmp_path):
    stage = _stage(flax_params)
    stage.save(str(tmp_path / "vit"))
    assert sorted(os.listdir(tmp_path / "vit")) == [
        "metadata.json", "param_imageLoader.pkl", "torch_model.pt"]
