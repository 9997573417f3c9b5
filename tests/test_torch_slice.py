"""The port's image-file inference slice against the JAX package's, and the
port's contract: no JAX, the card unless the CPU is asked for, and the
loader's one-shape rule.

``FlaxImageFileTransformer.transform`` and
``TorchImageFileTransformer(device="cpu").transform`` run over the same URIs,
loader and Flax weights. The JAX side runs its dense attention, the plain
reference of its Pallas kernel; the port runs ``attn_impl="flash"``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.estimators import FlaxImageFileTransformer
from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu.transformers.utils import (
    make_loader_decode_plan as jax_make_loader_decode_plan,
)
from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.transformers.utils import (
    make_loader_decode_plan,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.metrics import metrics

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sparkdl_tpu_torch"
TOL = dict(atol=5e-4, rtol=5e-3)
GEOMETRY = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)
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


def _loader(uri):
    return np.load(uri)


@pytest.fixture(scope="module")
def uris(tmp_path_factory):
    root = tmp_path_factory.mktemp("npy_images")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_IMAGES):
        path = str(root / f"img_{i}.npy")
        np.save(path, rng.rand(32, 32, 3).astype(np.float32))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def flax_variables():
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = JaxViT(**GEOMETRY).init(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize(
    "batch_size,features_only",
    [(N_IMAGES + 1, False), (2, True)],
    ids=["one_ragged_chunk_logits", "three_chunks_features"],
)
def test_transform_matches_jax(
    tpu_session, uris, flax_variables, batch_size, features_only
):
    jax_stage = FlaxImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=_loader,
        module=JaxViT(**GEOMETRY), variables=flax_variables,
        batchSize=batch_size, features_only=features_only,
    )
    jax_df = tpu_session.createDataFrame(
        [{"uri": u} for u in uris], numPartitions=1
    )
    want = jax_stage.transform(jax_df).collect()

    port_stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=_loader,
        module=ViT(**GEOMETRY, attn_impl="flash"),
        state_dict=vit_state_dict_from_flax(flax_variables),
        batchSize=batch_size, features_only=features_only, device="cpu",
    )
    session = TorchSession.builder.master("local[*]").appName("tests").getOrCreate()
    df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
    rows_before = metrics.counter("sparkdl.rows_processed").value
    got = port_stage.transform(df).collect()

    assert metrics.counter("sparkdl.rows_processed").value == rows_before + N_IMAGES
    assert [r["uri"] for r in got] == [r["uri"] for r in want] == uris
    width = 192 if features_only else 4
    for g, w in zip(got, want):
        assert isinstance(g["out"], DenseVector) and len(g["out"]) == width
        np.testing.assert_allclose(g["out"].toArray(), w["out"].toArray(), **TOL)


def test_bf16_transform_matches_jax(tpu_session, uris, flax_variables):
    """A bfloat16 ViT (float32 weights, bf16 arithmetic, as Flax's
    ``dtype``): its bf16 rows come back widened to float32, as the JAX
    stage's bf16 arrays do, within test_torch_vit.py's bf16 bound."""
    bf16_tol = dict(atol=0.1, rtol=2e-2)
    jax_stage = FlaxImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=_loader,
        module=JaxViT(**GEOMETRY, dtype=jnp.bfloat16), variables=flax_variables,
        batchSize=2,
    )
    want = jax_stage.transform(tpu_session.createDataFrame(
        [{"uri": u} for u in uris], numPartitions=1
    )).collect()
    port_stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=_loader,
        module=ViT(**GEOMETRY, attn_impl="flash", dtype=torch.bfloat16),
        state_dict=vit_state_dict_from_flax(flax_variables),
        batchSize=2, device="cpu",
    )
    session = TorchSession.builder.master("local[*]").appName("tests").getOrCreate()
    got = port_stage.transform(
        session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
    ).collect()
    assert [r["uri"] for r in got] == uris
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["out"].toArray(), w["out"].toArray(), **bf16_tol)


def test_transform_over_partitions_keeps_row_order(uris, flax_variables):
    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=_loader,
        module=ViT(**GEOMETRY), state_dict=vit_state_dict_from_flax(flax_variables),
        batchSize=2, device="cpu",
    )
    session = TorchSession.builder.getOrCreate()
    df = session.createDataFrame(
        [{"uri": u, "i": i} for i, u in enumerate(uris)], numPartitions=3
    )
    got = stage.transform(df)
    assert got.count() == N_IMAGES and got.getNumPartitions() == 3
    single = stage.transform(
        session.createDataFrame([{"uri": u, "i": i} for i, u in enumerate(uris)],
                                numPartitions=1)
    ).collect()
    for a, b in zip(got.collect(), single):
        assert a["i"] == b["i"]
        np.testing.assert_allclose(a["out"].toArray(), b["out"].toArray(), **TOL)


def _imports_jax_package(name: str) -> bool:
    return any(
        name == root or name.startswith(root + ".")
        for root in ("jax", "jaxlib", "flax", "sparkdl_tpu")
    )


def test_import_name_rule():
    assert _imports_jax_package("sparkdl_tpu.ops")
    assert _imports_jax_package("jax")
    assert not _imports_jax_package("sparkdl_tpu_torch.ops")
    assert not _imports_jax_package("jaxtyping_free")


def test_port_imports_no_jax_in_a_fresh_process():
    """Every module of the port and every lazy export loads without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparkdl_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'sparkdl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "[getattr(p, name) for name in p.__all__]\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    for module in (
        "sparkdl_tpu_torch.ops.flash_attention",
        "sparkdl_tpu_torch.estimators.data",
        "sparkdl_tpu_torch.estimators.losses",
        "sparkdl_tpu_torch.estimators.torch_image_file_estimator",
        "sparkdl_tpu_torch.parallel.trainer",
    ):
        assert module in loaded, module
    assert [m for m in loaded if _imports_jax_package(m)] == []


def test_port_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if _imports_jax_package(n)]
    assert len(files) > 10
    assert offenders == []


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchImageFileTransformer(
            inputCol="uri", outputCol="out", imageLoader=_loader,
            module=ViT(**GEOMETRY),
        )


def test_loader_shape_contract_matches_jax():
    mixed = [np.zeros((8, 8, 3), np.float32), np.zeros((4, 4, 3), np.float32)]
    with pytest.raises(ValueError) as port_err:
        make_loader_decode_plan(lambda i: mixed[i])([0, 1])
    with pytest.raises(ValueError) as jax_err:
        jax_make_loader_decode_plan(lambda i: mixed[i])([0, 1])
    assert "one fixed array shape" in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_loader_shape_contract_holds_across_chunks():
    shapes = [(8, 8, 3), (8, 8, 3), (4, 4, 3)]
    decode = make_loader_decode_plan(lambda i: np.zeros(shapes[i], np.float32))
    with pytest.raises(ValueError, match="one fixed array shape"):
        run_batched_rows(lambda x: x.sum((1, 2, 3)), [0, 1, 2], decode,
                         batch_size=2, device="cpu")


def test_run_batched_rows_widens_bf16_outputs():
    """numpy has no bfloat16: a bf16 output comes back as the float32 array
    of the same values."""
    decode = make_loader_decode_plan(lambda i: np.full((2,), i + 0.1, np.float32))
    out = run_batched_rows(lambda x: x.to(torch.bfloat16), list(range(5)), decode,
                           batch_size=2, device="cpu")
    want = torch.tensor([[i + 0.1] * 2 for i in range(5)]).to(torch.bfloat16).float()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, want.numpy())


def test_run_batched_rows_keeps_every_row_in_order():
    rows = list(range(7))
    decode = make_loader_decode_plan(lambda i: np.full((2, 2), i, np.float32))
    out = run_batched_rows(lambda x: x[:, 0, 0] * 10, rows, decode,
                           batch_size=3, device="cpu")
    np.testing.assert_array_equal(out, np.arange(7) * 10.0)
