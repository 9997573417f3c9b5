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
    # h5py too: the card's machine has none, and the port reads Keras files
    # with its own reader (utils/hdf5.py)
    return any(
        name == root or name.startswith(root + ".")
        for root in ("jax", "jaxlib", "flax", "keras", "tensorflow", "orbax",
                     "optax", "h5py", "sparkdl_tpu")
    )


def test_import_name_rule():
    assert _imports_jax_package("sparkdl_tpu.ops")
    assert _imports_jax_package("jax")
    assert not _imports_jax_package("sparkdl_tpu_torch.ops")
    assert not _imports_jax_package("jaxtyping_free")
    assert _imports_jax_package("keras.applications")
    assert _imports_jax_package("tensorflow")
    assert _imports_jax_package("orbax.checkpoint")
    assert _imports_jax_package("optax")
    assert _imports_jax_package("h5py")


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
        "sparkdl_tpu_torch.image.imageIO",
        "sparkdl_tpu_torch.ml.classification",
        "sparkdl_tpu_torch.ml.evaluation",
        "sparkdl_tpu_torch.ml.pipeline",
        "sparkdl_tpu_torch.ml.util",
        "sparkdl_tpu_torch.ml.tuning",
        "sparkdl_tpu_torch.models.inception_v3",
        "sparkdl_tpu_torch.models.keras_port",
        "sparkdl_tpu_torch.models.layers",
        "sparkdl_tpu_torch.models.mobilenet_v2",
        "sparkdl_tpu_torch.models.registry",
        "sparkdl_tpu_torch.models.resnet",
        "sparkdl_tpu_torch.models.vgg",
        "sparkdl_tpu_torch.models.xception",
        "sparkdl_tpu_torch.transformers.named_image",
        "sparkdl_tpu_torch.transformers.tf_image",
        "sparkdl_tpu_torch.transformers.tf_tensor",
        "sparkdl_tpu_torch.graph.builder",
        "sparkdl_tpu_torch.graph.function",
        "sparkdl_tpu_torch.graph.pieces",
        "sparkdl_tpu_torch.graph.utils",
        "sparkdl_tpu_torch.param.converters",
        "sparkdl_tpu_torch.utils.hdf5",
        "sparkdl_tpu_torch.models.keras_model",
        "sparkdl_tpu_torch.transformers.keras_image",
        "sparkdl_tpu_torch.transformers.keras_tensor",
        "sparkdl_tpu_torch.sql.functions",
        "sparkdl_tpu_torch.sql.session",
        "sparkdl_tpu_torch.sql.dataframe",
        "sparkdl_tpu_torch.sql.window_state",
        "sparkdl_tpu_torch.sql.continuous",
        "sparkdl_tpu_torch.graph.tensorframes_udf",
        "sparkdl_tpu_torch.udf.keras_image_model",
        "sparkdl_tpu_torch.parallel.keras_train",
        "sparkdl_tpu_torch.estimators.keras_image_file_estimator",
        "sparkdl_tpu_torch.estimators.checkpointing",
        "sparkdl_tpu_torch.estimators.optimizers",
        "sparkdl_tpu_torch.resilience.errors",
        "sparkdl_tpu_torch.resilience.inject",
        "sparkdl_tpu_torch.resilience.preempt",
        "sparkdl_tpu_torch.engine.cache",
        "sparkdl_tpu_torch.engine.core",
        "sparkdl_tpu_torch.engine.slots",
        "sparkdl_tpu_torch.resilience.policy",
        "sparkdl_tpu_torch.resilience.watchdog",
        "sparkdl_tpu_torch.serving.errors",
        "sparkdl_tpu_torch.serving.admission",
        "sparkdl_tpu_torch.serving.cache",
        "sparkdl_tpu_torch.serving.batcher",
        "sparkdl_tpu_torch.serving.decode",
        "sparkdl_tpu_torch.serving.server",
        "sparkdl_tpu_torch.serving",
        "sparkdl_tpu_torch.obs",
        "sparkdl_tpu_torch.obs.trace",
        "sparkdl_tpu_torch.obs.export",
        "sparkdl_tpu_torch.obs.timeseries",
        "sparkdl_tpu_torch.obs.slo",
        "sparkdl_tpu_torch.obs.blackbox",
        "sparkdl_tpu_torch.data",
        "sparkdl_tpu_torch.data.dataset",
        "sparkdl_tpu_torch.data.prefetch",
        "sparkdl_tpu_torch.data.device",
        "sparkdl_tpu_torch.streaming",
        "sparkdl_tpu_torch.streaming.sources",
        "sparkdl_tpu_torch.streaming.commit",
        "sparkdl_tpu_torch.streaming.runner",
        "sparkdl_tpu_torch.obs.server",
        "sparkdl_tpu_torch.obs.hooks",
        "sparkdl_tpu_torch.obs.fleet",
        "sparkdl_tpu_torch.obs.diag",
        "sparkdl_tpu_torch.obs.profile",
        "sparkdl_tpu_torch.serving.wire",
        "sparkdl_tpu_torch.serving.transport",
        "sparkdl_tpu_torch.serving.faultnet",
        "sparkdl_tpu_torch.serving.result_cache",
        "sparkdl_tpu_torch.serving.replica",
        "sparkdl_tpu_torch.serving.router",
        "sparkdl_tpu_torch.serving.supervisor",
        "sparkdl_tpu_torch.serving.autoscale",
        "sparkdl_tpu_torch.serving.rollout",
        "sparkdl_tpu_torch.parallel",
        "sparkdl_tpu_torch.parallel.runner",
        "sparkdl_tpu_torch.parallel.context",
        "sparkdl_tpu_torch.parallel.tp",
        "sparkdl_tpu_torch.native",
        "sparkdl_tpu_torch.native.aoti",
        "sparkdl_tpu_torch.native.featurizer",
        "sparkdl_tpu_torch.transformers.native_image",
        "sparkdl_tpu_torch.sim",
        "sparkdl_tpu_torch.sim.clock",
        "sparkdl_tpu_torch.sim.trace",
        "sparkdl_tpu_torch.sim.replica",
        "sparkdl_tpu_torch.sim.replay",
        "sparkdl_tpu_torch.sim.tune",
        "sparkdl_tpu_torch.utils.probes",
        "sparkdl_tpu_torch.utils.profiler",
    ):
        assert module in loaded, module
    assert [m for m in loaded if _imports_jax_package(m)] == []


def test_every_port_module_imports_first():
    """Each module of the port imports as the first of the package a
    process loads, whatever the order, so no import cycle is closed by
    which module a caller happens to import first (the op library
    registers once per process, so ``ops`` stays loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparkdl_tpu_torch as p\n"
        "import sparkdl_tpu_torch.ops.flash_attention\n"
        "keep = {'sparkdl_tpu_torch.ops', 'sparkdl_tpu_torch.ops.flash_attention',\n"
        "        'sparkdl_tpu_torch.ops.cuda_build'}\n"
        "failed = []\n"
        "walked = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, 'sparkdl_tpu_torch.'):\n"
        "    walked.add(m.name)\n"
        "    for name in [n for n in sys.modules\n"
        "                 if n.startswith('sparkdl_tpu_torch.') and n not in keep]:\n"
        "        del sys.modules[name]\n"
        "    try:\n"
        "        importlib.import_module(m.name)\n"
        "    except ImportError as exc:\n"
        "        failed.append(f'{m.name}: {exc}')\n"
        "failed += [f'{n}: not walked' for n in ('sparkdl_tpu_torch.native',\n"
        "                                           'sparkdl_tpu_torch.native.aoti',\n"
        "                                           'sparkdl_tpu_torch.native.featurizer',\n"
        "                                           'sparkdl_tpu_torch.transformers.native_image',\n"
        "                                           'sparkdl_tpu_torch.sim',\n"
        "                                           'sparkdl_tpu_torch.sim.clock',\n"
        "                                           'sparkdl_tpu_torch.sim.trace',\n"
        "                                           'sparkdl_tpu_torch.sim.replica',\n"
        "                                           'sparkdl_tpu_torch.sim.replay',\n"
        "                                           'sparkdl_tpu_torch.sim.tune',\n"
        "                                           'sparkdl_tpu_torch.utils.probes',\n"
        "                                           'sparkdl_tpu_torch.utils.profiler')\n"
        "           if n not in walked]\n"
        "print('\\n'.join(failed))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_port_sources_import_no_jax():
    # the package, the script, and the rank functions the parallel tests
    # spawn without JAX
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / "tests" / "torch_fixtures" / name
        for name in ("dist_launch.py", "dist_child.py", "parallel_workers.py")]
    for module in ("graph/function.py", "graph/pieces.py", "graph/builder.py",
                   "graph/utils.py", "param/converters.py", "transformers/tf_image.py",
                   "transformers/tf_tensor.py", "utils/hdf5.py", "models/keras_model.py",
                   "transformers/keras_image.py", "transformers/keras_tensor.py",
                   "sql/functions.py", "sql/session.py", "sql/dataframe.py",
                   "sql/window_state.py", "sql/continuous.py",
                   "graph/tensorframes_udf.py", "obs/server.py",
                   "obs/hooks.py", "obs/fleet.py", "obs/diag.py", "obs/profile.py",
                   "serving/wire.py", "serving/transport.py", "serving/faultnet.py",
                   "serving/result_cache.py", "serving/replica.py", "serving/router.py",
                   "serving/supervisor.py", "serving/autoscale.py",
                   "udf/keras_image_model.py", "parallel/keras_train.py",
                   "estimators/keras_image_file_estimator.py", "estimators/checkpointing.py",
                   "estimators/optimizers.py", "resilience/__init__.py", "resilience/errors.py",
                   "resilience/inject.py", "resilience/preempt.py", "resilience/policy.py",
                   "resilience/watchdog.py", "engine/cache.py", "engine/core.py",
                   "engine/slots.py", "serving/__init__.py", "serving/errors.py",
                   "serving/admission.py", "serving/cache.py", "serving/batcher.py",
                   "serving/decode.py", "serving/server.py", "obs/__init__.py",
                   "obs/trace.py", "obs/export.py", "obs/timeseries.py", "obs/slo.py",
                   "obs/blackbox.py", "data/__init__.py", "data/dataset.py",
                   "data/prefetch.py", "data/device.py", "streaming/__init__.py",
                   "streaming/sources.py", "streaming/commit.py", "streaming/runner.py",
                   "serving/rollout.py", "parallel/__init__.py", "parallel/runner.py",
                   "parallel/trainer.py", "parallel/context.py", "parallel/tp.py",
                   "native/__init__.py", "native/aoti.py", "native/featurizer.py",
                   "transformers/native_image.py", "sim/__init__.py", "sim/clock.py",
                   "sim/trace.py", "sim/replica.py", "sim/replay.py", "sim/tune.py",
                   "utils/probes.py", "utils/profiler.py"):
        assert PACKAGE / module in files, module
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


REPLICA_MODULES_FACTORY = """
import sys

import torch

from sparkdl_tpu_torch.serving import ModelServer


def make():
    server = ModelServer(device="cpu")

    def forward(x):
        # answered once the replica serves: everything it loads is loaded
        roots = ("jax", "jaxlib", "flax", "keras", "tensorflow", "orbax", "optax",
                 "h5py", "sparkdl_tpu")
        n = sum(1 for m in list(sys.modules)
                if any(m == r or m.startswith(r + ".") for r in roots))
        return torch.full_like(x, float(n))

    server.register("modules", forward, item_shape=(1,), compile=False)
    return server
"""


def test_a_replica_process_loads_no_jax(tmp_path):
    from sparkdl_tpu_torch.serving import ReplicaSpec, ReplicaSupervisor

    (tmp_path / "modules_factory.py").write_text(REPLICA_MODULES_FACTORY)
    spec = ReplicaSpec(factory="modules_factory:make", pythonpath=(str(tmp_path),))
    with ReplicaSupervisor(spec, replicas=1, monitor_interval_s=0.05) as sup:
        assert sup.wait_live(1, 120), sup.status()
        got = sup.router.route(np.zeros(1, np.float32), model_id="modules", timeout_s=30.0)
    assert np.asarray(got).tolist() == [0.0]


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
