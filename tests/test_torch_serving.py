"""The port's online serving (``sparkdl_tpu_torch.serving``) against the JAX
package's (``sparkdl_tpu.serving``).

The parity cases serve the same seeded inputs through both packages'
``ModelServer``s, from 4 threads, and hold every served row to the JAX
server's and to the port's plain unbatched forward:

- a tiny flash ViT (2 layers, width 64, head_dim 32; weights from the JAX
  package's ``PRNGKey(0)`` init through the port's converter). The JAX side
  serves it compiled, its Pallas kernel in interpret mode; the port serves
  it ragged through a real AOTInductor compile of its slot-block program,
  and with ``SPARKDL_RAGGED=0`` on the padded ladder. Ragged and padded are
  not held to each other byte for byte (the JAX package's own test of that
  fails in the repository's test runs, ROADMAP queue 3);
- a seeded Keras CNN written as ``.keras``, registered with
  ``registerKerasImageUDF`` in both packages and served through
  ``from_registered_udf``, on the same image structs, also held to the
  UDF's SQL rows.

The behavioural cases of ``tests/test_serving.py``, ``test_resilience.py``
and ``test_fault_injection.py`` that need no replica plane follow: the
batching core (each helper against the JAX one), coalescing, the endpoint
contract, the single-flight program cache, the idle-device flush,
``offer_wait`` races, ragged dispatch, deadlines, overload, retries and the
breaker. Compiled endpoints there run through the engine with its compile
swapped for ``ExportOnly`` (``tests/torch_fixtures/engine_fixtures.py``).
"""

import json
import os
import sys
import threading
import time
import urllib.request

import keras
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.models import vit as jax_vit_module
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from sparkdl_tpu.serving import ModelServer as JaxModelServer
from sparkdl_tpu.serving import ServingConfig as JaxServingConfig
from sparkdl_tpu.transformers import utils as jax_utils
from sparkdl_tpu.udf import registerKerasImageUDF as jax_registerKerasImageUDF
from sparkdl_tpu_torch import registerKerasImageUDF
from sparkdl_tpu_torch.graph import TorchFunction
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import vit as port_vit_module
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.resilience.errors import CircuitOpen
from sparkdl_tpu_torch.resilience.inject import (
    FaultPlan,
    InjectedPermanentError,
    active_plan,
)
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.serving import (
    DeadlineExceeded,
    DecodeEndpoint,
    ModelServer,
    ServerClosed,
    ServerOverloaded,
    ServingConfig,
)
from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request
from sparkdl_tpu_torch.serving.batcher import MicroBatcher
from sparkdl_tpu_torch.serving.cache import ProgramCache
from sparkdl_tpu_torch.sql.functions import col
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.transformers.utils import (
    bucket_ladder,
    make_input_prologue,
    pad_to_batch,
    shape_bucket,
)
from sparkdl_tpu_torch.utils.metrics import metrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
from engine_fixtures import ExportOnly  # noqa: E402

SERVE_TOL = dict(atol=1e-5, rtol=1e-4)   # served rows against the JAX server's
KERAS_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_keras_transformers.py's
TINY_VIT = (8, 64, 2, 2, 128)            # patch, width, depth, heads (head_dim 32), mlp
GEOMETRY = dict(variant="tiny-serving", num_classes=4, image_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture
def export_only(monkeypatch):
    return ExportOnly.install(monkeypatch)


def make_server(**config_kw):
    cfg = ServingConfig(**{"max_batch": 16, "max_wait_ms": 25.0, "queue_capacity": 64,
                           **config_kw})
    server = ModelServer(cfg, device="cpu")
    server.register("double", lambda x: x * 2.0, item_shape=(4,))
    return server


def serve_from_threads(submit, xs, n_threads=4):
    """Each of ``n_threads`` threads submits its share of ``xs`` (row i by
    thread i % n_threads) and waits for its results; rows come back in the
    order of ``xs``."""
    out = [None] * len(xs)
    barrier = threading.Barrier(n_threads)

    def client(t):
        barrier.wait()
        futs = [(i, submit(xs[i])) for i in range(t, len(xs), n_threads)]
        for i, f in futs:
            out[i] = np.asarray(f.result(timeout=300))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    return np.stack(out)


# ----------------------------------------------------------------------
# parity: a tiny flash ViT served by both packages
# ----------------------------------------------------------------------
@pytest.fixture
def tiny_vit(monkeypatch):
    monkeypatch.setitem(jax_vit_module.VIT_VARIANTS, "tiny-serving", TINY_VIT)
    monkeypatch.setitem(port_vit_module.VIT_VARIANTS, "tiny-serving", TINY_VIT)
    rng = np.random.default_rng(0)
    images = rng.random((12, 32, 32, 3), dtype=np.float32)
    jax_model = jax_vit_module.ViT(**GEOMETRY, attn_impl=jax_flash_attention)
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(0), jnp.asarray(images[:2])))
    module = port_vit_module.ViT(**GEOMETRY, attn_impl="flash")
    module.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jax_model, params, module.eval(), images


def _jax_served(jax_model, params, images):
    server = JaxModelServer(JaxServingConfig(max_batch=4, max_wait_ms=2.0))
    server.register("vit", lambda x: jax_model.apply(params, x), item_shape=(32, 32, 3),
                    fingerprint="jax-tiny-vit:prng0")
    try:
        return serve_from_threads(lambda x: server.submit(x), images)
    finally:
        server.close()


def _port_served(module, images, warm=True, then=None):
    """Serve ``images`` through the port's server; ``then(server)`` runs
    before it closes."""
    fn = TorchFunction.from_module(module)
    fn.fingerprint = "tiny-flash-vit:prng0"
    fn.input_specs = [((1, 32, 32, 3), np.float32)]
    server = ModelServer.from_torch_function(
        fn, model_id="vit", config=ServingConfig(max_batch=4, max_wait_ms=2.0), device="cpu")
    try:
        warmed = server.warmup() if warm else None
        got = serve_from_threads(lambda x: server.submit(x), images)
        status = server.status()
        if then is not None:
            then(server)
        return warmed, got, status
    finally:
        server.close()


def _plain(module, images):
    with torch.inference_mode():
        return np.stack([module(torch.from_numpy(x[None]))[0].numpy() for x in images])


def test_flash_vit_served_ragged_matches_jax_server(tiny_vit):
    """A real AOTInductor compile of the slot-block program: 12 requests
    from 4 threads, each row held to the JAX server's and to the port's
    plain forward of that one image."""
    jax_model, params, module, images = tiny_vit
    want = _jax_served(jax_model, params, images)
    plain = _plain(module, images)
    rescaled = []

    def rescale_head(server):
        # the program takes the endpoint's params as an input: rows follow
        # the weights changed in place, with no compile
        with torch.no_grad():
            module.head.weight.mul_(0.5)
        rescaled.append(serve_from_threads(lambda x: server.submit(x), images[:4]))

    warmed, got, status = _port_served(module, images, then=rescale_head)
    assert warmed == {"vit": ("ragged",)}
    assert status["endpoints"]["vit"]["ragged"] is True
    assert status["program_cache"]["warmup"]["vit"]["ragged"]["source"] == "compile"
    assert metrics.counter("serving.compiles").value == 1  # the warmup's, none after
    assert metrics.counter("serving.batches").value < len(images)
    np.testing.assert_allclose(got, want, **SERVE_TOL)
    np.testing.assert_allclose(got, plain, **SERVE_TOL)
    np.testing.assert_allclose(rescaled[0], _plain(module, images[:4]), **SERVE_TOL)


def test_flash_vit_served_padded_matches_jax_server(tiny_vit, monkeypatch, export_only):
    """``SPARKDL_RAGGED=0``: the padded ladder (1, 2, 4), one program per
    bucket, every row held to the JAX server's and to the plain forward."""
    monkeypatch.setenv("SPARKDL_RAGGED", "0")
    jax_model, params, module, images = tiny_vit
    want = _jax_served(jax_model, params, images)
    warmed, got, status = _port_served(module, images)
    assert warmed == {"vit": (1, 2, 4)}
    assert status["endpoints"]["vit"]["ragged"] is False
    assert len(export_only.compiled) == 3
    np.testing.assert_allclose(got, want, **SERVE_TOL)
    np.testing.assert_allclose(got, _plain(module, images), **SERVE_TOL)


# ----------------------------------------------------------------------
# parity: the Keras UDF served by both packages
# ----------------------------------------------------------------------
UDF_SIZE = 24


@pytest.fixture(scope="module")
def udf_file(tmp_path_factory):
    model = keras.Sequential([keras.Input((UDF_SIZE, UDF_SIZE, 3)),
                              keras.layers.Conv2D(4, 3, activation="relu"),
                              keras.layers.GlobalAveragePooling2D(), keras.layers.Dense(5)])
    rng = np.random.RandomState(7)
    model.set_weights([(rng.randn(*w.shape) * 0.1).astype(np.float32)
                       for w in model.get_weights()])
    path = tmp_path_factory.mktemp("serving_udf") / "small_cnn.keras"
    model.save(path)
    return str(path)


def test_registered_udf_served_matches_jax_and_sql(udf_file, tpu_session, export_only):
    session = TorchSession.builder.appName("tests").getOrCreate()
    rng = np.random.default_rng(3)
    bgr = [rng.integers(0, 256, (UDF_SIZE, UDF_SIZE, 3), dtype=np.uint8) for _ in range(8)]
    structs = [imageIO.imageArrayToStruct(a) for a in bgr]
    # a client decodes each struct (stored BGR) to the model's RGB floats
    items = [imageIO.imageStructToArray(s)[..., ::-1].astype(np.float32) for s in structs]

    udf = registerKerasImageUDF("serving_udf", udf_file, session=session, device="cpu")
    meta = session.udf.resolve("serving_udf")._serving_endpoint
    assert meta is udf._serving_endpoint
    assert meta["item_shape"] == (UDF_SIZE, UDF_SIZE, 3)
    assert meta["fingerprint"].startswith("keras_udf:keras:")
    jax_registerKerasImageUDF("serving_udf", udf_file, session=tpu_session)

    with ModelServer.from_registered_udf(
            "serving_udf", session=session,
            config=ServingConfig(max_batch=4, max_wait_ms=2.0)) as server:
        assert server.warmup() == {"serving_udf": ("ragged",)}
        got = serve_from_threads(lambda x: server.submit(x), items)
    with JaxModelServer.from_registered_udf(
            "serving_udf", session=tpu_session,
            config=JaxServingConfig(max_batch=4, max_wait_ms=2.0)) as jax_server:
        want = serve_from_threads(lambda x: jax_server.submit(x), items)
    np.testing.assert_allclose(got, want, **KERAS_TOL)

    df = session.createDataFrame([{"i": i, "image": s} for i, s in enumerate(structs)])
    rows = df.select(col("i"), udf("image").alias("preds")).collect()
    sql = np.stack([np.asarray(r["preds"]) for r in sorted(rows, key=lambda r: r["i"])])
    np.testing.assert_allclose(got, sql, **KERAS_TOL)


def test_from_registered_udf_rejects_a_plain_udf():
    session = TorchSession.builder.appName("tests").getOrCreate()
    session.udf.register("plain_py_udf", lambda x: x)
    with pytest.raises(ValueError, match="registerKerasImageUDF"):
        ModelServer.from_registered_udf("plain_py_udf", session=session)


def test_from_torch_function_places_params_once(export_only):
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    fn = TorchFunction(lambda p, x: x @ p["w"], params={"w": w}, name="linear")
    fn.input_specs = [((8, 4), np.float32)]
    with ModelServer.from_torch_function(
            fn, config=ServingConfig(max_wait_ms=1.0), device="cpu") as server:
        # no fingerprint: the padded ladder
        assert server.warmup() == {"linear": (1, 2, 4, 8, 16, 32)}
        x = np.ones((4,), np.float32)
        np.testing.assert_allclose(server.predict(x, timeout=30.0), x @ w, rtol=1e-6)
        # every rung takes the one placed copy as its input
        want = x @ (2 * w)
        fn.placed_params("cpu")["w"].mul_(2.0)
        np.testing.assert_allclose(server.predict(x, timeout=30.0), want, rtol=1e-6)


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelServer()


def test_batcher_decode_and_slot_pool_default_to_the_card(monkeypatch):
    # each of the three raises without a card unless told device="cpu"
    from sparkdl_tpu_torch.engine.slots import SlotPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builders = [
        lambda **kw: MicroBatcher("b", lambda x: x, ServingConfig(max_batch=4), ProgramCache(2),
                                  item_shape=(4,), compile=False, **kw),
        lambda **kw: DecodeEndpoint("d", lambda c: (c + 1.0, c[:, 0].clone()),
                                    lambda p: np.zeros(2, np.float32), max_steps=4,
                                    compile=False, **kw),
        lambda **kw: SlotPool(3, **kw),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        made = build(device="cpu")
        pool = made if isinstance(made, SlotPool) else made._pool
        assert pool.device == torch.device("cpu")
        if not isinstance(made, SlotPool):
            made.close()


def test_replica_plane_names_wait_for_item_10b():
    # the replica plane is ported: its names import, the rollout
    # controller among them, and start_telemetry serves
    import sparkdl_tpu_torch.serving as serving
    from sparkdl_tpu_torch.serving.replica import ReplicaSpec
    from sparkdl_tpu_torch.serving.rollout import RolloutController
    from sparkdl_tpu_torch.serving.supervisor import ReplicaSupervisor

    assert serving.ReplicaSupervisor is ReplicaSupervisor
    assert serving.ReplicaSpec is ReplicaSpec
    for name in ("Router", "ResultCache", "Autoscaler", "ReplicaDraining",
                 "NoLiveReplicas", "RemoteReplicaError"):
        assert isinstance(getattr(serving, name), type)
    assert serving.RolloutController is RolloutController
    with pytest.raises(AttributeError, match="no attribute"):
        serving.NotAServingName  # noqa: B018
    server = make_server()
    try:
        obs = server.start_telemetry()
        assert server.start_telemetry() is obs
        with urllib.request.urlopen(obs.url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["healthy"] is True
    finally:
        server.close()


# ----------------------------------------------------------------------
# batching core, against the JAX helpers
# ----------------------------------------------------------------------
def test_shape_bucket_matches_jax():
    for n in range(1, 40):
        for cap in (1, 6, 32):
            assert shape_bucket(n, cap) == jax_utils.shape_bucket(n, cap)
    with pytest.raises(ValueError):
        shape_bucket(0, 32)


def test_bucket_ladder_matches_jax():
    assert bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
    for cap in (1, 2, 5, 6, 32, 33):
        assert bucket_ladder(cap) == jax_utils.bucket_ladder(cap)


def test_pad_to_batch_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    padded = pad_to_batch(x, 5)
    np.testing.assert_array_equal(padded, jax_utils.pad_to_batch(x, 5))
    np.testing.assert_array_equal(padded[3:], np.stack([x[-1], x[-1]]))
    assert pad_to_batch(x, 3) is x and pad_to_batch(x, 2) is x


# ----------------------------------------------------------------------
# coalescing and the warm cache
# ----------------------------------------------------------------------
@pytest.mark.usefixtures("export_only")
class TestCoalescing:
    @pytest.mark.parametrize("ragged", ["1", "0"])
    def test_queued_submissions_coalesce(self, monkeypatch, ragged):
        """Requests that queue while the worker is busy land in one forward
        call: the first request holds the worker in its forward (a gate);
        15 more from 15 threads queue behind it and are served together."""
        monkeypatch.setenv("SPARKDL_RAGGED", ragged)
        n = 16
        gate, entered = threading.Event(), threading.Event()
        calls = []

        def forward(x):
            calls.append(int(x.shape[0]))
            entered.set()
            assert gate.wait(30.0)
            return x * 2.0

        with ModelServer(ServingConfig(max_batch=16, max_wait_ms=50.0), device="cpu") as server:
            server.register("double", forward, item_shape=(4,), compile=False)
            first = server.submit(np.full((4,), 0.0, np.float32))
            assert entered.wait(30.0)
            results = [None] * n
            results[0] = first

            def one(i):
                results[i] = server.submit(np.full((4,), float(i), np.float32))

            threads = [threading.Thread(target=one, args=(i,)) for i in range(1, n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            deadline = time.monotonic() + 10.0
            while server.status()["endpoints"]["double"]["queue_depth"] < n - 1:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            gate.set()
            for i in range(n):
                np.testing.assert_allclose(results[i].result(30.0), 2.0 * i)
        assert metrics.counter("serving.requests").value == n
        assert metrics.counter("serving.batches").value == 2
        assert sorted(calls)[-1] >= n - 1

    def test_zero_recompiles_after_warmup(self):
        with make_server() as server:
            assert server.warmup() == {"double": (1, 2, 4, 8, 16)}
            compiles = metrics.counter("serving.compiles").value
            assert compiles == 5
            for burst in (1, 3, 7, 16):
                futs = [server.submit(np.full((4,), float(i), np.float32))
                        for i in range(burst)]
                for i, f in enumerate(futs):
                    np.testing.assert_allclose(f.result(30.0), 2.0 * i)
            assert metrics.counter("serving.compiles").value == compiles

    def test_results_unscrambled_across_batches(self):
        with make_server(max_batch=4, max_wait_ms=5.0) as server:
            futs = [server.submit(np.full((4,), float(i), np.float32)) for i in range(23)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(30.0), 2.0 * i)

    def test_latency_quantiles_and_occupancy_exported(self):
        with make_server() as server:
            server.warmup()
            for f in [server.submit(np.ones((4,), np.float32)) for _ in range(12)]:
                f.result(30.0)
            snap = server.status()["metrics"]
        for q in ("p50", "p95", "p99", "mean", "count"):
            assert f"serving.latency_ms.{q}" in snap
        assert snap["serving.latency_ms.count"] == 12
        assert (snap["serving.latency_ms.p50"] <= snap["serving.latency_ms.p95"]
                <= snap["serving.latency_ms.p99"])
        assert 0.0 < snap["serving.batch_occupancy.mean"] <= 1.0
        assert snap["serving.queue_depth.double"] == 0
        assert snap["serving.requests"] == 12

    def test_status_shape(self):
        server = make_server()
        try:
            st = server.status()
            assert st["healthy"] and not st["closed"] and st["uptime_s"] >= 0
            ep = st["endpoints"]["double"]
            assert ep["item_shape"] == [4] and ep["dtype"] == "float32"
            assert ep["device"] == "cpu"
            assert st["program_cache"]["programs"] == 0
        finally:
            server.close()
        assert server.status()["closed"]


# ----------------------------------------------------------------------
# the endpoint contract
# ----------------------------------------------------------------------
@pytest.mark.usefixtures("export_only")
class TestEndpointContract:
    def test_duplicate_register_rejected(self):
        with make_server() as server:
            with pytest.raises(ValueError, match="already registered"):
                server.register("double", lambda x: x)

    def test_item_shape_is_enforced(self):
        with make_server() as server:
            server.predict(np.ones((4,), np.float32), timeout=30.0)
            with pytest.raises(ValueError, match="shape"):
                server.submit(np.ones((5,), np.float32))

    def test_first_request_binds_shape(self):
        with ModelServer(ServingConfig(max_wait_ms=1.0), device="cpu") as server:
            server.register("id", lambda x: x)
            with pytest.raises(ValueError, match="no item shape"):
                server.warmup()
            np.testing.assert_allclose(
                server.predict(np.ones((3,), np.float32), timeout=30.0), 1.0)
            with pytest.raises(ValueError, match="shape"):
                server.submit(np.ones((7,), np.float32))

    def test_model_id_routing(self):
        with make_server() as server:
            server.register("triple", lambda x: x * 3.0, item_shape=(4,))
            with pytest.raises(ValueError, match="model_id is required"):
                server.submit(np.ones((4,), np.float32))
            np.testing.assert_allclose(
                server.predict(np.ones((4,), np.float32), model_id="triple", timeout=30.0), 3.0)
            with pytest.raises(KeyError, match="nope"):
                server.submit(np.ones((4,), np.float32), model_id="nope")

    def test_submit_after_close_raises(self):
        server = make_server()
        server.close()
        with pytest.raises(ServerClosed):
            server.submit(np.ones((4,), np.float32))

    def test_program_cache_lru_eviction(self):
        with ModelServer(ServingConfig(max_batch=4, max_wait_ms=1.0, cache_size=2),
                         device="cpu") as server:
            server.register("d", lambda x: x * 2.0, item_shape=(2,))
            server.warmup()
            assert server.status()["program_cache"]["programs"] == 2
            np.testing.assert_allclose(
                server.predict(np.ones((2,), np.float32), timeout=30.0), 2.0)


# ----------------------------------------------------------------------
# the program cache's single flight
# ----------------------------------------------------------------------
class _SlowEngineStub:
    """An engine whose program() blocks until released, counting calls."""

    def __init__(self):
        self.release = threading.Event()
        self.calls = []
        self.evicted = []
        self.cache = None

    def program(self, forward, specs, fingerprint=None, name=None):
        self.calls.append(name)
        if not self.release.wait(timeout=30.0):
            raise TimeoutError("slow-compile stub never released")

        class Handle:
            callable = staticmethod(forward)
            source = "compile"
            key = f"stub:{name}"

        return Handle()

    def evict(self, key):
        self.evicted.append(key)


class TestProgramCacheSingleFlight:
    def _cache(self, maxsize=4):
        cache = ProgramCache(maxsize=maxsize)
        stub = _SlowEngineStub()
        cache._engine = stub
        return cache, stub

    @staticmethod
    def _wait_calls(stub, n):
        deadline = time.monotonic() + 5.0
        while len(stub.calls) < n and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(stub.calls) >= n

    def test_stats_not_blocked_while_a_compile_is_in_flight(self):
        cache, stub = self._cache()
        t = threading.Thread(target=cache.program,
                             args=("m", lambda p, x: x, 4, (2,), np.float32, "cpu"), daemon=True)
        t.start()
        self._wait_calls(stub, 1)
        start = time.monotonic()
        stats = cache.stats()
        assert time.monotonic() - start < 1.0
        assert stats["programs"] == 0
        stub.release.set()
        t.join(timeout=10.0)
        assert not t.is_alive() and cache.stats()["programs"] == 1

    def test_same_key_callers_share_one_compile(self):
        cache, stub = self._cache()
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(
                cache.program("m", lambda p, x: x, 4, (2,), np.float32, "cpu")),
            daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        self._wait_calls(stub, 1)
        stub.release.set()
        for t in threads:
            t.join(timeout=10.0)
        assert len(results) == 4 and len(stub.calls) == 1

    def test_distinct_keys_resolve_concurrently(self):
        cache, stub = self._cache()
        stub.release.set()
        cache.program("m", lambda p, x: x, 4, (2,), np.float32, "cpu")
        stub.release.clear()
        slow = threading.Thread(target=cache.program,
                                args=("m", lambda p, x: x, 8, (2,), np.float32, "cpu"),
                                daemon=True)
        slow.start()
        self._wait_calls(stub, 2)
        start = time.monotonic()
        assert cache.program("m", lambda p, x: x, 4, (2,), np.float32, "cpu") is not None
        assert time.monotonic() - start < 1.0
        stub.release.set()
        slow.join(timeout=10.0)

    def test_eviction_contract_preserved(self):
        cache, stub = self._cache(maxsize=2)
        stub.release.set()
        for bucket in (1, 2, 4):
            cache.program("m", lambda p, x: x, bucket, (2,), np.float32, "cpu")
        assert cache.stats()["programs"] == 2 and len(stub.evicted) == 1
        assert cache.evict_model("m") == 2 and cache.stats()["programs"] == 0


# ----------------------------------------------------------------------
# the idle-device flush and offer_wait races
# ----------------------------------------------------------------------
def test_take_flush_early_cuts_linger_on_frozen_clock():
    q = AdmissionQueue(8, clock=lambda: 1000.0)
    q.offer(Request(value=np.zeros(4, np.float32), enqueued_at=1000.0))
    t0 = time.monotonic()
    assert len(q.take(max_n=8, max_wait_s=3600.0, flush_early=lambda: True)) == 1
    assert time.monotonic() - t0 < 5.0
    assert metrics.counter("batcher.flush_early").value == 1


def test_lone_request_resolves_without_serving_full_linger():
    batcher = MicroBatcher("flush", lambda x: x * 2.0,
                           ServingConfig(max_batch=16, max_wait_ms=3_600_000.0),
                           ProgramCache(4), item_shape=(4,), compile=False, device="cpu")
    try:
        fut = batcher.submit(np.full((4,), 3.0, np.float32))
        np.testing.assert_allclose(fut.result(timeout=10.0), 6.0)
        assert metrics.counter("batcher.flush_early").value >= 1
    finally:
        batcher.close()


def _full_queue(capacity=1):
    q = AdmissionQueue(capacity)
    for _ in range(capacity):
        q.offer(Request(value=np.zeros(4, np.float32)))
    return q


def test_blocked_offer_wait_wakes_on_close_with_typed_error():
    q = _full_queue()
    outcome = {}
    blocked = threading.Event()

    def poller():
        blocked.set()
        try:
            q.offer_wait(Request(value=np.zeros(4, np.float32)))
            outcome["returned"] = True
        except BaseException as exc:  # noqa: BLE001
            outcome["error"] = exc

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    assert blocked.wait(5)
    time.sleep(0.1)
    assert not outcome
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and isinstance(outcome.get("error"), ServerClosed)


def test_offer_wait_timeout_on_full_queue_returns_false():
    q = _full_queue()
    t0 = time.monotonic()
    assert q.offer_wait(Request(value=np.zeros(4, np.float32)), timeout_s=0.2) is False
    assert time.monotonic() - t0 < 5.0


def test_offer_wait_unblocks_when_take_frees_space():
    q = _full_queue()
    result = {}

    def poller():
        result["admitted"] = q.offer_wait(Request(value=np.zeros(4, np.float32)),
                                          timeout_s=10.0)

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    time.sleep(0.1)
    assert q.take(1, max_wait_s=0.0)
    t.join(timeout=5)
    assert result.get("admitted") is True


def test_blocked_offer_wait_drains_through_open_breaker():
    gate = threading.Event()

    def failing_forward(x):
        gate.wait(30.0)
        raise RuntimeError("forward is down")

    server = ModelServer(ServingConfig(max_batch=1, max_wait_ms=1.0, queue_capacity=2,
                                       breaker_threshold=2), device="cpu")
    server.register("down", failing_forward, item_shape=(4,), compile=False)
    batcher = server._endpoints["down"]
    try:
        futures = [server.submit(np.zeros(4, np.float32))]
        deadline = time.monotonic() + 10.0
        while len(batcher._queue) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not len(batcher._queue)
        futures += [server.submit(np.zeros(4, np.float32)) for _ in range(2)]
        blocked_req = Request(value=np.zeros(4, np.float32))
        admitted = {}

        def poller():
            admitted["ok"] = batcher._queue.offer_wait(blocked_req, timeout_s=30.0)

        t = threading.Thread(target=poller, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not admitted
        gate.set()
        t.join(timeout=20)
        assert admitted.get("ok") is True
        # the admitted request resolves typed (after the breaker opened)
        assert isinstance(blocked_req.future.exception(timeout=10), CircuitOpen)
        assert batcher.breaker.state == "open"
        for fut in futures:
            assert fut.exception(timeout=10) is not None
    finally:
        gate.set()
        server.close()


# ----------------------------------------------------------------------
# ragged slot-block dispatch
# ----------------------------------------------------------------------
def test_ragged_active_and_fallback_rules(monkeypatch, export_only):
    monkeypatch.setenv("SPARKDL_RAGGED", "1")
    server = ModelServer(ServingConfig(max_batch=4, max_wait_ms=5.0), device="cpu")
    server.register("plain", lambda x: x * 2.0, item_shape=(4,), compile=False)
    server.register("anon", lambda x: x * 2.0, item_shape=(4,))
    server.register("fp", lambda x: x * 2.0, item_shape=(4,), fingerprint="test:fallback:v1")
    try:
        eps = server.status()["endpoints"]
        assert (eps["plain"]["ragged"], eps["fp"]["ragged"], eps["anon"]["ragged"]) == (
            True, True, False)
        x = np.full((4,), 1.5, np.float32)
        for ep in ("plain", "anon", "fp"):
            np.testing.assert_allclose(server.submit(x, model_id=ep).result(timeout=30.0), 3.0)
        monkeypatch.setenv("SPARKDL_RAGGED", "0")  # the live kill switch
        assert all(not e["ragged"] for e in server.status()["endpoints"].values())
        np.testing.assert_allclose(server.submit(x, model_id="plain").result(timeout=30.0), 3.0)
    finally:
        server.close()


@pytest.mark.parametrize("ragged", ["1", "0"])
def test_every_lane_serves_the_plain_forward(monkeypatch, export_only, ragged):
    """Plain, plain with a prologue, compiled and compiled with a prologue,
    ragged and padded: every row equals the plain forward of its one item
    (each mode against the plain forward, not ragged against padded)."""
    monkeypatch.setenv("SPARKDL_RAGGED", ragged)
    dim = 4
    w = torch.linspace(-1.0, 1.0, dim * dim).reshape(dim, dim)
    pro = make_input_prologue(preprocess=lambda x: x / 2.0)
    server = ModelServer(ServingConfig(max_batch=8, max_wait_ms=5.0, queue_capacity=64),
                         device="cpu")
    for name, compiled, prologue in (("plain", False, None), ("plain_pro", False, pro),
                                     ("jit", True, None), ("jit_pro", True, pro)):
        server.register(name, lambda x, _w=w: torch.tanh(x @ _w), item_shape=(dim,),
                        compile=compiled, prologue=prologue,
                        fingerprint=f"test:ragged:{name}:v1" if compiled else None)
    xs = [np.random.default_rng(7 + i).standard_normal(dim).astype(np.float32)
          for i in range(20)]
    try:
        for name in ("plain", "plain_pro", "jit", "jit_pro"):
            futs = [server.submit(x, model_id=name) for x in xs]
            got = np.stack([f.result(timeout=30.0) for f in futs])
            scale = 0.5 if name.endswith("_pro") else 1.0
            want = np.stack([torch.tanh(torch.from_numpy(x * scale)[None] @ w)[0].numpy()
                             for x in xs])
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    finally:
        server.close()


def _gated_server(monkeypatch, ragged, max_batch=8):
    monkeypatch.setenv("SPARKDL_RAGGED", ragged)
    gate = threading.Event()

    def forward(x):
        gate.wait(10.0)
        return x * 2.0

    server = ModelServer(ServingConfig(max_batch=max_batch, max_wait_ms=5.0,
                                       queue_capacity=64), device="cpu")
    server.register("ep", forward, item_shape=(4,), compile=False)
    return server, gate


def test_ragged_computes_no_pad_rows(monkeypatch):
    server, gate = _gated_server(monkeypatch, "1")
    try:
        first = server.submit(np.ones(4, np.float32))
        time.sleep(0.3)
        rest = [server.submit(np.ones(4, np.float32)) for _ in range(3)]
        gate.set()
        for f in [first] + rest:
            np.testing.assert_allclose(f.result(timeout=10.0), 2.0)
        assert (metrics.counter("batcher.rows_real").value
                == metrics.counter("batcher.rows_computed").value == 4.0)
        assert metrics.gauge("batcher.pad_fraction").value == 0.0
    finally:
        gate.set()
        server.close()


def test_padded_ladder_counts_pad_rows(monkeypatch):
    server, gate = _gated_server(monkeypatch, "0")
    try:
        first = server.submit(np.ones(4, np.float32))
        time.sleep(0.3)
        rest = [server.submit(np.ones(4, np.float32)) for _ in range(2)]
        gate.set()
        for f in [first] + rest:
            np.testing.assert_allclose(f.result(timeout=10.0), 2.0)
        real = metrics.counter("batcher.rows_real").value
        computed = metrics.counter("batcher.rows_computed").value
        assert real == 3.0 and computed >= real
        assert metrics.gauge("batcher.pad_fraction").value == round(1.0 - real / computed, 4)
    finally:
        gate.set()
        server.close()


def test_freed_slots_admit_waiting_requests(monkeypatch):
    monkeypatch.setenv("SPARKDL_RAGGED", "1")
    seen = []
    server = ModelServer(ServingConfig(max_batch=2, max_wait_ms=5.0, queue_capacity=64),
                         device="cpu")

    def forward(x):
        seen.append(int(x.shape[0]))
        return x * 2.0

    server.register("ep", forward, item_shape=(4,), compile=False)
    try:
        for f in [server.submit(np.ones(4, np.float32)) for _ in range(6)]:
            np.testing.assert_allclose(f.result(timeout=10.0), 2.0)
        assert sum(seen) == 6 and max(seen) <= 2
        assert server.status()["endpoints"]["ep"]["slot_pool"]["n_slots"] == 2
    finally:
        server.close()


def test_single_request_dispatches_without_coalesce_wait(monkeypatch):
    monkeypatch.setenv("SPARKDL_RAGGED", "1")
    server = ModelServer(ServingConfig(max_batch=8, max_wait_ms=3_600_000.0), device="cpu")
    server.register("ep", lambda x: x * 2.0, item_shape=(4,), compile=False)
    try:
        t0 = time.monotonic()
        np.testing.assert_allclose(server.submit(np.ones(4, np.float32)).result(timeout=10.0),
                                   2.0)
        assert time.monotonic() - t0 < 5.0
    finally:
        server.close()


def test_prologue_fused_matches_host_application():
    pro = make_input_prologue(preprocess=lambda x: x / 255.0)
    x = np.arange(4, dtype=np.float32)
    server = ModelServer(ServingConfig(max_batch=4, max_wait_ms=5.0), device="cpu")
    server.register("fused", lambda b: b + 1.0, item_shape=(4,), compile=False, prologue=pro)
    server.register("host", lambda b: b + 1.0, item_shape=(4,), compile=False)
    try:
        fused = server.submit(x, model_id="fused").result(timeout=10.0)
        host_in = pro(torch.from_numpy(x[None]))[0].numpy()
        host = server.submit(host_in, model_id="host").result(timeout=10.0)
        assert fused.tobytes() == host.tobytes()
    finally:
        server.close()


@pytest.mark.parametrize("ragged", ["1", "0"])
def test_warm_loaded_endpoint_serves_correct_rows(tmp_path, monkeypatch, export_only, ragged):
    """A restarted server loads its programs from disk and every request
    reads its own row: held to the closed form and to the cold server."""
    monkeypatch.setenv("SPARKDL_RAGGED", ragged)
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(tmp_path / "programs"))
    scale = torch.linspace(0.5, 1.5, 4)
    xs = [np.full(4, float(i + 1), np.float32) for i in range(24)]

    def serve_all():
        with ModelServer(ServingConfig(max_batch=8, max_wait_ms=2.0, queue_capacity=64),
                         device="cpu") as server:
            server.register("jit", lambda x, _s=scale: torch.tanh(x * _s), item_shape=(4,),
                            fingerprint="test:warmstart:v1")
            futs = [server.submit(x) for x in xs]
            return np.stack([f.result(timeout=30.0) for f in futs])

    cold = serve_all()
    compiled = len(export_only.compiled)
    warm = serve_all()
    assert len(export_only.compiled) == compiled  # the restart loaded everything
    assert metrics.counter("serving.cache_load").value >= 1
    np.testing.assert_allclose(cold, np.stack([np.tanh(x * scale.numpy()) for x in xs]),
                               atol=1e-6)
    np.testing.assert_array_equal(warm, cold)


# ----------------------------------------------------------------------
# deadlines, overload, retries and the breaker
# ----------------------------------------------------------------------
def _blocked_server(**config_kw):
    started, release = threading.Event(), threading.Event()

    def blocking_forward(x):
        started.set()
        assert release.wait(timeout=30.0)
        return x

    server = ModelServer(ServingConfig(**{"max_batch": 1, "max_wait_ms": 0.0,
                                          "queue_capacity": 2, **config_kw}), device="cpu")
    server.register("blocky", blocking_forward, item_shape=(2,), compile=False)
    return server, started, release


def test_worker_survives_forward_crash():
    boom = {"on": True}

    def flaky_forward(x):
        if boom["on"]:
            raise RuntimeError("injected model crash")
        return x * 2.0

    with ModelServer(ServingConfig(max_wait_ms=1.0), device="cpu") as server:
        server.register("flaky", flaky_forward, item_shape=(2,), compile=False)
        with pytest.raises(RuntimeError, match="injected model crash"):
            server.submit(np.ones((2,), np.float32)).result(timeout=30.0)
        assert metrics.counter("serving.errors").value == 1
        boom["on"] = False
        np.testing.assert_allclose(server.predict(np.ones((2,), np.float32), timeout=30.0), 2.0)
        assert server.status()["endpoints"]["flaky"]["worker_alive"]
    snap = metrics.snapshot()
    assert snap["serving.requests"] == 2 and snap["serving.batches"] == 1


def test_deadline_expiry_mid_queue():
    server, started, release = _blocked_server()
    try:
        first = server.submit(np.zeros((2,), np.float32))
        assert started.wait(timeout=30.0)
        doomed = server.submit(np.zeros((2,), np.float32), deadline_ms=20.0)
        time.sleep(0.05)
        release.set()
        first.result(timeout=30.0)
        with pytest.raises(DeadlineExceeded, match="expired"):
            doomed.result(timeout=30.0)
        assert metrics.counter("serving.expired").value == 1
        assert metrics.counter("serving.errors").value == 0
    finally:
        release.set()
        server.close()


def test_expired_on_arrival_fails_fast():
    with make_server() as server:
        fut = server.submit(np.zeros((4,), np.float32), deadline_ms=0.0)
        with pytest.raises(DeadlineExceeded, match="before submit"):
            fut.result(timeout=1.0)
        assert metrics.counter("serving.expired").value == 1


def test_queue_full_sheds_with_typed_error():
    server, started, release = _blocked_server(queue_capacity=2)
    try:
        first = server.submit(np.zeros((2,), np.float32))
        assert started.wait(timeout=30.0)
        queued = [server.submit(np.full((2,), float(i), np.float32)) for i in range(2)]
        with pytest.raises(ServerOverloaded, match="load-shedding"):
            server.submit(np.zeros((2,), np.float32))
        assert metrics.counter("serving.shed").value == 1
        assert metrics.gauge("serving.queue_depth.blocky").value == 2
        release.set()
        first.result(timeout=30.0)
        for i, f in enumerate(queued):
            np.testing.assert_allclose(f.result(timeout=30.0), float(i))
        snap = metrics.snapshot()
        assert snap["serving.requests"] == 4 and snap["serving.queue_depth.blocky"] == 0
    finally:
        release.set()
        server.close()


def _fast_policy(**kw):
    return RetryPolicy(**{"max_attempts": 3, "base_delay_s": 0.001, "max_delay_s": 0.005,
                          "sleep": lambda s: None, **kw})


def test_forward_transient_retried_under_batch_deadline():
    plan = FaultPlan().add("serving.forward", error="transient", at=1, times=2)
    with active_plan(plan):
        with ModelServer(ServingConfig(max_wait_ms=1.0, retry=_fast_policy()),
                         device="cpu") as server:
            server.register("m", lambda x: x * 2.0, item_shape=(2,), compile=False)
            out = server.predict(np.ones((2,), np.float32), timeout=30.0, deadline_ms=30000.0)
    np.testing.assert_allclose(out, 2.0)
    assert plan.count("serving.forward") == 3
    assert metrics.counter("resilience.retries").value == 2
    assert metrics.counter("serving.errors").value == 0


def test_compiled_forward_transient_retried(export_only):
    plan = FaultPlan().add("serving.forward", error="transient", at=1)
    with active_plan(plan):
        with ModelServer(ServingConfig(max_batch=2, max_wait_ms=1.0, retry=_fast_policy()),
                         device="cpu") as server:
            server.register("m", lambda x: x + 1.0, item_shape=(2,), fingerprint="retry:v1")
            out = server.predict(np.ones((2,), np.float32), timeout=30.0)
    np.testing.assert_allclose(out, 2.0)
    assert metrics.counter("resilience.retries").value == 1


def test_forward_permanent_fails_request_without_retry():
    plan = FaultPlan().add("serving.forward", error="permanent", at=1)
    with active_plan(plan):
        with ModelServer(ServingConfig(max_wait_ms=1.0, retry=_fast_policy()),
                         device="cpu") as server:
            server.register("m", lambda x: x, item_shape=(2,), compile=False)
            with pytest.raises(InjectedPermanentError):
                server.submit(np.ones((2,), np.float32)).result(timeout=30.0)
    assert metrics.counter("resilience.retries").value == 0
    assert metrics.counter("serving.errors").value == 1


def test_breaker_trips_into_degraded_status():
    def dead(x):
        raise InjectedPermanentError("dead forward")

    with ModelServer(ServingConfig(max_batch=1, max_wait_ms=0.0, breaker_threshold=2,
                                   breaker_recovery_s=300.0), device="cpu") as server:
        server.register("m", dead, item_shape=(2,), compile=False)
        for _ in range(2):
            with pytest.raises(InjectedPermanentError):
                server.predict(np.ones((2,), np.float32), timeout=30.0)
        with pytest.raises(CircuitOpen):
            server.predict(np.ones((2,), np.float32), timeout=30.0)
        status = server.status()
        assert status["degraded"] == ["m"]
        assert status["endpoints"]["m"]["breaker"]["state"] == "open"
        assert status["healthy"] is True
    assert metrics.counter("resilience.breaker_trips").value == 1
    assert metrics.counter("serving.errors").value == 2


def test_breaker_recloses_after_recovery_probe():
    boom = {"on": True}

    def forward(x):
        if boom["on"]:
            raise InjectedPermanentError("down")
        return x + 1.0

    with ModelServer(ServingConfig(max_batch=1, max_wait_ms=0.0, breaker_threshold=1,
                                   breaker_recovery_s=0.05), device="cpu") as server:
        server.register("m", forward, item_shape=(2,), compile=False)
        with pytest.raises(InjectedPermanentError):
            server.predict(np.ones((2,), np.float32), timeout=30.0)
        assert server.status()["degraded"] == ["m"]
        boom["on"] = False
        time.sleep(0.1)
        np.testing.assert_allclose(server.predict(np.ones((2,), np.float32), timeout=30.0), 2.0)
        assert server.status()["degraded"] == []


def test_status_probe_device_reports_a_missing_card():
    with ModelServer(device="cpu") as server:
        server.register("m", lambda x: x, item_shape=(2,), compile=False)
        status = server.status(probe_device=True, probe_timeout_s=120)
    # no card here: the bounded probe reports it, typed, instead of hanging
    assert status["device"]["ok"] is (torch.cuda.device_count() > 0)
    assert status["healthy"] is status["device"]["ok"]
