"""The replica slice as a whole, on the CPU: a supervisor runs two replica
processes of a ViT-Ti/16 at ``image_size=32`` on the port's flash path (its
plain version on the CPU), behind the router.

The weights are the JAX ``ViT``'s from ``PRNGKey(0)``, carried across by
``vit_state_dict_from_flax`` and written to ``tmp_path`` with a factory
module that the replicas import through ``ReplicaSpec.pythonpath``. The rows
answered through the router are held to the JAX package's ``ViT.apply``
with ``attn_impl=flash_attention`` (Pallas in interpret mode) at
``tests/test_torch_vit.py``'s ``TOL``; then one replica is SIGKILLed
mid-load and every accepted request is still answered with the same rows,
and the killed slot comes back.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.obs import JsonlTraceSink, diagnose, tracer
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.serving import ReplicaSpec, ReplicaSupervisor
from sparkdl_tpu_torch.utils.metrics import metrics

TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_torch_vit.py's TOL
GEOMETRY = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)
N_IMAGES = 24

FACTORY_SRC = '''
import torch

from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig


def make():
    torch.set_num_threads(1)
    model = ViT(variant="ViT-Ti/16", num_classes=4, image_size=32, attn_impl="flash")
    model.load_state_dict(torch.load({weights!r}), strict=True)
    model.eval()
    server = ModelServer(ServingConfig(max_batch=8, max_wait_ms=2.0), device="cpu")

    def forward(x):
        with torch.inference_mode():
            return model(x)

    server.register("vit", forward, item_shape=(32, 32, 3), compile=False)
    return server
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((N_IMAGES, 32, 32, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_rows_and_spec(images, tmp_path_factory):
    model = JaxViT(**GEOMETRY, attn_impl=jax_flash_attention)
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(images[:2])))
    rows = np.asarray(model.apply(params, jnp.asarray(images)))
    root = tmp_path_factory.mktemp("vit_replica")
    weights = str(root / "vit_ti16.pt")
    torch.save(vit_state_dict_from_flax(params), weights)
    (root / "vit_replica_factory.py").write_text(FACTORY_SRC.format(weights=weights))
    spec = ReplicaSpec(factory="vit_replica_factory:make", pythonpath=(str(root),))
    return rows, spec


def _route_all(router, images, n_threads=4, on_answer=None):
    """Route every image from ``n_threads`` threads; (rows, errors)."""
    out = [None] * len(images)
    errors = []
    lock = threading.Lock()
    next_i = iter(range(len(images)))

    def worker():
        while True:
            with lock:
                i = next(next_i, None)
            if i is None:
                return
            try:
                out[i] = np.asarray(router.route(images[i], model_id="vit", timeout_s=60.0))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
            if on_answer is not None:
                on_answer()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    return out, errors


def test_routed_vit_rows_match_jax_before_and_after_a_kill(jax_rows_and_spec, images):
    want, spec = jax_rows_and_spec
    metrics.reset()
    sink = JsonlTraceSink(capacity=8192)
    tracer.enable(sink)
    sup = ReplicaSupervisor(
        spec, replicas=2, monitor_interval_s=0.05, health_interval_s=1.0,
        spawn_timeout_s=120.0,
        backoff=RetryPolicy(max_attempts=8, base_delay_s=0.1, multiplier=1.5,
                            max_delay_s=0.5, jitter=0.0))
    try:
        with sup:
            assert sup.wait_live(2, 120), sup.status()
            rows, errors = _route_all(sup.router, images)
            assert not errors, errors
            np.testing.assert_allclose(np.stack(rows), want, **TOL)
            served = diagnose(sink.spans(), record_metrics=False)["per_replica"]
            assert len(served) == 2 and all(v["requests"] > 0 for v in served.values()), served

            # the second wave: SIGKILL replica 0 once a third is answered
            answered = []
            killed = {}

            def on_answer():
                answered.append(1)
                if len(answered) == N_IMAGES // 3 and not killed:
                    killed["pid"] = sup.kill_replica(0)

            wave = np.concatenate([images, images[::-1]])
            rows, errors = _route_all(sup.router, wave, on_answer=on_answer)
            assert killed, "the kill never fired"
            assert not errors, f"accepted requests lost: {errors[:3]}"
            np.testing.assert_allclose(np.stack(rows), np.concatenate([want, want[::-1]]), **TOL)

            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not (
                    sup.handles()[0].generation >= 2 and sup.live_count() == 2):
                time.sleep(0.05)
            assert sup.handles()[0].generation >= 2 and sup.live_count() == 2, sup.status()
            rows, errors = _route_all(sup.router, images[:8])
            assert not errors
            np.testing.assert_allclose(np.stack(rows), want[:8], **TOL)
    finally:
        tracer.disable()
