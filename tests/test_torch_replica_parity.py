"""The replica plane's host code against the JAX package's, in one process.

- The wire: :func:`encode_parts` gives the same bytes as
  ``sparkdl_tpu.serving.wire.encode_parts`` for the same plain messages
  (dicts of ints, floats, strings and numpy arrays; one-shot, batch and
  stream frames), and each package's decoder reads the other's frames.
  Typed errors cross by class NAME, so an error reply is the same bytes too;
  by design each side decodes it to its own package's class.
- The result cache: :func:`canonical_digest` and :func:`result_key` equal the
  reference's for the same values and fingerprints.
- ``diagnose`` on the same span JSONL (written by the port's router and an
  in-process replica with tracing on) gives the same report as
  ``sparkdl_tpu.obs.diag.diagnose``, and ``render_text`` the same text.
"""

import json
import os
import socket

import numpy as np
import pytest

from sparkdl_tpu.obs import diag as jax_diag
from sparkdl_tpu.serving import errors as jax_errors
from sparkdl_tpu.serving import result_cache as jax_result_cache
from sparkdl_tpu.serving import wire as jax_wire
from sparkdl_tpu_torch.obs import diag
from sparkdl_tpu_torch.obs.export import JsonlTraceSink
from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig, errors, result_cache, wire
from sparkdl_tpu_torch.serving.replica import ReplicaService
from sparkdl_tpu_torch.serving.router import Router
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry


def _messages():
    rng = np.random.default_rng(0)
    return {
        "infer": {"op": "infer", "model_id": "ep0", "seq": 7, "deadline_ms": 250.0,
                  "value": rng.standard_normal((3, 4)).astype(np.float32),
                  "trace": (123456789, 987654321), "tenant": "a"},
        "reply": {"ok": True, "result": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "server_ms": 1.25, "phases": {"replica_queue": 0.5, "forward": 0.75}},
        "image": {"op": "infer", "value": rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)},
        "fortran": {"value": np.asfortranarray(rng.standard_normal((5, 3)))},
        "nested": {"values": [np.int64(3), 2.5, "s", (1, np.zeros(2, np.int32))],
                   "inner": {"a": np.ones((2, 2), np.float16), "b": None}},
        "ping": {"op": "ping"},
    }


MESSAGES = _messages()


def _frame(parts):
    return b"".join(bytes(p) for p in parts)


@pytest.mark.parametrize("name", sorted(MESSAGES))
@pytest.mark.parametrize("kind", ["msg", "stream"])
def test_encode_parts_bytes_match_the_reference(name, kind):
    k = {"msg": wire.KIND_MSG, "stream": wire.KIND_STREAM}[kind]
    assert k == {"msg": jax_wire.KIND_MSG, "stream": jax_wire.KIND_STREAM}[kind]
    msg = MESSAGES[name]
    assert _frame(wire.encode_parts(msg, k)) == _frame(jax_wire.encode_parts(msg, k))


def test_batch_frame_bytes_match_the_reference():
    msgs = [MESSAGES["infer"], MESSAGES["image"], MESSAGES["ping"]]
    assert (_frame(wire.encode_parts(msgs, wire.KIND_BATCH))
            == _frame(jax_wire.encode_parts(msgs, jax_wire.KIND_BATCH)))


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", sorted(MESSAGES))
@pytest.mark.parametrize("writer,reader", [(wire, jax_wire), (jax_wire, wire)],
                         ids=["port-to-jax", "jax-to-port"])
def test_each_decoder_reads_the_others_frames(name, writer, reader):
    msg = MESSAGES[name]
    kind, got = reader.decode_frame(bytearray(_frame(writer.encode_parts(msg))))
    assert kind == reader.KIND_MSG
    _assert_same(got, msg)
    # and over a socket, the stream path
    a, b = socket.socketpair()
    try:
        writer.send_stream(a, msg)
        kind, got = reader.recv_any(b)
        assert kind == reader.KIND_STREAM
        _assert_same(got, msg)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", ["ServerOverloaded", "TenantThrottled", "DeadlineExceeded",
                                  "ServerClosed", "ReplicaDraining", "NoLiveReplicas",
                                  "RemoteReplicaError"])
def test_typed_errors_cross_by_class_name(name):
    port_exc = getattr(errors, name)("boom")
    jax_exc = getattr(jax_errors, name)("boom")
    assert (_frame(wire.encode_parts(wire.encode_error(port_exc)))
            == _frame(jax_wire.encode_parts(jax_wire.encode_error(jax_exc))))
    # by design each side rebuilds its own package's class of that name
    back = jax_wire.decode_error(wire.encode_error(port_exc))
    assert type(back) is getattr(jax_errors, name) and str(back) == "boom"
    back = wire.decode_error(jax_wire.encode_error(jax_exc))
    assert type(back) is getattr(errors, name) and str(back) == "boom"


# ----------------------------------------------------------------------
# the result cache's keys
# ----------------------------------------------------------------------
DIGEST_VALUES = {
    "f32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    "f32_fortran": np.asfortranarray(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)),
    "f64_same_bytes_other_dtype": np.zeros(3, np.float64),
    "u8_image": np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3),
    "strided": np.arange(20, dtype=np.int32)[::-2],
    "scalar": 3.5,
    "string": "a prompt",
    "tuple": (1, 2.0, "x"),
    "list": [1.0, 2.0],
}


@pytest.mark.parametrize("name", sorted(DIGEST_VALUES))
@pytest.mark.parametrize("meta", [None, {"max_steps": 8}])
def test_canonical_digest_and_result_key_match_the_reference(name, meta):
    value = DIGEST_VALUES[name]
    digest = result_cache.canonical_digest(value, meta)
    assert digest == jax_result_cache.canonical_digest(value, meta)
    for fingerprint in ("m:v1", "demo:ep0:dim64:v1", "vit-b16:bf16:" + "0" * 64):
        assert (result_cache.result_key(fingerprint, digest)
                == jax_result_cache.result_key(fingerprint, digest))


# ----------------------------------------------------------------------
# diagnose over the same spans
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def routed_span_file(tmp_path_factory):
    """A JSONL span file of 24 routed requests (two in-process replicas, one
    request failing at the replica), written by the port's tracer."""
    path = str(tmp_path_factory.mktemp("spans") / "spans.jsonl")
    sink = JsonlTraceSink(capacity=8192)
    tracer.enable(sink)
    servers, services = [], []
    try:
        for scale in (2.0, 2.0):
            server = ModelServer(ServingConfig(max_batch=8, max_wait_ms=1.0),
                                 device="cpu")

            def forward(x, _s=scale):
                if float(x[0, 0]) < -100:
                    raise ValueError("poison")
                return x * _s

            server.register("ep0", forward, item_shape=(4,), compile=False)
            servers.append(server)
            services.append(ReplicaService(server).start())
        with Router(seed=3) as router:
            for i, svc in enumerate(services):
                router.add(f"r{i}", "127.0.0.1", svc.port, lanes=("tcp",))
            for i in range(24):
                router.route(np.full(4, float(i), np.float32), model_id="ep0", timeout_s=10.0)
            with pytest.raises(errors.RemoteReplicaError, match="poison"):
                router.route(np.full(4, -1000.0, np.float32), model_id="ep0", timeout_s=10.0)
    finally:
        tracer.disable()
        for svc in services:
            svc.close()
    sink.flush(path)
    return path


def test_diagnose_matches_the_reference_on_the_same_spans(routed_span_file):
    with open(routed_span_file) as f:
        lines = f.read().splitlines()
    spans = [json.loads(ln) for ln in lines]
    assert {"router.request", "replica.serve"} <= {s["name"] for s in spans}
    got = diag.diagnose(spans, top=3, record_metrics=False)
    want = jax_diag.diagnose(spans, top=3, record_metrics=False)
    assert got == want
    assert got["requests"] == 25 and got["errored_requests"] == 1
    assert got["stitched_requests"] >= 24
    assert diag.render_text(got) == jax_diag.render_text(want)
    # the files' path through both readers, a torn line included
    torn = routed_span_file + ".torn"
    with open(torn, "w") as f:
        f.write("\n".join(lines) + "\n{\"name\": \"cut\n")
    got = diag.diagnose_paths([torn], record_metrics=False)
    assert got == jax_diag.diagnose_paths([torn], record_metrics=False)
    assert got["skipped_lines"] == 1
    assert diag.diagnose(spans, registry=MetricsRegistry(), record_metrics=False)["exemplars"] \
        == jax_diag.diagnose(spans, registry=MetricsRegistry(), record_metrics=False)["exemplars"]
    os.remove(torn)
