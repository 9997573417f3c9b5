"""ModelServer: registered models as online endpoints.

Port of ``sparkdl_tpu.serving.server``. Any torch ``forward(batch) ->
batch``, a :class:`~sparkdl_tpu_torch.graph.TorchFunction`, a Keras model
or file, or a UDF registered through ``registerKerasImageUDF`` becomes an
endpoint with dynamic micro-batching, warm compiled programs, admission
control and ``serving.*`` metrics, on the card unless the server is built
with ``device="cpu"``::

    server = ModelServer.from_registered_udf("my_cnn", session=spark)
    server.warmup()                      # compile (or load) the programs
    fut = server.submit(image_array)     # one request's Future
    probs = fut.result(timeout=5.0)
    server.status()                      # a /healthz-style snapshot

``metrics_text()`` renders the process's metrics in the Prometheus text
format (:func:`sparkdl_tpu_torch.obs.export.prometheus_text`);
``start_telemetry()`` serves them, with ``/healthz``, ``/slo`` and
``/debug/*``, through :class:`~sparkdl_tpu_torch.obs.server.ObsServer`.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from sparkdl_tpu_torch.serving.cache import ProgramCache
from sparkdl_tpu_torch.serving.decode import DecodeEndpoint, DecodeRequest
from sparkdl_tpu_torch.utils.device import resolve_device
from sparkdl_tpu_torch.utils.metrics import metrics


class ModelServer:
    """A set of online endpoints on one device, sharing one config and one
    warm :class:`ProgramCache`. ``device=None`` is the card, which raises
    without one; pass ``"cpu"`` for the CPU."""

    def __init__(self, config: Optional[ServingConfig] = None, device=None):
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        self._cache = ProgramCache(maxsize=self.config.cache_size,
                                   compile_counter=metrics.counter("serving.compiles"))
        self._endpoints: Dict[str, Any] = {}
        self._default: Optional[str] = None
        self._started_at = time.monotonic()
        self._closed = False
        self._telemetry: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _add(self, model_id: str, endpoint) -> "ModelServer":
        if model_id in self._endpoints:
            raise ValueError(f"endpoint {model_id!r} already registered")
        self._endpoints[model_id] = endpoint
        if self._default is None:
            self._default = model_id
        return self

    def register(
        self,
        model_id: str,
        forward: Callable[[Any], Any],
        item_shape: Optional[Sequence[int]] = None,
        dtype: Any = np.float32,
        compile: bool = True,
        fingerprint: Optional[str] = None,
        prologue: Optional[Callable[[Any], Any]] = None,
        params: Any = None,
    ) -> "ModelServer":
        """Register ``forward(batch) -> batch`` (tensors on the server's
        device) as endpoint ``model_id``; returns ``self``.

        With ``params``, a pytree of the weights' tensors on the server's
        device, the forward is ``forward(params, batch)`` and its programs
        take the weights as an input: all of them share this one copy, and a
        persisted program holds code only. Weights a forward closes over
        instead are compiled into every program of the endpoint.

        ``item_shape`` (one item, no batch dim) allows a cold
        :meth:`warmup`; without it the first request binds the shape.
        ``fingerprint``, a durable identity of the model and its weights,
        lets the endpoint's programs persist to the compile cache (a
        restarted server's :meth:`warmup` loads them) and gives a compiled
        endpoint ragged slot-block dispatch (without one it serves on the
        padded ladder). ``prologue``, a row-independent torch input stage
        (:func:`~sparkdl_tpu_torch.transformers.utils.make_input_prologue`),
        is compiled into the endpoint's program with the forward.
        ``compile=False`` runs the forward eagerly."""
        return self._add(model_id, MicroBatcher(
            model_id, forward, self.config, self._cache, item_shape=item_shape, dtype=dtype,
            compile=compile, fingerprint=fingerprint, prologue=prologue, params=params,
            device=self.device))

    def register_decode(
        self,
        model_id: str,
        step_fn: Callable[[Any], Tuple[Any, Any]],
        init_fn: Callable[[Any], Any],
        max_steps: int,
        eos_fn: Optional[Callable] = None,
        n_slots: int = 8,
        dtype: Any = np.float32,
        compile: bool = True,
        fingerprint: Optional[str] = None,
    ) -> "ModelServer":
        """Register an autoregressive decode endpoint.
        ``step_fn(carries) -> (new_carries, tokens)`` runs fused over the
        endpoint's ``(n_slots, *carry_shape)`` pool on the server's device
        each step, one compiled program per pool shape; ``init_fn(prompt)
        -> carry`` seeds a slot; ``eos_fn(token, step) -> bool`` ends a
        stream early; ``max_steps`` caps every stream. Serve with
        :meth:`decode` and :meth:`submit_decode`."""
        return self._add(model_id, DecodeEndpoint(
            model_id, step_fn, init_fn, max_steps, eos_fn=eos_fn, n_slots=n_slots,
            queue_capacity=self.config.queue_capacity, dtype=dtype, compile=compile,
            fingerprint=fingerprint, tenant_policy=self.config.tenant_policy,
            device=self.device))

    @classmethod
    def from_torch_function(cls, fn, model_id: Optional[str] = None,
                            config: Optional[ServingConfig] = None,
                            device=None) -> "ModelServer":
        """Serve a :class:`~sparkdl_tpu_torch.graph.TorchFunction` (its first
        output), the counterpart of the JAX package's ``from_xla_function``.
        Its params are placed on ``device`` once and passed to the
        endpoint's programs as an input; its ``fingerprint`` (set by
        ``from_keras``, ``load``, or by the caller) passes on to the
        endpoint."""
        server = cls(config=config, device=device)

        def forward(params, x, _apply=fn.apply):
            return _apply(params, x)[0]

        item_shape = None
        if getattr(fn, "input_specs", None):
            shape, _ = fn.input_specs[0]
            item_shape = tuple(shape[1:])
        return server.register(model_id or fn.name, forward, item_shape=item_shape,
                               fingerprint=getattr(fn, "fingerprint", None),
                               params=fn.placed_params(server.device))

    @classmethod
    def from_keras(cls, model_or_file, model_id: Optional[str] = None,
                   config: Optional[ServingConfig] = None,
                   compute_dtype: Optional[str] = None, device=None) -> "ModelServer":
        """Serve a Keras model, or a saved ``.keras`` / ``.h5`` file."""
        from sparkdl_tpu_torch.graph.function import TorchFunction

        fn = TorchFunction.from_keras(model_or_file, compute_dtype=compute_dtype)
        return cls.from_torch_function(fn, model_id=model_id, config=config, device=device)

    @classmethod
    def from_registered_udf(cls, udf_name: str, session=None,
                            config: Optional[ServingConfig] = None) -> "ModelServer":
        """Serve a UDF registered with ``registerKerasImageUDF`` as an online
        endpoint on the UDF's device: the forward its SQL path runs (cast,
        resize and model), compiled into one program and fed by the
        micro-batcher instead of a DataFrame partition."""
        from sparkdl_tpu_torch.sql.session import TorchSession

        session = session or TorchSession.getActiveSession()
        udf = session.udf.resolve(udf_name)
        meta = getattr(udf, "_serving_endpoint", None)
        if meta is None:
            raise ValueError(
                f"UDF {udf_name!r} was not registered by registerKerasImageUDF (only model "
                "UDFs carry a serving forward); register the model directly with "
                "ModelServer.register instead")
        server = cls(config=config, device=meta["device"])
        return server.register(meta["model_id"], meta["forward"], item_shape=meta["item_shape"],
                               dtype=meta["dtype"], fingerprint=meta.get("fingerprint"),
                               params=meta["params"])

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def _endpoint(self, model_id: Optional[str]):
        if model_id is None:
            if len(self._endpoints) != 1:
                raise ValueError(f"model_id is required when the server hosts "
                                 f"{len(self._endpoints)} endpoints ({sorted(self._endpoints)})")
            model_id = self._default
        try:
            return self._endpoints[model_id]
        except KeyError:
            raise KeyError(f"no endpoint {model_id!r}; registered: "
                           f"{sorted(self._endpoints)}") from None

    def fingerprints(self) -> Dict[str, str]:
        """Endpoint id -> durable fingerprint, for every endpoint that has
        one: what a replica advertises in its ready line (the version half
        of the router's result-cache keys); an endpoint without one is
        absent (uncacheable)."""
        return {mid: ep.fingerprint for mid, ep in self._endpoints.items() if ep.fingerprint}

    def submit(self, value, model_id: Optional[str] = None,
               deadline_ms: Optional[float] = None, tenant: Optional[str] = None) -> Future:
        """Admit one item for ``model_id`` (optional when the server hosts
        one endpoint); returns its Future."""
        return self._endpoint(model_id).submit(value, deadline_ms=deadline_ms, tenant=tenant)

    def predict(self, value, model_id: Optional[str] = None, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None, tenant: Optional[str] = None):
        return self._endpoint(model_id).predict(value, timeout=timeout,
                                                deadline_ms=deadline_ms, tenant=tenant)

    def _decode_endpoint(self, model_id: Optional[str]) -> DecodeEndpoint:
        ep = self._endpoint(model_id)
        if not isinstance(ep, DecodeEndpoint):
            raise TypeError(f"endpoint {ep.model_id!r} is a one-shot endpoint; decode needs "
                            "register_decode")
        return ep

    def submit_decode(self, prompt, model_id: Optional[str] = None,
                      emit: Optional[Callable[[dict], Any]] = None,
                      max_steps: Optional[int] = None, deadline_ms: Optional[float] = None,
                      tenant: Optional[str] = None,
                      trace: Optional[Tuple[int, int]] = None) -> DecodeRequest:
        """Admit one decode stream; ``emit`` receives the stream's frames as
        tokens land (None: collect them all). The request's ``future``
        resolves with the stacked tokens. ``trace`` is a remote parent span
        from the wire."""
        return self._decode_endpoint(model_id).submit(
            prompt, emit=emit, max_steps=max_steps, deadline_ms=deadline_ms, tenant=tenant,
            trace=trace)

    def decode(self, prompt, model_id: Optional[str] = None, max_steps: Optional[int] = None,
               deadline_ms: Optional[float] = None, tenant: Optional[str] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking decode: the whole ``(steps, *token_shape)`` output."""
        return self._decode_endpoint(model_id).decode(
            prompt, max_steps=max_steps, deadline_ms=deadline_ms, tenant=tenant,
            timeout=timeout)

    # ------------------------------------------------------------------
    # warmup, observability, lifecycle
    # ------------------------------------------------------------------
    def warmup(self, model_id: Optional[str] = None,
               buckets: Optional[Sequence[int]] = None) -> Dict[str, Tuple]:
        """Compile (or load from the cache) the programs of one endpoint, or
        of all; returns ``{model_id: what was warmed}`` (bucket sizes, or
        ``"ragged"`` for a slot-block program). Each program's source and
        seconds are in ``status()["program_cache"]["warmup"]``."""
        targets = ([self._endpoint(model_id)] if model_id is not None
                   else list(self._endpoints.values()))
        out: Dict[str, Tuple] = {}
        for ep in targets:
            if isinstance(ep, DecodeEndpoint):
                # one program (the pool shape), warmable once a request or
                # an example bound the carry shape
                try:
                    src = ep.warmup()
                    out[ep.model_id] = (src,) if src else ()
                except ValueError:
                    out[ep.model_id] = ()
            else:
                out[ep.model_id] = ep.warmup(buckets=buckets)
        return out

    def status(self, probe_device: bool = False, probe_timeout_s: int = 60) -> Dict[str, Any]:
        """A ``/healthz``-style snapshot: endpoints, queue depths, programs
        and the ``serving.*`` metrics. An endpoint whose breaker is not
        closed is ``degraded`` (its batches fail fast until a probe
        succeeds); the server stays healthy. ``probe_device=True`` also
        checks the card from a bounded subprocess
        (:func:`~sparkdl_tpu_torch.resilience.watchdog.check_device`), so a
        wedged card reports unhealthy with a typed ``error_class`` instead of
        hanging the health check."""
        out: Dict[str, Any] = {
            "healthy": not self._closed and all(
                ep.worker_alive or ep.queue_depth == 0 for ep in self._endpoints.values()),
            "degraded": sorted(mid for mid, ep in self._endpoints.items() if ep.degraded),
            "closed": self._closed,
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "endpoints": {mid: ep.describe() for mid, ep in self._endpoints.items()},
            "program_cache": self._cache.stats(),
            "metrics": metrics.snapshot(prefix="serving."),
        }
        if probe_device:
            from sparkdl_tpu_torch.resilience.watchdog import check_device

            out["device"] = check_device(timeout_s=probe_timeout_s)
            out["healthy"] = out["healthy"] and out["device"]["ok"]
        return out

    def metrics_text(self, serving_only: bool = False) -> str:
        """The process's metrics in the Prometheus text exposition format
        (only the ``serving.*`` series when ``serving_only``): what a
        ``/metrics`` endpoint serves."""
        from sparkdl_tpu_torch.obs.export import prometheus_text

        return prometheus_text(metrics, prefix="serving." if serving_only else None)

    def start_telemetry(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        sample_interval_s: float = 1.0,
        slo_interval_s: float = 5.0,
        latency_threshold_ms: float = 250.0,
        latency_objective: float = 0.99,
        error_objective: float = 0.999,
        extra_slos: Optional[Sequence] = None,
        **slo_overrides,
    ):
        """Start this server's telemetry plane; returns its
        :class:`~sparkdl_tpu_torch.obs.server.ObsServer` (``.url`` is the
        scrape target; ``port=0`` picks a free port).

        Wires a :class:`~sparkdl_tpu_torch.obs.timeseries.TimeSeriesRecorder`
        sampling the registry every ``sample_interval_s``; an
        :class:`~sparkdl_tpu_torch.obs.slo.SLOEngine` with each endpoint's
        latency and error-rate objectives
        (:func:`~sparkdl_tpu_torch.obs.slo.serving_slos`, tuned by the
        keywords and ``slo_overrides``) and any ``extra_slos``; a span sink
        behind ``/debug/spans`` (spans flow while tracing is on); and
        ``/healthz`` backed by :meth:`status`, 200 while healthy and 503 when
        not. :meth:`close` tears it down. A second call returns the running
        server."""
        if self._telemetry is not None:
            return self._telemetry["server"]
        from sparkdl_tpu_torch.obs import (
            JsonlTraceSink,
            ObsServer,
            SLOEngine,
            TimeSeriesRecorder,
            serving_slos,
            tracer,
        )

        recorder = TimeSeriesRecorder(interval_s=sample_interval_s).start()
        engine = SLOEngine(recorder)
        for mid in self._endpoints:
            engine.add(*serving_slos(
                mid, latency_threshold_ms=latency_threshold_ms,
                latency_objective=latency_objective, error_objective=error_objective,
                **slo_overrides))
        if extra_slos:
            engine.add(*extra_slos)
        engine.start(interval_s=slo_interval_s)
        sink = JsonlTraceSink(capacity=1024)
        tracer.add_sink(sink)
        server = ObsServer(port=port, host=host, recorder=recorder, slo_engine=engine,
                           span_sink=sink, health_fn=self.status).start()
        self._telemetry = {"server": server, "recorder": recorder, "engine": engine,
                           "sink": sink}
        return server

    @property
    def telemetry(self) -> Optional[Dict[str, Any]]:
        """The live plane (``server``, ``recorder``, ``engine``, ``sink``),
        or None before :meth:`start_telemetry`."""
        return self._telemetry

    def close(self) -> None:
        self._closed = True
        if self._telemetry is not None:
            plane, self._telemetry = self._telemetry, None
            from sparkdl_tpu_torch.obs import tracer

            plane["engine"].stop()
            plane["recorder"].stop()
            plane["server"].close()
            tracer.remove_sink(plane["sink"])
        for ep in self._endpoints.values():
            ep.close()

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (f"ModelServer(endpoints={sorted(self._endpoints)}, device={self.device}, "
                f"config={self.config})")
