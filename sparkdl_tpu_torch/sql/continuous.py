"""Continuous SQL: standing windowed queries over watermarked streams.

The port's copy of ``sparkdl_tpu.sql.continuous`` (host Python, unchanged
but for its imports and the serving hook's ``params``). The SQL plane
(``session.sql``) evaluates bounded temp views; the streaming plane
(``StreamRunner``) scores unbounded sources exactly-once. Here a
:class:`~sparkdl_tpu_torch.streaming.sources.StreamSource` registers as a
**stream table** (:meth:`TorchSession.readStream`) and a standing query ::

    SELECT endpoint, p95(latency) AS p95_ms
    FROM scores
    GROUP BY WINDOW(event_time_ms, '10s'), endpoint

runs as a continuous dataflow:

- the ``WINDOW(time_col, 'size'[, 'slide'])`` grammar extension parses
  into a :class:`ContinuousPlan` (tumbling or sliding event-time
  windows; ``csql.plan`` fault site);
- a poller thread admits records through the serving layer's bounded
  :class:`~sparkdl_tpu_torch.serving.admission.AdmissionQueue` via the
  blocking ``offer_wait`` — a full queue stalls the poller, so
  **backpressure reaches the source** instead of shedding rows;
- rows fold into a checkpointable
  :class:`~sparkdl_tpu_torch.sql.window_state.WindowStateStore`; window
  **closure** is driven by the existing
  :class:`~sparkdl_tpu_torch.streaming.sources.WatermarkTracker` (bounded
  lateness), and a row whose every window already closed is routed to a
  registered **side-output sink** and counted (``csql.late_rows``) —
  never silently dropped;
- model UDFs (``registerKerasImageUDF`` / any ``_serving_endpoint``-
  hooked function) score **inside the query**: aggregate arguments like
  ``p95(score(f))`` route each batch through a
  :class:`~sparkdl_tpu_torch.serving.server.ModelServer` endpoint — riding
  its admission control and micro-batcher, sharing capacity with
  interactive traffic;
- every epoch commits through the payload-then-marker
  :class:`~sparkdl_tpu_torch.streaming.commit.CommitLog`: the payload carries
  the epoch's closed-window results, its late rows, the source's
  ``end_offset``, AND a snapshot of the open-window accumulators — so a
  SIGKILL between payload and marker (``streaming.window_commit`` fault
  site) replays the emission idempotently and resumes aggregation from
  the checkpointed state, never from scratch.

Late-row semantics are **batching-independent**: a row contributes to an
assigned window iff that window's end is still ahead of the watermark at
the moment the row is ingested (rows are ingested in source order).
Window *contents* therefore depend only on the input order, not on
micro-batch boundaries — which is what makes a killed-and-restarted
run's emitted windows byte-identical to an uninterrupted reference run
(pinned by the continuous-SQL kill tests).
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import Preempted
from sparkdl_tpu_torch.resilience.preempt import preemption_scope
from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request
from sparkdl_tpu_torch.sql.window_state import (
    WINDOW_AGG_SPECS,
    WindowStateStore,
    assign_windows,
    parse_duration_ms,
)
from sparkdl_tpu_torch.streaming.commit import CommitLog, Sink
from sparkdl_tpu_torch.streaming.runner import StreamConfig, _jsonable
from sparkdl_tpu_torch.streaming.sources import StreamSource, WatermarkTracker
from sparkdl_tpu_torch.utils.metrics import metrics


class ContinuousQueryError(ValueError):
    """A query outside the continuous dialect, or a stream row the plan
    cannot bind (missing event-time column, non-dict row, ...)."""


class StreamTableError(RuntimeError):
    """A catalog operation that would break a stream table — e.g.
    dropping one while a continuous query is reading it."""


class StreamTable:
    """A :class:`StreamSource` registered as a queryable table.

    ``active_query`` names the :class:`ContinuousQuery` currently
    reading the table (at most one — a stream source's read position is
    single-consumer); the catalog refuses to drop the table while set.
    """

    def __init__(self, name: str, source: StreamSource):
        self.name = name
        self.source = source
        self.active_query: Optional[str] = None

    def __repr__(self):
        state = f" (read by {self.active_query!r})" if self.active_query \
            else ""
        return f"StreamTable({self.name!r}{state})"


class ContinuousAgg(NamedTuple):
    """One aggregate of the select list: ``label`` is the output column,
    ``fn_key`` indexes :data:`WINDOW_AGG_SPECS`, ``arg`` is ``"*"`` or
    the input column, ``udf`` the registered function wrapping the
    column (``p95(score(f))`` -> arg="f", udf="score"), or None."""

    label: str
    fn_key: str
    arg: str
    udf: Optional[str]


_HEAD_RE = re.compile(
    r"^\s*SELECT\s+(?P<proj>.+?)\s+FROM\s+(?P<table>\w+)\s*$",
    re.IGNORECASE | re.DOTALL,
)
_WINDOW_GROUP_RE = re.compile(
    r"^WINDOW\s*\(\s*(?P<col>\w+)\s*,\s*'(?P<size>[^']+)'"
    r"(?:\s*,\s*'(?P<slide>[^']+)')?\s*\)$",
    re.IGNORECASE,
)
_AGG_CALL_RE = re.compile(
    r"^(?P<fn>\w+)\s*\(\s*(?P<arg>\*|\w+|\w+\s*\(\s*\w+\s*\))\s*\)$",
    re.DOTALL,
)
_UDF_ARG_RE = re.compile(r"^(?P<udf>\w+)\s*\(\s*(?P<col>\w+)\s*\)$")


class ContinuousPlan:
    """The parsed form of one continuous query (table, window, keys,
    aggregates, optional WHERE text).  Parsing fires the ``csql.plan``
    fault site and raises :class:`ContinuousQueryError` on anything
    outside the dialect — a standing query must fail at plan time, not
    row 10^9."""

    def __init__(self, table, time_col, size_ms, slide_ms, keys, aggs,
                 where, query):
        self.table: str = table
        self.time_col: str = time_col
        self.size_ms: float = size_ms
        self.slide_ms: float = slide_ms
        self.keys: List[str] = keys
        self.aggs: List[ContinuousAgg] = aggs
        self.where: Optional[str] = where
        self.query: str = query

    @property
    def sliding(self) -> bool:
        return self.slide_ms != self.size_ms

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, session, query: str) -> "ContinuousPlan":
        from sparkdl_tpu_torch.sql.session import TorchSession

        inject.fire("csql.plan")

        def bad(msg: str) -> ContinuousQueryError:
            return ContinuousQueryError(
                f"{msg}\n  in continuous query: {query.strip()!r}"
            )

        parts = TorchSession._split_clauses(query)
        if parts is None:
            raise bad("unsupported clause shape (continuous dialect: "
                      "SELECT ... FROM <stream> [WHERE ...] GROUP BY "
                      "WINDOW(time_col, 'size'[, 'slide'])[, key, ...])")
        head, clauses = parts
        for banned, why in (
            ("order", "ORDER BY never terminates over an unbounded "
                      "stream; sort the sink offline"),
            ("limit", "LIMIT is not meaningful over an unbounded stream"),
            ("having", "HAVING is not supported in continuous queries "
                       "yet; filter the emitted windows downstream"),
        ):
            if banned in clauses:
                raise bad(why)
        m = _HEAD_RE.match(head)
        if not m:
            if re.search(r"\bJOIN\b", head, re.IGNORECASE):
                raise bad("JOIN is not supported in continuous queries")
            raise bad("head must be SELECT <projections> FROM <stream>")
        group = clauses.get("group")
        if not group:
            raise bad("continuous queries require GROUP BY "
                      "WINDOW(time_col, 'size'[, 'slide'])")

        # -- GROUP BY: exactly one WINDOW(...), rest are key columns ----
        time_col = size_ms = slide_ms = None
        keys: List[str] = []
        for raw in TorchSession._split_projections(group):
            raw = raw.strip()
            wm = _WINDOW_GROUP_RE.match(raw)
            if wm:
                if time_col is not None:
                    raise bad("GROUP BY has more than one WINDOW(...)")
                time_col = wm.group("col")
                try:
                    size_ms = parse_duration_ms(wm.group("size"))
                    slide_ms = (
                        parse_duration_ms(wm.group("slide"))
                        if wm.group("slide") else size_ms
                    )
                except ValueError as e:
                    raise bad(str(e)) from None
                if slide_ms > size_ms:
                    raise bad(
                        f"WINDOW slide ({wm.group('slide')}) larger than "
                        f"its size ({wm.group('size')}) leaves gaps — "
                        "rows between windows would be dropped silently"
                    )
            elif re.fullmatch(r"\w+", raw):
                keys.append(raw)
            else:
                raise bad(f"GROUP BY item {raw!r} must be WINDOW(...) or "
                          "a plain column name")
        if time_col is None:
            raise bad("GROUP BY must contain WINDOW(time_col, 'size'"
                      "[, 'slide']) — an unwindowed aggregate never "
                      "closes over an unbounded stream")

        # -- projections: keys, window bounds, aggregates ---------------
        aggs: List[ContinuousAgg] = []
        seen_labels = set(("window_start", "window_end"))
        for raw in TorchSession._split_projections(m.group("proj")):
            raw = raw.strip()
            expr, alias = TorchSession._strip_alias(raw)
            if re.fullmatch(r"\w+", expr):
                low = expr.lower()
                if low in ("window_start", "window_end"):
                    if alias:
                        raise bad(f"{expr} cannot be aliased (it is "
                                  "emitted under its own name)")
                    continue  # always emitted
                if expr in keys:
                    if alias:
                        raise bad(
                            f"group key {expr!r} cannot be aliased in a "
                            "continuous query (keys are emitted under "
                            "their own names)"
                        )
                    continue  # keys are always emitted
                raise bad(f"projection {expr!r} is neither a GROUP BY "
                          "key nor an aggregate")
            am = _AGG_CALL_RE.match(expr)
            if not am:
                raise bad(f"unsupported projection {raw!r}")
            fn_key = am.group("fn").lower()
            if fn_key == "mean":
                fn_key = "avg"
            arg = am.group("arg").strip()
            if fn_key not in WINDOW_AGG_SPECS:
                # the fn position might itself be a UDF call used bare —
                # not an aggregate; continuous projections must aggregate
                raise bad(
                    f"{am.group('fn')}(...) is not a window aggregate; "
                    f"supported: {sorted(WINDOW_AGG_SPECS)}"
                )
            udf_name = None
            um = _UDF_ARG_RE.match(arg)
            if um:
                udf_name = um.group("udf")
                arg = um.group("col")
                if session.udf.resolve(udf_name) is None:
                    raise bad(
                        f"{udf_name!r} is not a registered UDF "
                        f"(in aggregate argument {am.group('arg')!r})"
                    )
            if arg == "*" and fn_key != "count":
                raise bad(f"{fn_key}(*) is not defined; use a column")
            label = alias or re.sub(r"\s+", "", expr)
            if label in seen_labels or label in keys:
                raise bad(f"duplicate output column {label!r}; alias "
                          "repeated aggregates distinctly")
            seen_labels.add(label)
            aggs.append(ContinuousAgg(label, fn_key, arg, udf_name))
        if not aggs:
            raise bad("a continuous query needs at least one aggregate "
                      "projection")
        return cls(
            m.group("table"), time_col, float(size_ms), float(slide_ms),
            keys, aggs, clauses.get("where"), query,
        )


def _scalarize(v: Any) -> Any:
    """Model outputs feed numeric aggregates: squeeze single-element
    arrays to scalars, leave the rest to ``_jsonable`` downstream."""
    if isinstance(v, np.ndarray):
        return v.item() if v.size == 1 else v.tolist()
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return v


class ContinuousQuery:
    """One standing windowed query: plan + poller + window state +
    exactly-once emission.  Mirrors :class:`StreamRunner`'s lifecycle
    (``run(max_epochs, idle_timeout_s)`` / context manager / SIGTERM
    flush) so everything that operates runners operates queries.

    ``sink`` receives one record per closed window; ``late_sink`` (any
    :class:`~sparkdl_tpu_torch.streaming.commit.Sink`) receives the side
    output of rows whose every window had already closed.  Both ride
    the commit log's epoch numbering, so replays after a crash are
    idempotent in both sinks.
    """

    def __init__(
        self,
        session,
        query: str,
        sink: Sink,
        checkpoint_dir: str,
        late_sink: Optional[Sink] = None,
        server=None,
        config: Optional[StreamConfig] = None,
        name: Optional[str] = None,
    ):
        from sparkdl_tpu_torch.obs.trace import tracer

        with tracer.span("csql.plan"):
            self.plan = ContinuousPlan.parse(session, query)
        self.session = session
        self.name = name or f"csql:{self.plan.table}"
        table = session.catalog.streamTable(self.plan.table)
        if table.active_query is not None \
                and table.active_query != self.name:
            raise StreamTableError(
                f"stream table {self.plan.table!r} is already read by "
                f"running query {table.active_query!r}; a stream's read "
                "position is single-consumer"
            )
        table.active_query = self.name
        self._table = table
        self.source = table.source
        self.sink = sink
        self.late_sink = late_sink
        self.server = server
        self.config = config or StreamConfig()
        self.log = CommitLog(checkpoint_dir)
        self.state = WindowStateStore(
            [(a.label, a.fn_key) for a in self.plan.aggs]
        )
        self._watermark = WatermarkTracker(
            allowed_lateness_ms=self.config.allowed_lateness_ms
        )
        self._queue = AdmissionQueue(
            self.config.queue_capacity,
            depth_gauge=metrics.gauge("csql.queue_depth"),
            shed_counter=metrics.counter("csql.shed"),
        )
        self._stop_poller = threading.Event()
        self._source_done = threading.Event()
        self._poller_error: Optional[BaseException] = None
        self._next_epoch = (self.log.last_committed() or 0) + 1
        self._late_total = 0  # this query's side-output rows (summary)
        self._where_pred = None  # lazily parsed against live columns
        self._bind_udf_endpoints()
        # metrics: the csql. namespace
        self._m_rows_in = metrics.counter("csql.rows_in")
        self._m_late = metrics.counter("csql.late_rows")
        self._m_windows = metrics.counter("csql.windows_closed")
        self._m_epochs = metrics.counter("csql.epochs_committed")
        self._m_open = metrics.gauge("csql.open_windows")
        self._m_wm_lag = metrics.gauge("csql.watermark_lag_ms")
        self._m_offset = metrics.gauge("csql.committed_offset")
        self._m_emit = metrics.histogram("csql.emit_latency_ms")

    # ------------------------------------------------------------------
    def _bind_udf_endpoints(self) -> None:
        """Resolve every aggregate's UDF once at plan-bind time.  A UDF
        carrying a ``_serving_endpoint`` hook scores through
        ``self.server`` (registered on it if absent, with the hook's
        ``params``: the port's keras UDFs pass their weights to their
        forward); a plain UDF is called directly (vectorized gets the whole
        column list)."""
        self._scorers: Dict[str, Callable[[List[Any]], List[Any]]] = {}
        for agg in self.plan.aggs:
            if agg.udf is None or agg.udf in self._scorers:
                continue
            udf = self.session.udf.resolve(agg.udf)
            meta = getattr(udf, "_serving_endpoint", None)
            if meta is not None and self.server is not None:
                model_id = meta["model_id"]
                if model_id not in self.server._endpoints:
                    self.server.register(
                        model_id,
                        meta["forward"],
                        item_shape=meta["item_shape"],
                        dtype=meta["dtype"],
                        fingerprint=meta.get("fingerprint"),
                        params=meta.get("params"),
                    )

                def score(values, _mid=model_id, _dt=meta["dtype"]):
                    futures = [
                        self.server.submit(
                            np.asarray(v, dtype=_dt), model_id=_mid
                        )
                        for v in values
                    ]
                    return [_scalarize(f.result()) for f in futures]

                self._scorers[agg.udf] = score
            elif udf.vectorized:
                self._scorers[agg.udf] = lambda values, _u=udf: [
                    _scalarize(v) for v in _u.func(values)
                ]
            else:
                self._scorers[agg.udf] = lambda values, _u=udf: [
                    _scalarize(_u.func(v)) for v in values
                ]

    # ------------------------------------------------------------------
    # row binding
    # ------------------------------------------------------------------
    def _event_time(self, rec) -> float:
        """Bind the plan's time column: the row's own field first, else
        the source-extracted ``Record.event_time_ms`` (what makes
        ``WINDOW(event_time_ms, ...)`` work without a user extractor).
        Typed error when neither exists — an unwindowable row cannot be
        silently dropped."""
        row = rec.value
        raw = row.get(self.plan.time_col) if isinstance(row, dict) else None
        if raw is None:
            raw = rec.event_time_ms
        if raw is None:
            raise ContinuousQueryError(
                f"row at offset {rec.offset} has no event time: "
                f"column {self.plan.time_col!r} is absent and the "
                "source extracted none (configure the source's "
                "event_time_field or add the column)"
            )
        try:
            return float(raw)
        except (TypeError, ValueError):
            raise ContinuousQueryError(
                f"row at offset {rec.offset}: event-time column "
                f"{self.plan.time_col!r} is non-numeric ({raw!r})"
            ) from None

    def _apply_where(self, rows: List[dict]) -> List[bool]:
        from sparkdl_tpu_torch.sql.session import _PredicateParser

        cols = sorted({k for r in rows for k in r})
        if self._where_pred is None or self._where_pred[0] != cols:
            pred = _PredicateParser(
                self.plan.where, udf_registry=self.session.udf,
                columns=cols, session=self.session,
            ).parse()
            self._where_pred = (cols, pred)
        pred = self._where_pred[1]
        part = {c: [r.get(c) for r in rows] for c in cols}
        return [bool(v) for v in pred._eval(part, len(rows))]

    # ------------------------------------------------------------------
    # poller thread (same offer_wait backpressure as StreamRunner)
    # ------------------------------------------------------------------
    def _poll_loop(self, run_span) -> None:
        from sparkdl_tpu_torch.obs.trace import tracer

        with tracer.use_span(run_span):
            try:
                while not self._stop_poller.is_set():
                    inject.fire("streaming.poll")
                    records = self.source.poll(self.config.poll_batch)
                    if not records:
                        if self.source.finished():
                            self._source_done.set()
                            return
                        self._stop_poller.wait(
                            self.config.poll_interval_ms / 1000.0
                        )
                        continue
                    self._m_rows_in.add(len(records))
                    for rec in records:
                        req = Request(value=rec)
                        while not self._queue.offer_wait(
                            req, timeout_s=self.config.offer_timeout_s
                        ):
                            if self._stop_poller.is_set():
                                return
            except BaseException as exc:
                self._poller_error = exc
                self._source_done.set()

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _recover(self) -> int:
        """Replay pending epochs (results AND late side-output, both
        from the stored payload — no re-aggregation), restore the
        open-window state from the newest payload, seek the source."""
        from sparkdl_tpu_torch.obs.trace import tracer

        pending = self.log.pending()
        with tracer.span("csql.recover", pending=len(pending)):
            for epoch in pending:
                payload = self.log.payload(epoch)
                self.sink.write(epoch, payload["closed"])
                if self.late_sink is not None and payload.get("late"):
                    self.late_sink.write(epoch, payload["late"])
                inject.fire("streaming.window_commit")
                self.log.commit(epoch)
            last = self.log.last_committed()
            newest = max(pending) if pending else last
            if newest is not None:
                payload = self.log.payload(newest)
                self.state.restore(payload.get("state"))
                wm = payload.get("max_event_ms")
                if wm is not None:
                    self._watermark.observe(wm)
            offset = self.log.resume_offset()
            if offset is not None:
                self.source.seek(int(offset))
            self._next_epoch = (self.log.last_committed() or 0) + 1
            self._m_open.set(self.state.open_windows)
        return len(pending)

    # ------------------------------------------------------------------
    # ingest + commit
    # ------------------------------------------------------------------
    def _ingest(self, requests: List[Request]) -> List[dict]:
        """Fold one admitted micro-batch into window state, in source
        order.  Returns the batch's late side-output records."""
        recs = [req.value for req in requests]
        rows: List[dict] = []
        for rec in recs:
            if not isinstance(rec.value, dict):
                raise ContinuousQueryError(
                    f"continuous queries bind columns by name; row at "
                    f"offset {rec.offset} is "
                    f"{type(rec.value).__name__}, not an object"
                )
            rows.append(rec.value)
        keep = (
            self._apply_where(rows) if self.plan.where else [True] * len(rows)
        )
        # score each UDF-wrapped aggregate argument once per batch (the
        # serving admission queue coalesces the per-row submits)
        scored: Dict[str, List[Any]] = {}
        for agg in self.plan.aggs:
            if agg.udf is None:
                continue
            cache_key = f"{agg.udf}({agg.arg})"
            if cache_key in scored:
                continue
            values = [
                row.get(agg.arg) for row, k in zip(rows, keep) if k
            ]
            if any(v is None for v in values):
                raise ContinuousQueryError(
                    f"aggregate argument column {agg.arg!r} is absent "
                    f"from a stream row (UDF {agg.udf!r} cannot score "
                    "NULL input)"
                )
            outs = iter(self._scorers[agg.udf](values))
            scored[cache_key] = [
                next(outs) if k else None for k in keep
            ]
        late: List[dict] = []
        for i, (rec, row) in enumerate(zip(recs, rows)):
            et = self._event_time(rec)
            self._watermark.observe(et)
            if not keep[i]:
                continue
            wm = self._watermark.watermark_ms
            live = [
                w for w in assign_windows(
                    et, self.plan.size_ms, self.plan.slide_ms
                )
                if wm is None or w[1] > wm
            ]
            if not live:
                # every window this row belongs to has already closed:
                # side output, never a silent drop
                self._m_late.add(1)
                self._late_total += 1
                late.append({
                    "offset": int(rec.offset),
                    "event_time_ms": et,
                    "input": _jsonable(row),
                })
                continue
            keys = tuple(row.get(k) for k in self.plan.keys)
            values = [
                scored[f"{a.udf}({a.arg})"][i] if a.udf is not None
                else (True if a.arg == "*" else row.get(a.arg))
                for a in self.plan.aggs
            ]
            for w in live:
                self.state.update(w, keys, values)
        return late

    def _result_records(self, closed: List[dict]) -> List[dict]:
        """Emission-ready rows: window bounds, group keys, aggregate
        cells — in deterministic column order (the byte-identity
        contract of the exactly-once tests)."""
        out = []
        for c in closed:
            rec = {
                "window_start": c["window_start"],
                "window_end": c["window_end"],
            }
            for k, v in zip(self.plan.keys, c["keys"]):
                rec[k] = v
            for agg, v in zip(self.plan.aggs, c["aggs"]):
                rec[agg.label] = _jsonable(v)
            out.append(rec)
        return out

    def _commit_epoch(self, epoch: int, requests: List[Request]) -> int:
        """Ingest one micro-batch, close every watermark-passed window,
        and commit the whole step — results, side output, source
        offset, and open-window state — as ONE payload-then-marker
        epoch.  A SIGKILL anywhere in here either replays the epoch
        from its payload or re-ingests the batch from the source;
        neither path loses or duplicates a window."""
        from sparkdl_tpu_torch.obs.trace import tracer

        t0 = time.monotonic()
        late = self._ingest(requests)
        closed = self.state.close_upto(self._watermark.watermark_ms)
        records = self._result_records(closed)
        self.log.write_payload(epoch, {
            "epoch": epoch,
            "query": self.plan.query,
            "end_offset": int(requests[-1].value.offset),
            "watermark_ms": self._watermark.watermark_ms,
            "max_event_ms": self._watermark.max_event_time_ms,
            "closed": records,
            "late": late,
            "state": self.state.snapshot(),
        })
        self.sink.write(epoch, records)
        if self.late_sink is not None and late:
            self.late_sink.write(epoch, late)
        inject.fire("streaming.window_commit")
        self.log.commit(epoch)
        emit_ms = (time.monotonic() - t0) * 1000.0
        cur = tracer.current()
        for c in closed:
            with tracer.span(
                "csql.window_close",
                window_start=c["window_start"],
                window_end=c["window_end"],
                rows=c["rows"],
            ):
                pass
            self._m_emit.observe(
                emit_ms, exemplar=cur.trace_id if cur is not None else None
            )
        self._m_windows.add(len(closed))
        self._m_epochs.add(1)
        self._m_open.set(self.state.open_windows)
        self._m_offset.set(int(requests[-1].value.offset))
        lag = self._watermark.lag_ms(time.time() * 1000.0)
        if lag is not None:
            self._m_wm_lag.set(lag)
        return len(closed)

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------
    def run(
        self,
        max_epochs: Optional[int] = None,
        idle_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Recover, then pull-aggregate-emit until a stop condition —
        the same contract as :meth:`StreamRunner.run` (source_finished /
        max_epochs / idle_timeout / preempted, with everything admitted
        flushed into committed epochs before returning)."""
        from sparkdl_tpu_torch.obs.trace import tracer

        epochs_start = self._next_epoch
        windows_emitted = 0
        stop_reason = "source_finished"
        with preemption_scope() as token:
            with tracer.span(
                "csql.query", query=self.plan.query, query_name=self.name
            ) as run_span:
                replayed = self._recover()
                poller = threading.Thread(
                    target=self._poll_loop,
                    args=(tracer.capture() if run_span else None,),
                    name="sparkdl-csql-poller",
                    daemon=True,
                )
                poller.start()
                idle_since: Optional[float] = None
                try:
                    while True:
                        try:
                            token.check()
                        except Preempted:
                            stop_reason = "preempted"
                            break
                        if (max_epochs is not None
                                and self._next_epoch - epochs_start
                                >= max_epochs):
                            stop_reason = "max_epochs"
                            break
                        batch = self._queue.take(
                            self.config.max_batch,
                            self.config.max_wait_ms / 1000.0,
                        )
                        if batch:
                            idle_since = None
                            epoch = self._next_epoch
                            self._next_epoch += 1
                            windows_emitted += self._commit_epoch(
                                epoch, batch
                            )
                            continue
                        if self._poller_error is not None:
                            raise self._poller_error
                        if (self._source_done.is_set()
                                and len(self._queue) == 0):
                            break
                        if idle_timeout_s is not None:
                            now = time.monotonic()
                            if idle_since is None:
                                idle_since = now
                            elif now - idle_since >= idle_timeout_s:
                                stop_reason = "idle_timeout"
                                break
                finally:
                    self._stop_poller.set()
                    poller.join()
                # flush everything already admitted (preemption contract)
                while True:
                    batch = self._queue.take(
                        self.config.max_batch, 0.0, poll_s=0.0
                    )
                    if not batch:
                        break
                    epoch = self._next_epoch
                    self._next_epoch += 1
                    windows_emitted += self._commit_epoch(epoch, batch)
                if run_span is not None:
                    run_span.set_attribute("stop_reason", stop_reason)
        return {
            "stop_reason": stop_reason,
            "epochs": self._next_epoch - epochs_start,
            "replayed": replayed,
            "windows_emitted": windows_emitted,
            "open_windows": self.state.open_windows,
            "late_rows": self._late_total,
            "last_committed": self.log.last_committed(),
            "committed_offset": self.log.resume_offset(),
            "watermark_ms": self._watermark.watermark_ms,
        }

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._stop_poller.set()
        self._queue.close()
        self.sink.close()
        if self.late_sink is not None:
            self.late_sink.close()
        if self._table.active_query == self.name:
            self._table.active_query = None

    def __enter__(self) -> "ContinuousQuery":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
