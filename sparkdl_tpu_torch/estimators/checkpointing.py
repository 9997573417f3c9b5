"""Checkpoint plumbing for the estimators, on ``torch.save``.

A copy of ``sparkdl_tpu.estimators.checkpointing`` with orbax replaced.
Both estimators keep the JAX package's resume contract: per-configuration
namespaces under one ``checkpointDir``, ``epoch_N`` subdirectories, async
commits, restore only from committed epochs, and an epoch cap so that a
shorter re-fit restores the exact earlier epoch. The payload, the
configuration fingerprint and the restore into a live state stay in the
estimators.

**The commit.** :meth:`AsyncCheckpointer.save` takes a snapshot of the
payload on the host before it returns: a copy of every tensor, since on the
CPU ``t.cpu()`` is ``t`` itself and the next optimizer step updates it in
place. A tensor on the card is copied into pinned host buffers on the
current stream, behind the step that produced it and ahead of the next one;
the writer waits on an event before it reads them. One background thread
writes ``payload.pt`` into ``epoch_N.tmp-<pid>-<n>``, fsyncs it, writes the
``COMMITTED`` marker last, and renames the directory to ``epoch_N``.
:func:`is_committed` requires the marker, so a torn save, a stray
``epoch_N`` or a directory written by the JAX package (orbax's layout) is
never resumed from.

**The fit loop.** :func:`restore_latest` and :func:`fit_epochs` are the
resume contract and the epoch loop both estimators run; each estimator
supplies only its payload, its restore into a live state and its namespace.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
from contextlib import closing
from itertools import count
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.preempt import preemption_scope
from sparkdl_tpu_torch.obs.hooks import fit_profiler
from sparkdl_tpu_torch.utils.metrics import metrics, record_commit

logger = logging.getLogger(__name__)

#: the file a committed epoch holds its payload in, and the marker written
#: after it
PAYLOAD = "payload.pt"
MARKER = "COMMITTED"


def _const_repr(c) -> str:
    """Process-stable repr of a code constant: set/frozenset literals
    (e.g. ``x in {"mean", "sum"}`` compiles a frozenset into co_consts)
    repr in string-hash order, which is PYTHONHASHSEED-randomized —
    render them sorted; tuples may nest them."""
    if hasattr(c, "co_code"):
        return _code_digest(c)
    if isinstance(c, (set, frozenset)):
        return "{" + ",".join(sorted(_const_repr(v) for v in c)) + "}"
    if isinstance(c, tuple):
        return "(" + ",".join(_const_repr(v) for v in c) + ")"
    return repr(c)


def _code_digest(code) -> str:
    """Digest of a function body: bytecode + referenced names + non-code
    consts + nested code objects.  Two defs with the same qualname but
    different bodies (an edited lambda loss, or one calling a different
    global — LOAD_GLOBAL indexes into co_names, not co_code) must not
    share a checkpoint namespace."""
    h = hashlib.sha256(code.co_code)
    h.update(repr(code.co_names).encode())
    for c in code.co_consts:
        h.update(_const_repr(c).encode())
    return h.hexdigest()[:8]


def stable_description(obj, depth: int = 0, seen=None) -> str:
    """A process-stable structural description of a configuration value,
    for checkpoint-namespace fingerprints.

    ``repr()`` of a flax module holding a callable ``attn_impl``, or of an
    optax ``GradientTransformation`` (a NamedTuple of closures), embeds
    ``<function ... at 0x7f...>`` memory addresses that change every
    process — hashing those would silently fork a fresh namespace on every
    re-fit instead of resuming.  Callables reduce to qualified name + body
    digest + defaults + bound-instance state + a recursive description of
    their closure cells (optax keeps the hyperparameters there — qualname
    alone would make ``adam(1e-3)`` and ``sgd(1e-2)`` collide);
    state-bearing objects with the default repr traverse their
    ``__dict__`` (or slot attributes); sets render sorted (their repr
    order is PYTHONHASHSEED-dependent); residual addresses in plain reprs
    are stripped; a ``torch.nn.Module`` is its class, its plain
    attributes, its parameters' and buffers' shapes and its children (see
    :func:`_module_description`).  Traversal order is structural, so the string is
    identical across processes; ``seen`` is path-scoped (ids are removed
    on the way out) so aliased-but-equal configs render identically,
    guarding only true reference cycles; the depth cap is a backstop above
    any real optax nesting."""
    if seen is None:
        seen = set()
    if depth > 24:
        return "<deep>"
    if (callable(obj) and hasattr(obj, "__qualname__")
            and not isinstance(obj, type)):
        if id(obj) in seen:
            return "<cycle>"
        seen.add(id(obj))
        try:
            name = f"{getattr(obj, '__module__', '')}.{obj.__qualname__}"
            parts = []
            code = getattr(obj, "__code__", None)
            if code is not None:
                parts.append(_code_digest(code))
            bound_self = getattr(obj, "__self__", None)
            if bound_self is not None:
                parts.append(
                    "self=" + stable_description(bound_self, depth + 1, seen)
                )
            defaults = getattr(obj, "__defaults__", None)
            if defaults:
                parts.append(
                    "defaults="
                    + stable_description(defaults, depth + 1, seen)
                )
            kwdefaults = getattr(obj, "__kwdefaults__", None)
            if kwdefaults:
                parts.append(
                    "kwdefaults="
                    + stable_description(
                        sorted(kwdefaults.items()), depth + 1, seen
                    )
                )
            for cell in (getattr(obj, "__closure__", None) or ()):
                try:
                    parts.append(
                        stable_description(
                            cell.cell_contents, depth + 1, seen
                        )
                    )
                except ValueError:
                    parts.append("<empty>")
            return f"{name}({','.join(parts)})" if parts else name
        finally:
            seen.discard(id(obj))
    if isinstance(obj, torch.nn.Module):
        return _module_description(obj, depth, seen)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        inner = ",".join(
            f"{f}={stable_description(getattr(obj, f), depth + 1, seen)}"
            for f in obj._fields
        )
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, (tuple, list)):
        return "[" + ",".join(
            stable_description(v, depth + 1, seen) for v in obj
        ) + "]"
    if isinstance(obj, dict):
        return "{" + ",".join(
            f"{stable_description(k, depth + 1, seen)}:"
            f"{stable_description(v, depth + 1, seen)}"
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
        ) + "}"
    if isinstance(obj, (set, frozenset)):
        return "{" + ",".join(
            sorted(stable_description(v, depth + 1, seen) for v in obj)
        ) + "}"
    r = re.sub(r" at 0x[0-9a-fA-F]+", "", repr(obj))
    # the default object repr ('<m.FocalLoss object>') carries no state:
    # a loss instance with gamma=2 vs gamma=5 must differ, so describe
    # the instance state too — __dict__, or slot attributes for
    # __slots__ classes (path-scoped cycle guard, as above)
    # (qualnames may contain '<locals>', hence \S+ not [\w.]+)
    if re.fullmatch(r"<\S+ object>", r):
        state = getattr(obj, "__dict__", None)
        if not state:
            slot_names = []
            for klass in type(obj).__mro__:
                slots = getattr(klass, "__slots__", ()) or ()
                if isinstance(slots, str):
                    slots = (slots,)
                slot_names.extend(slots)
            state = {
                s: getattr(obj, s) for s in slot_names if hasattr(obj, s)
            }
        if state:
            if id(obj) in seen:
                return r + "<cycle>"
            seen.add(id(obj))
            try:
                r += stable_description(state, depth + 1, seen)
            finally:
                seen.discard(id(obj))
    return r


def _module_description(module: torch.nn.Module, depth: int, seen) -> str:
    """A module as its class, its plain attributes (those ``repr`` leaves
    out, such as a ViT block's attention function or the model's dtype),
    its own parameters' and buffers' names, shapes and dtypes, and its
    children, in registration order. So two ViTs that differ only in
    ``attn_impl`` or ``dtype`` namespace apart, as two Flax modules do.
    The values of the weights do not enter: the estimators digest their
    starting weights separately."""
    cls = type(module)
    plain = {k: v for k, v in vars(module).items()
             if not k.startswith("_") and k != "training"}
    tensors = [f"{n}:{tuple(t.shape)}:{t.dtype}" for n, t in
               [*module._parameters.items(), *module._buffers.items()] if t is not None]
    children = ",".join(
        f"{name}={stable_description(child, depth + 1, seen)}"
        for name, child in module._modules.items() if child is not None)
    return (f"{cls.__module__}.{cls.__qualname__}("
            f"{stable_description(plain, depth + 1, seen)};{','.join(tensors)};{children})")


def epoch_path(ckpt_dir: str, namespace: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), namespace, f"epoch_{epoch}")


def _snapshot(tree, pinned: Dict[int, torch.Tensor], key=None):
    """A host copy of ``tree`` (dicts, lists, tuples, tensors, plain values).
    A CPU tensor is cloned; a card tensor is copied on the current stream
    into a pinned buffer (``pinned``, keyed by its position in the tree,
    reused by the next save of the same layout). Returns the copy and
    whether a card copy was queued."""
    queued = False
    if key is None:
        key = [0]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.to("cpu", copy=True), False
        slot = key[0]
        key[0] += 1
        buf = pinned.get(slot)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned[slot] = buf
        buf.copy_(t, non_blocking=True)
        return buf, True
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out[k], q = _snapshot(v, pinned, key)
            queued |= q
        return out, queued
    if isinstance(tree, (list, tuple)):
        items = []
        for v in tree:
            item, q = _snapshot(v, pinned, key)
            items.append(item)
            queued |= q
        return type(tree)(items), queued
    return tree, False


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class AsyncCheckpointer:
    """Saves payloads behind the caller's next steps, one at a time, on one
    background thread, with the semantics of the JAX package's
    ``make_async_checkpointer``: ``save`` returns after the host snapshot,
    ``wait_until_finished()`` blocks until the last save is committed and
    raises its error, and ``close()`` waits and refuses later saves.

    A save first waits for the one before it, so at most one write is in
    flight and the pinned buffers of a card snapshot are reused safely.
    Each commit's time and bytes go to :func:`record_commit`."""

    _names = count()

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[int, torch.Tensor] = {}
        self._closed = False

    def save(self, path: str, payload: Any) -> None:
        if self._closed:
            raise RuntimeError("save on a closed checkpointer")
        self.wait_until_finished()
        snapshot, queued = _snapshot(payload, self._pinned)
        event = None
        if queued:
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(
            target=self._commit, args=(path, snapshot, event),
            name="sparkdl-checkpoint", daemon=True)
        self._thread.start()

    def _commit(self, path: str, snapshot, event) -> None:
        start = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            parent = os.path.dirname(path)
            os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}-{next(self._names)}"
            os.makedirs(tmp)
            payload_file = os.path.join(tmp, PAYLOAD)
            with open(payload_file, "wb") as fh:
                torch.save(snapshot, fh)
                fh.flush()
                os.fsync(fh.fileno())
            nbytes = os.path.getsize(payload_file)
            with open(os.path.join(tmp, MARKER), "w") as fh:
                json.dump({"bytes": nbytes}, fh)
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(tmp)
            if os.path.lexists(path):
                # a torn or stray epoch_N from an earlier run: set it aside
                # first, so the rename below never lands inside it
                stale = f"{path}.stale-{os.getpid()}-{next(self._names)}"
                os.rename(path, stale)
                shutil.rmtree(stale, ignore_errors=True)
            os.rename(tmp, path)
            _fsync_dir(parent)
            record_commit(time.perf_counter() - start, nbytes)
        except BaseException as exc:  # raised again at the caller's next wait
            self._error = exc

    def wait_until_finished(self) -> None:
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"a checkpoint commit failed: {error!r}") from error

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            self._closed = True
            self._pinned.clear()


def save_epoch(ckptr: AsyncCheckpointer, ckpt_dir: str, namespace: str, epoch: int,
               payload) -> None:
    """Asynchronously save ``payload`` as this namespace's ``epoch_N``."""
    ckptr.save(epoch_path(ckpt_dir, namespace, epoch), payload)


def is_committed(root: str, epoch: int) -> bool:
    """True when ``epoch_N`` holds the commit marker: a torn save, a stray
    directory or one in another package's layout has none."""
    path = os.path.join(root, f"epoch_{epoch}")
    return (os.path.isfile(os.path.join(path, MARKER))
            and os.path.isfile(os.path.join(path, PAYLOAD)))


def committed_epochs(
    ckpt_dir: str, namespace: str, max_epoch: Optional[int] = None
) -> List[int]:
    """Sorted committed epoch numbers in this namespace, optionally capped
    at ``max_epoch`` (never resume past the requested stopping point: a
    shorter re-fit must reproduce the short run, not return later weights).
    Empty when the namespace does not exist."""
    root = os.path.join(os.path.abspath(ckpt_dir), namespace)
    if not os.path.isdir(root):
        return []
    epochs = sorted(
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("epoch_") and d.split("_")[1].isdigit()
    )
    if max_epoch is not None:
        epochs = [e for e in epochs if e <= max_epoch]
    return [e for e in epochs if is_committed(root, e)]


def restore_epoch(ckpt_dir: str, namespace: str, epoch: int):
    """Read a committed ``epoch_N``'s payload onto the CPU. A committed
    epoch that does not load raises, naming its directory: a fit never
    quietly starts again from epoch 0."""
    path = epoch_path(ckpt_dir, namespace, epoch)
    try:
        return torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                          weights_only=True)
    except Exception as exc:
        raise RuntimeError(f"the committed checkpoint {path} does not load: {exc}") from exc


def restore_latest(ckpt_dir: str, namespace: str, max_epoch: int,
                   load: Callable[[Any], None]) -> int:
    """Load the latest committed epoch up to ``max_epoch`` through
    ``load(payload)``, which copies it into the live state; returns that
    epoch, or 0 when there is none. Timed into ``estimator.restore``. A
    payload that does not fit the state raises, naming its directory.

    Inside a process group every rank must resume from the same epoch, or
    the ranks would run different numbers of collective steps: a
    ``checkpointDir`` that is not storage every rank sees raises here."""
    with metrics.timer("estimator.restore").time():
        epochs = committed_epochs(ckpt_dir, namespace, max_epoch=max_epoch)
        latest = epochs[-1] if epochs else 0
        _same_epoch_everywhere(latest)
        if not epochs:
            return 0
        payload = restore_epoch(ckpt_dir, namespace, latest)
        try:
            load(payload)
        except (KeyError, RuntimeError, ValueError) as exc:
            raise RuntimeError(
                f"the committed checkpoint {epoch_path(ckpt_dir, namespace, latest)} "
                f"does not fit this fit's state: {exc}") from exc
    logger.info("resuming from checkpoint epoch %d", latest)
    if latest >= max_epoch:
        logger.info(
            "checkpoint already at epoch %d == requested epochs=%d; "
            "returning the checkpointed weights without training",
            latest, max_epoch,
        )
    return latest


def _same_epoch_everywhere(latest: int) -> None:
    from sparkdl_tpu_torch.parallel import runner

    if not runner.is_distributed():
        return
    import torch.distributed as dist

    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, int(latest))
    if len(set(seen)) != 1:
        raise RuntimeError(
            f"hosts disagree on the latest checkpoint epoch ({sorted(set(seen))}); "
            "checkpointDir must be shared storage visible to every process")


def _close_behind(ckptr: AsyncCheckpointer, exc: BaseException) -> None:
    """Commit the last save while ``exc`` propagates. A commit that fails
    then is logged and noted on ``exc``, which stays the error the caller
    sees: a ``Preempted`` a scheduler wrapper requeues stays a
    ``Preempted``."""
    try:
        ckptr.close()
    except Exception as err:
        logger.error("the last checkpoint commit failed while %r propagated: %s", exc, err)
        exc.add_note(f"the last checkpoint commit failed as well: {err!r}")


def fit_epochs(
    state,
    step_fn: Callable,
    batches: Callable[[np.ndarray], Iterator[Dict[str, np.ndarray]]],
    n: int,
    rng: np.random.RandomState,
    start_epoch: int,
    epochs: int,
    device: torch.device,
    ckpt_dir: Optional[str] = None,
    namespace: Optional[str] = None,
    payload: Optional[Callable[[Any], Dict[str, Any]]] = None,
    estimator: str = "estimator",
    steps_per_epoch: Optional[int] = None,
    writer: bool = True,
) -> Tuple[Any, List[float]]:
    """The estimators' epoch loop, from ``start_epoch`` to ``epochs``.

    Each epoch draws ``rng.permutation(n)`` (the restored epochs' draws are
    replayed first, so epoch e always trains on the e-th permutation and a
    resumed fit equals an uninterrupted one) and runs one
    ``state, loss = step_fn(state, batch)`` per batch of
    ``batches(order)``, a generator that is closed when the epoch ends or
    raises (which stops a streaming producer). With ``ckpt_dir``, each epoch
    ends with an async save of ``payload(state)`` as ``epoch_N`` of
    ``namespace``. The loop runs inside :func:`preemption_scope`: SIGTERM
    flags the token, the next step boundary raises ``Preempted``, and the
    last completed epoch is committed before it propagates. Fires the fault
    sites ``estimator.step``, ``estimator.epoch`` and
    ``estimator.checkpoint_saved``, inside a
    :class:`~sparkdl_tpu_torch.obs.hooks.FitProfiler` named ``estimator``
    (the fit, step and checkpoint spans, each epoch's event). Inside a
    process group every rank builds each epoch's payload (gathering a
    sharded state is a collective) and only the ``writer`` (rank 0) saves
    it. Returns the state and every step's loss."""
    for _ in range(start_epoch):
        rng.permutation(n)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None
    step_losses: List[float] = []
    ckptr = AsyncCheckpointer() if ckpt_dir and writer else None
    try:
        with preemption_scope() as ptoken, fit_profiler(
                estimator, epochs=epochs, steps_per_epoch=steps_per_epoch) as prof:
            for epoch in range(start_epoch, epochs):
                losses = []
                with closing(batches(rng.permutation(n))) as epoch_batches:
                    for batch in epoch_batches:
                        ptoken.check()
                        inject.fire("estimator.step")
                        with prof.step(sync):
                            state, loss = step_fn(state, {
                                k: torch.from_numpy(v).to(device) for k, v in batch.items()})
                        losses.append(loss)
                inject.fire("estimator.epoch")
                # one read of the losses per epoch, as the JAX loop's
                # float(loss)
                step_losses += torch.stack(losses).tolist()
                prof.epoch(epoch + 1, step_losses[-1])
                logger.info("epoch %d/%d loss=%.4f", epoch + 1, epochs, step_losses[-1])
                if ckpt_dir:
                    with prof.checkpoint(epoch=epoch + 1):
                        snapshot = payload(state)
                        if ckptr is not None:
                            save_epoch(ckptr, ckpt_dir, namespace, epoch + 1, snapshot)
                    inject.fire("estimator.checkpoint_saved")
    except BaseException as exc:
        if ckptr is not None:
            _close_behind(ckptr, exc)
        raise
    if ckptr is not None:
        # the last epoch's write commits before fit returns
        ckptr.close()
    return state, step_losses
