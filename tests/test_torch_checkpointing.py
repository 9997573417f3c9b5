"""The port's checkpoint plumbing and preemption seam against the JAX
package's, on the CPU.

``stable_description`` is held to the JAX package's function on the same
values, string for string. The commit protocol (snapshot, background write,
marker, rename), the epoch listing and the preemption scope and fault plans
are held to the JAX package's contract: what its tests
(``tests/test_estimators.py``, ``tests/test_flax_estimator.py``,
``tests/test_fault_injection.py``) require of orbax and of
``sparkdl_tpu.resilience``.
"""

import collections
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sparkdl_tpu.estimators.checkpointing import stable_description as jax_stable
from sparkdl_tpu_torch.estimators import checkpointing
from sparkdl_tpu_torch.estimators.checkpointing import stable_description
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.resilience import (
    FaultPlan,
    Preempted,
    active_plan,
    fire,
    preemption_scope,
    request_preemption,
)
from sparkdl_tpu_torch.utils.metrics import metrics

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- stable_description against the JAX package's -------------------------------

Point = collections.namedtuple("Point", "x y")


class FocalLoss:
    def __init__(self, gamma):
        self.gamma = gamma

    def __call__(self, logits, labels):
        return (logits - labels).mean() * self.gamma


class Slotted:
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b


class Node:
    def __init__(self):
        self.next = self


def _with_defaults(l, y, reduction="mean", *, weight=2.0):
    if reduction in {"mean", "sum", "none"}:
        return l * weight
    return y


def _closure(scale):
    def loss(l, y):
        return (l - y) * scale

    return loss


def _cycle():
    a = [1]
    a.append(a)
    return a


VALUES = {
    "string": "adam",
    "number": 1e-3,
    "none": None,
    "nested": {"b": [1, 2.5, (3, "x")], "a": {"k": None}},
    "set": {"sum", "mean", "none"},
    "frozenset": frozenset({3, 1, 2}),
    "namedtuple": Point(1, [2, 3]),
    "lambda_with_defaults": lambda l, y, k=3: l * k,
    "function_with_kwdefaults": _with_defaults,
    "closure": _closure(0.5),
    "bound_method": FocalLoss(2.0).__call__,
    "instance_dict": FocalLoss(5.0),
    "instance_slots": Slotted(1, "two"),
    "self_cycle": Node(),
    "list_cycle": _cycle(),
    "builtin": len,
    "numpy_function": np.mean,
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_stable_description_matches_the_jax_package(name):
    value = VALUES[name]
    assert stable_description(value) == jax_stable(value)


def test_stable_description_keeps_state_and_bodies_apart():
    """The JAX namespace test's cases through the port's function."""
    assert stable_description(FocalLoss(2.0)) != stable_description(FocalLoss(5.0))
    assert stable_description(FocalLoss(2.0)) == stable_description(FocalLoss(2.0))
    l1 = lambda l, y: np.mean(l - y)  # noqa: E731
    l2 = lambda l, y: np.sum(l - y)  # noqa: E731
    assert stable_description(l1) != stable_description(l2)
    assert stable_description(_closure(0.5)) != stable_description(_closure(0.25))


def test_a_module_is_described_by_its_class_attributes_and_shapes():
    """``repr`` of a ViT leaves out ``attn_impl`` and ``dtype``; the
    description keeps them, and the shapes, but not the weights' values."""
    geometry = dict(variant="ViT-Ti/16", num_classes=2, image_size=16)
    flash, full = ViT(**geometry, attn_impl="flash"), ViT(**geometry, attn_impl="full")
    assert repr(flash) == repr(full)
    assert stable_description(flash) != stable_description(full)
    assert stable_description(ViT(**geometry, dtype=torch.bfloat16)) != \
        stable_description(ViT(**geometry))
    assert stable_description(ViT(**{**geometry, "num_classes": 3})) != \
        stable_description(ViT(**geometry))
    other = ViT(**geometry, attn_impl="flash")
    with torch.no_grad():
        other.head.weight.add_(1.0)
    assert stable_description(other) == stable_description(flash)
    assert "0x" not in stable_description(flash)


def test_module_description_survives_hash_randomisation():
    """A module holding a set and a callable describes alike in fresh
    interpreters under other ``PYTHONHASHSEED``s."""
    prog = (
        "import torch\n"
        "from sparkdl_tpu_torch.estimators.checkpointing import stable_description\n"
        "from sparkdl_tpu_torch.models.vit import ViT\n"
        "m = ViT('ViT-Ti/16', num_classes=2, image_size=16, attn_impl='flash')\n"
        "m.tags = {'alpha', 'beta', 'gamma', 'delta'}\n"
        "print(stable_description(m))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    outs = {
        subprocess.run([sys.executable, "-c", prog], env={**env, "PYTHONHASHSEED": seed},
                       capture_output=True, text=True, check=True, timeout=120).stdout
        for seed in ("1", "2")
    }
    assert len(outs) == 1


# -- the commit protocol ----------------------------------------------------------

def _save(ckptr, root, epoch, payload):
    checkpointing.save_epoch(ckptr, str(root), "ns", epoch, payload)


def test_save_commits_with_a_marker_and_restores(tmp_path):
    payload = {"w": torch.arange(6.0).reshape(2, 3), "step": 3,
               "opt": {"state": {0: {"step": torch.tensor(2.0)}}, "param_groups": [{"lr": 0.1}]}}
    ckptr = checkpointing.AsyncCheckpointer()
    _save(ckptr, tmp_path, 1, payload)
    ckptr.wait_until_finished()
    ckptr.close()
    epoch = Path(checkpointing.epoch_path(str(tmp_path), "ns", 1))
    assert sorted(p.name for p in epoch.iterdir()) == [checkpointing.MARKER, checkpointing.PAYLOAD]
    assert sorted(os.listdir(tmp_path / "ns")) == ["epoch_1"]  # no temporary left
    assert checkpointing.committed_epochs(str(tmp_path), "ns") == [1]
    back = checkpointing.restore_epoch(str(tmp_path), "ns", 1)
    assert torch.equal(back["w"], payload["w"]) and back["step"] == 3
    assert back["opt"]["param_groups"] == [{"lr": 0.1}]


def test_torn_and_foreign_directories_are_never_resumed(tmp_path):
    """An ``epoch_3`` without the marker (a save killed before it), a
    temporary left by a killed writer, and a directory in orbax's layout
    (as the JAX package writes one) are all skipped."""
    ckptr = checkpointing.AsyncCheckpointer()
    for epoch in (1, 2):
        _save(ckptr, tmp_path, epoch, {"w": torch.full((2,), float(epoch))})
    ckptr.close()
    root = tmp_path / "ns"
    torn = root / "epoch_3"
    torn.mkdir()
    (torn / checkpointing.PAYLOAD).write_bytes(b"half a pickle")
    (root / "epoch_4.tmp-123-0").mkdir()
    orbax = root / "epoch_5"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    (orbax / "_METADATA").write_text("{}")
    (orbax / "d").mkdir()
    assert checkpointing.committed_epochs(str(tmp_path), "ns") == [1, 2]
    assert checkpointing.committed_epochs(str(tmp_path), "ns", max_epoch=1) == [1]
    assert checkpointing.committed_epochs(str(tmp_path), "other") == []


def test_a_save_replaces_a_torn_epoch_of_the_same_number(tmp_path):
    torn = tmp_path / "ns" / "epoch_1"
    torn.mkdir(parents=True)
    (torn / "junk").write_text("x")
    ckptr = checkpointing.AsyncCheckpointer()
    _save(ckptr, tmp_path, 1, {"w": torch.ones(2)})
    ckptr.close()
    assert sorted(os.listdir(torn)) == [checkpointing.MARKER, checkpointing.PAYLOAD]
    assert sorted(os.listdir(tmp_path / "ns")) == ["epoch_1"]


def test_a_committed_epoch_that_does_not_load_raises_naming_it(tmp_path):
    ckptr = checkpointing.AsyncCheckpointer()
    _save(ckptr, tmp_path, 1, {"w": torch.ones(2)})
    ckptr.close()
    path = checkpointing.epoch_path(str(tmp_path), "ns", 1)
    Path(path, checkpointing.PAYLOAD).write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match=f"{path} does not load"):
        checkpointing.restore_epoch(str(tmp_path), "ns", 1)


def test_the_snapshot_is_a_copy_taken_before_save_returns(tmp_path, monkeypatch):
    """The async-read trap: ``t.cpu()`` of a CPU tensor is the tensor
    itself. The writer thread is held back while the caller updates the
    payload's tensors in place, as the next optimizer step does; the commit
    still holds the values at the save."""
    release = threading.Event()
    real_save = torch.save

    def slow_save(obj, fh):
        release.wait(10)
        real_save(obj, fh)

    monkeypatch.setattr(checkpointing.torch, "save", slow_save)
    w = torch.zeros(1000)
    state = {"m": torch.ones(3)}
    ckptr = checkpointing.AsyncCheckpointer()
    _save(ckptr, tmp_path, 1, {"w": w, "opt": state})
    w.add_(1.0)
    state["m"].mul_(5.0)
    release.set()
    ckptr.close()
    back = checkpointing.restore_epoch(str(tmp_path), "ns", 1)
    assert torch.equal(back["w"], torch.zeros(1000))
    assert torch.equal(back["opt"]["m"], torch.ones(3))


def test_saves_run_one_at_a_time_and_record_their_commit(tmp_path):
    metrics.reset()
    ckptr = checkpointing.AsyncCheckpointer()
    for epoch in (1, 2, 3):
        _save(ckptr, tmp_path, epoch, {"w": torch.full((256,), float(epoch))})
        # the save before this one has committed
        assert checkpointing.committed_epochs(str(tmp_path), "ns") == list(range(1, epoch))
    ckptr.close()
    assert checkpointing.committed_epochs(str(tmp_path), "ns") == [1, 2, 3]
    assert len(metrics.histogram("estimator.checkpoint_commit_ms").values()) == 3
    assert metrics.counter("estimator.checkpoint_bytes").value == sum(
        (tmp_path / "ns" / f"epoch_{e}" / checkpointing.PAYLOAD).stat().st_size
        for e in (1, 2, 3))
    for epoch in (1, 2, 3):
        back = checkpointing.restore_epoch(str(tmp_path), "ns", epoch)
        assert torch.equal(back["w"], torch.full((256,), float(epoch)))
    with pytest.raises(RuntimeError, match="closed"):
        _save(ckptr, tmp_path, 4, {})


def test_a_failed_commit_raises_at_the_next_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the namespace's directory would go")
    ckptr = checkpointing.AsyncCheckpointer()
    checkpointing.save_epoch(ckptr, str(blocker), "ns", 1, {"w": torch.ones(1)})
    with pytest.raises(RuntimeError, match="checkpoint commit failed"):
        ckptr.wait_until_finished()
    ckptr.close()


# -- preemption and fault plans -------------------------------------------------------

def test_preemption_is_delivered_at_the_next_check():
    with preemption_scope() as token:
        token.check()
        request_preemption("drain")
        assert token.requested
        with pytest.raises(Preempted, match="drain"):
            token.check()
    assert not issubclass(Preempted, Exception)


def test_request_without_a_scope_raises_at_once():
    with pytest.raises(Preempted, match="no scope"):
        request_preemption("no scope")


def test_nested_scopes_flag_the_innermost():
    with preemption_scope() as outer:
        with preemption_scope() as inner:
            request_preemption()
        assert inner.requested and not outer.requested


def test_sigterm_flags_the_token_and_chains_the_previous_handler():
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        with preemption_scope() as token:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                if token.requested:
                    break
                time.sleep(0.01)
            assert token.requested and token.reason == "SIGTERM"
            assert seen == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is not None
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_a_scope_off_the_main_thread_polls_without_a_handler():
    before = signal.getsignal(signal.SIGTERM)
    result = {}

    def worker():
        with preemption_scope() as token:
            result["handler"] = signal.getsignal(signal.SIGTERM)
            request_preemption("worker")
            try:
                token.check()
            except Preempted as exc:
                result["raised"] = str(exc)

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join()
    assert result == {"handler": before, "raised": "worker"}


def test_fault_plan_fires_at_the_nth_call_and_resets():
    plan = FaultPlan().add("estimator.step", error=ValueError, at=2)
    for _ in range(2):
        # each activation starts the plan's counts again
        with active_plan(plan):
            fire("estimator.step")
            fire("estimator.epoch")
            with pytest.raises(ValueError, match="injected fault at 'estimator.step'"):
                fire("estimator.step")
            fire("estimator.step")
        fire("estimator.step")  # no plan: nothing


def test_fault_plan_preempts_through_the_scope():
    plan = FaultPlan().add("estimator.epoch", preempt=True, at=1)
    with active_plan(plan), preemption_scope() as token:
        fire("estimator.epoch")
        with pytest.raises(Preempted, match="injected preemption at 'estimator.epoch'"):
            token.check()


@pytest.mark.parametrize("kwargs,match", [
    ({"site": "data.map", "preempt": True, "at": 1}, "unknown fault site"),
    ({"site": "estimator.step", "at": 1}, "exactly one action"),
    ({"site": "estimator.step", "preempt": True, "error": ValueError, "at": 1},
     "exactly one action"),
])
def test_fault_plan_refuses_rules_it_cannot_fire(kwargs, match):
    with pytest.raises(ValueError, match=match):
        FaultPlan().add(**kwargs)
