"""The port's sampling profiler (``obs/profile.py``), on the cases of the
JAX package's ``tests/test_profile.py``: folded-stack aggregation,
self-exclusion, bounded memory, the window helper, and env arming.

Tests drive :meth:`StackProfiler.sample_once` directly wherever
possible — no background thread, no timing assumptions; the few
thread-lifecycle tests use generous waits on real sleeps.
"""

import threading
import time

import pytest

from sparkdl_tpu_torch.obs import profile
from sparkdl_tpu_torch.obs.profile import StackProfiler, profile_for
from sparkdl_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def clean_registry():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture(autouse=True)
def unarm_profiler():
    """Tests must not leak an armed process-wide profiler."""
    yield
    if profile._profiler is not None:
        profile._profiler.stop()
        profile._profiler = None


class TestFold:
    def test_fold_is_root_first_basenames(self):
        import sys
        frame = sys._getframe()
        folded = profile._fold(frame)
        parts = folded.split(";")
        # leaf-most frame is THIS function, rendered file:function
        assert parts[-1].startswith("test_torch_profile.py:")
        assert parts[-1].endswith("test_fold_is_root_first_basenames")

    def test_fold_depth_bounded(self):
        def recurse(n):
            if n == 0:
                import sys
                return profile._fold(sys._getframe(), depth=5)
            return recurse(n - 1)

        assert len(recurse(50).split(";")) == 5


class TestSampleOnce:
    def test_sample_once_counts_live_threads(self):
        p = StackProfiler()
        n = p.sample_once()
        assert n >= 1  # at least the calling thread
        snap = p.snapshot()
        assert snap["samples"] == n
        assert snap["unique_stacks"] >= 1

    def test_excluded_idents_skipped(self):
        marker = "test_torch_profile.py:test_excluded_idents_skipped"
        p = StackProfiler(exclude_idents=(threading.get_ident(),))
        p.sample_once()
        assert all(marker not in s for s in p.folded())
        q = StackProfiler()
        q.sample_once()
        assert any(marker in s for s in q.folded())

    def test_unique_stacks_bounded(self):
        p = StackProfiler(max_stacks=1)
        p._stacks["existing"] = 1
        p._samples = 1
        p.sample_once()  # every new stack must drop, not grow
        snap = p.snapshot()
        assert snap["unique_stacks"] == 1
        assert snap["dropped_stacks"] >= 1

    def test_folded_text_ranked_and_capped(self):
        p = StackProfiler()
        p._stacks.update({"hot": 10, "warm": 5, "cold": 1})
        p._samples = 16
        lines = p.folded_text(top=2).splitlines()
        assert lines == ["hot 10", "warm 5"]

    def test_snapshot_shares_sum_to_one(self):
        p = StackProfiler()
        p._stacks.update({"a": 3, "b": 1})
        p._samples = 4
        top = p.snapshot()["top"]
        assert sum(row["share"] for row in top) == pytest.approx(1.0)


class TestLifecycle:
    def test_start_stop_idempotent_and_self_excluding(self):
        p = StackProfiler(interval_s=0.002)
        p.start()
        p.start()  # no second thread
        assert p.running
        deadline = time.monotonic() + 5.0
        while p.snapshot()["samples"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        p.stop()
        p.stop()
        assert not p.running
        snap = p.snapshot()
        assert snap["samples"] > 0
        # the sampler never samples itself: its own _run stack would
        # end in sample_once/_run from profile.py
        assert all(
            "profile.py:_run" not in row["stack"]
            for row in snap["top"]
        )
        # the aggregate survives stop for reading
        assert p.folded()

    def test_reset_clears_aggregate(self):
        p = StackProfiler()
        p.sample_once()
        p.reset()
        snap = p.snapshot()
        assert snap["samples"] == 0
        assert snap["unique_stacks"] == 0

    def test_metrics_move(self):
        p = StackProfiler()
        p.sample_once()
        assert metrics.snapshot()["profile.samples"] >= 1

    def test_invalid_args_raise(self):
        with pytest.raises(ValueError):
            StackProfiler(interval_s=0.0)
        with pytest.raises(ValueError):
            StackProfiler(max_stacks=0)


class TestProfileFor:
    def test_window_excludes_the_waiter(self):
        snap = profile_for(0.05, interval_s=0.005)
        assert not snap["running"]
        assert snap["duration_s"] >= 0.04
        # the calling thread only sleeps out the window; it must not
        # dominate the profile (it is excluded entirely)
        assert all(
            "test_torch_profile.py:test_window_excludes_the_waiter"
            not in row["stack"]
            for row in snap["top"]
        )

    def test_rejects_nonpositive_window(self):
        with pytest.raises(ValueError):
            profile_for(0.0)


class TestEnvArming:
    def test_unset_env_leaves_unarmed(self, monkeypatch):
        monkeypatch.delenv(profile.ENV_PROFILE, raising=False)
        assert profile.enable_from_env() is None
        assert profile.profiler() is None

    @pytest.mark.parametrize("off", ["0", "off", "false"])
    def test_off_values_leave_unarmed(self, monkeypatch, off):
        monkeypatch.setenv(profile.ENV_PROFILE, off)
        assert profile.enable_from_env() is None

    def test_on_arms_default_period(self, monkeypatch):
        monkeypatch.setenv(profile.ENV_PROFILE, "1")
        p = profile.enable_from_env()
        assert p is not None and p.running
        assert p.interval_s == profile.DEFAULT_INTERVAL_S
        # idempotent: a second call returns the same armed instance
        assert profile.enable_from_env() is p

    def test_numeric_value_is_period_in_ms(self, monkeypatch):
        monkeypatch.setenv(profile.ENV_PROFILE, "50")
        p = profile.enable_from_env()
        assert p.interval_s == pytest.approx(0.050)

    def test_period_floor_one_ms(self, monkeypatch):
        monkeypatch.setenv(profile.ENV_PROFILE, "0.01")
        p = profile.enable_from_env()
        assert p.interval_s == pytest.approx(0.001)
