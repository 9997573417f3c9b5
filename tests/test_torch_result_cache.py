"""The port's content-addressed result cache, on the cases of the JAX
package's ``tests/test_result_cache.py``.

Covers the three cache primitives in ``serving/result_cache.py``
(canonical digester, bounded-byte router LRU, replica-tier
single-flight + negative cache), the router wiring (hit path, the
unfingerprinted-is-uncacheable rule, fail-open under an injected
``cache.lookup`` fault), and the ``/debug/cache`` ObsServer pane
(including the 400-not-500 malformed-param contract). The rollout-flip
invalidation proof comes with the rollout controller (ROADMAP item 10c).
Its keys are held to the JAX package's in ``test_torch_replica_parity.py``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving.result_cache import (
    NegativeCache,
    ResultCache,
    SingleFlight,
    canonical_digest,
    result_key,
)


# ----------------------------------------------------------------------
# canonical digester
# ----------------------------------------------------------------------
class TestCanonicalDigest:
    def test_strided_equal_arrays_digest_identically(self):
        # THE digester contract: layout is normalized away — a
        # C-contiguous array and its Fortran-ordered twin carry the
        # same bytes-in-math and must produce the same key
        a = np.arange(24, dtype=np.float32).reshape(4, 6)
        b = np.asfortranarray(a)
        assert not b.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
        assert canonical_digest(a) == canonical_digest(b)

    def test_sliced_view_digests_like_its_copy(self):
        base = np.arange(32, dtype=np.float32)
        view = base[::2]          # non-contiguous view
        copy = view.copy()        # contiguous, same values
        assert canonical_digest(view) == canonical_digest(copy)

    def test_dtype_is_part_of_the_key(self):
        a = np.ones(8, dtype=np.float32)
        b = np.ones(8, dtype=np.float64)
        assert canonical_digest(a) != canonical_digest(b)

    def test_shape_is_part_of_the_key(self):
        a = np.zeros(6, dtype=np.float32)
        b = np.zeros((2, 3), dtype=np.float32)
        assert canonical_digest(a) != canonical_digest(b)

    def test_scalar_meta_changes_the_digest(self):
        x = np.ones(4, dtype=np.float32)
        assert canonical_digest(x) != canonical_digest(
            x, meta={"tenant": "a"}
        )
        assert canonical_digest(x, meta={"k": 1}) == canonical_digest(
            x, meta={"k": 1}
        )

    def test_non_array_values_digest_stably(self):
        assert canonical_digest({"a": 1}) == canonical_digest({"a": 1})
        assert canonical_digest({"a": 1}) != canonical_digest({"a": 2})

    def test_result_key_separates_fingerprints(self):
        d = canonical_digest(np.ones(4, dtype=np.float32))
        assert result_key("model:v1", d) != result_key("model:v2", d)
        assert result_key("model:v1", d) == result_key("model:v1", d)


# ----------------------------------------------------------------------
# router-tier LRU
# ----------------------------------------------------------------------
class TestResultCache:
    def test_put_get_roundtrip_and_hit_miss_counts(self):
        rc = ResultCache(max_bytes=1 << 20)
        out = np.arange(8, dtype=np.float32)
        assert rc.get("k1") is None
        assert rc.put("k1", out)
        hit = rc.get("k1")
        np.testing.assert_array_equal(hit, out)
        snap = rc.snapshot()
        assert snap["hit"] == 1 and snap["miss"] == 1

    def test_cached_result_is_immutable_copy(self):
        rc = ResultCache(max_bytes=1 << 20)
        out = np.arange(4, dtype=np.float32)
        rc.put("k", out)
        out[0] = 99.0  # caller mutating its array must not poison
        hit = rc.get("k")
        assert hit[0] == 0.0
        with pytest.raises((ValueError, RuntimeError)):
            hit[0] = 7.0  # and hit recipients get a frozen view

    def test_byte_budget_evicts_lru(self):
        one = np.zeros(16, dtype=np.float32)  # 64 bytes each
        rc = ResultCache(max_bytes=3 * one.nbytes)
        for i in range(3):
            rc.put(f"k{i}", one)
        rc.get("k0")          # refresh k0 — k1 becomes LRU
        rc.put("k3", one)     # over budget: k1 must go
        assert rc.get("k1") is None
        assert rc.get("k0") is not None
        assert rc.get("k3") is not None
        assert rc.snapshot()["evicted"] == 1
        assert rc.bytes <= rc.snapshot()["max_bytes"]

    def test_oversized_result_is_refused_not_cached(self):
        rc = ResultCache(max_bytes=64)
        big = np.zeros(1024, dtype=np.float32)
        assert not rc.put("big", big)
        assert len(rc) == 0

    def test_put_is_idempotent(self):
        rc = ResultCache(max_bytes=1 << 20)
        out = np.ones(8, dtype=np.float32)
        rc.put("k", out)
        before = rc.bytes
        rc.put("k", out)  # hedge race: second populate is a no-op
        assert rc.bytes == before
        assert len(rc) == 1

    def test_snapshot_top_keys_ranked_by_hits(self):
        rc = ResultCache(max_bytes=1 << 20)
        for name, hits in (("hot", 5), ("warm", 2), ("cold", 0)):
            rc.put(name, np.ones(4, dtype=np.float32))
            for _ in range(hits):
                rc.get(name)
        top = rc.snapshot(top=2)["top_keys"]
        assert len(top) == 2
        assert top[0]["hits"] == 5 and top[1]["hits"] == 2

    def test_clear_empties_and_zeroes_bytes(self):
        rc = ResultCache(max_bytes=1 << 20)
        rc.put("k", np.ones(4, dtype=np.float32))
        rc.clear()
        assert len(rc) == 0 and rc.bytes == 0
        assert rc.get("k") is None


# ----------------------------------------------------------------------
# replica-tier single-flight + negative cache
# ----------------------------------------------------------------------
class TestSingleFlight:
    def test_first_claim_leads_rest_collapse(self):
        sf = SingleFlight()
        flight, leader = sf.claim("k")
        assert leader
        f2, l2 = sf.claim("k")
        assert not l2 and f2 is flight
        assert sf.stats()["collapsed"] == 1

    def test_resolve_wakes_followers_with_reply(self):
        sf = SingleFlight()
        flight, _ = sf.claim("k")
        follower, leader = sf.claim("k")
        assert not leader
        got = []

        def wait():
            follower.event.wait(5.0)
            got.append(follower.reply)

        t = threading.Thread(target=wait)
        t.start()
        sf.resolve(flight, reply={"ok": True, "result": 42})
        t.join(timeout=5.0)
        assert got and got[0]["result"] == 42

    def test_resolve_pops_before_set(self):
        # the compile-cache idiom: once resolved, the key is free — a
        # NEW claim must lead a fresh flight, never join the stale one
        sf = SingleFlight()
        flight, _ = sf.claim("k")
        sf.resolve(flight, reply={"ok": True})
        f2, leader = sf.claim("k")
        assert leader and f2 is not flight

    def test_exception_propagates_to_followers(self):
        sf = SingleFlight()
        flight, _ = sf.claim("k")
        follower, _ = sf.claim("k")
        boom = ValueError("scoring failed")
        sf.resolve(flight, exc=boom)
        assert follower.event.wait(1.0)
        assert follower.exc is boom


class TestNegativeCache:
    def test_stores_and_replays_error_reply(self):
        nc = NegativeCache(capacity=4)
        err = {"ok": False, "error": "poison", "error_class": "ValueError"}
        assert nc.get("k") is None
        nc.put("k", err)
        got = nc.get("k")
        assert got == err
        got["mutated"] = True  # replay hands out copies
        assert "mutated" not in nc.get("k")

    def test_capacity_evicts_oldest(self):
        nc = NegativeCache(capacity=2)
        for i in range(3):
            nc.put(f"k{i}", {"ok": False, "error": str(i)})
        assert nc.get("k0") is None
        assert nc.get("k2") is not None
        assert len(nc) == 2


# ----------------------------------------------------------------------
# router wiring: hit path, uncacheable rule, fail-open
# ----------------------------------------------------------------------
def _cached_service(counter=None, scale=2.0, fingerprint="m:v1"):
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
    from sparkdl_tpu_torch.serving.replica import ReplicaService

    server = ModelServer(ServingConfig(
        max_batch=8, max_wait_ms=1.0, queue_capacity=64,
    ), device="cpu")

    def forward(x):
        batch = x
        if counter is not None:
            counter.extend([1] * batch.shape[0])
        return batch * scale

    server.register("ep0", forward, item_shape=(4,), compile=False,
                    fingerprint=fingerprint)
    return ReplicaService(server).start()


@pytest.fixture
def cache_env(monkeypatch):
    monkeypatch.setenv("SPARKDL_RESULT_CACHE", "1")


class TestRouterCacheWiring:
    def test_hit_serves_without_touching_the_replica(self, cache_env):
        from sparkdl_tpu_torch.serving.router import Router

        served = []
        svc = _cached_service(served)
        with Router(seed=5) as router:
            router.add("r1", "127.0.0.1", svc.port,
                       fingerprints={"ep0": "m:v1"})
            x = np.ones(4, np.float32)
            try:
                first = np.asarray(router.route(x, model_id="ep0"))
                second = np.asarray(router.route(x, model_id="ep0"))
                assert len(served) == 1  # the hit never hit the device
                assert second.tobytes() == first.tobytes()
                snap = router.result_cache.snapshot()
                assert snap["hit"] == 1 and snap["miss"] == 1
            finally:
                svc.close()

    def test_unfingerprinted_endpoint_is_uncacheable(self, cache_env):
        from sparkdl_tpu_torch.serving.router import Router

        served = []
        svc = _cached_service(served, fingerprint=None)
        with Router(seed=5) as router:
            router.add("r1", "127.0.0.1", svc.port)  # no fingerprints
            x = np.ones(4, np.float32)
            try:
                router.route(x, model_id="ep0")
                router.route(x, model_id="ep0")
                # the compile cache's rule at request granularity: no fingerprint,
                # no cache entry — both requests scored
                assert len(served) == 2
                snap = router.result_cache.snapshot()
                assert snap["entries"] == 0
                assert snap["uncacheable"] == 2
            finally:
                svc.close()

    def test_cache_lookup_fault_fails_open_to_scoring(self, cache_env):
        # the fail-open contract the ci/fault-suite.sh smoke also
        # proves end-to-end: an error injected at the cache.lookup
        # site degrades every request to the miss path — served
        # correctly, never an error, and nothing cached under a key
        # the faulted lookup couldn't resolve
        from sparkdl_tpu_torch.serving.router import Router

        svc = _cached_service()
        with Router(seed=5) as router:
            router.add("r1", "127.0.0.1", svc.port,
                       fingerprints={"ep0": "m:v1"})
            x = np.ones(4, np.float32)
            plan = inject.FaultPlan().add(
                "cache.lookup", error="transient", p=1.0
            )
            try:
                with inject.active_plan(plan):
                    for _ in range(3):
                        out = router.route(x, model_id="ep0")
                        np.testing.assert_allclose(np.asarray(out), 2.0)
                snap = router.result_cache.snapshot()
                assert snap["hit"] == 0 and snap["entries"] == 0
                # fault lifted: the cache resumes without intervention
                router.route(x, model_id="ep0")
                router.route(x, model_id="ep0")
                assert router.result_cache.snapshot()["hit"] == 1
            finally:
                svc.close()

    def test_cache_site_is_registered(self):
        assert "cache.lookup" in inject.known_sites()

    def test_cache_off_by_default(self):
        from sparkdl_tpu_torch.serving.router import Router

        with Router() as router:
            assert router.result_cache is None


# ----------------------------------------------------------------------
# replica tier through the wire: negative cache stops a stampede
# ----------------------------------------------------------------------
class TestReplicaTierWiring:
    def test_poison_input_scores_once_then_replays(self, cache_env):
        from sparkdl_tpu_torch.serving.errors import RemoteReplicaError
        from sparkdl_tpu_torch.serving.router import Router

        scored = []

        def poison(x):
            scored.append(1)
            raise ValueError("NaN in feature 3")

        from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
        from sparkdl_tpu_torch.serving.replica import ReplicaService

        server = ModelServer(ServingConfig(
            max_batch=1, max_wait_ms=0.5, queue_capacity=64,
        ), device="cpu")
        server.register("ep0", poison, item_shape=(4,), compile=False,
                        fingerprint="m:v1")
        svc = ReplicaService(server).start()
        with Router(seed=5) as router:
            router.add("r1", "127.0.0.1", svc.port,
                       fingerprints={"ep0": "m:v1"})
            x = np.ones(4, np.float32)
            try:
                for _ in range(4):
                    with pytest.raises(RemoteReplicaError):
                        router.route(x, model_id="ep0")
                # the device saw the poison exactly once; the other
                # three replays came from the negative cache
                assert len(scored) == 1
                neg = svc.cache_snapshot()["negative"]
                assert neg["stored"] == 1 and neg["hit"] == 3
            finally:
                svc.close()

    def test_transient_errors_are_never_negative_cached(self, cache_env):
        from sparkdl_tpu_torch.serving.result_cache import NegativeCache

        # the taxonomy guard is in ReplicaService._maybe_negative;
        # unit-check the contract it encodes: only permanent,
        # input-determined failures may replay
        from sparkdl_tpu_torch.resilience.errors import is_transient
        from sparkdl_tpu_torch.serving.errors import (
            DeadlineExceeded,
            ServerOverloaded,
        )

        assert is_transient(ServerOverloaded("queue full"))
        assert not isinstance(ValueError("poison"), DeadlineExceeded)


# ----------------------------------------------------------------------
# /debug/cache pane
# ----------------------------------------------------------------------
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


class TestDebugCacheEndpoint:
    def test_snapshot_served_with_top_param(self):
        from sparkdl_tpu_torch.obs.server import ObsServer

        rc = ResultCache(max_bytes=1 << 20)
        for name, hits in (("hot", 3), ("cold", 0)):
            rc.put(name, np.ones(4, dtype=np.float32))
            for _ in range(hits):
                rc.get(name)
        with ObsServer(port=0, cache=rc) as srv:
            status, payload = _get(f"{srv.url}/debug/cache?top=1")
            assert status == 200
            assert payload["entries"] == 2
            assert len(payload["top_keys"]) == 1
            assert payload["top_keys"][0]["hits"] == 3

    def test_callable_slot_is_duck_typed(self):
        from sparkdl_tpu_torch.obs.server import ObsServer

        def view(top=10):
            return {"tier": "replica", "top": top}

        with ObsServer(port=0, cache=view) as srv:
            status, payload = _get(f"{srv.url}/debug/cache?top=4")
            assert status == 200
            assert payload == {"tier": "replica", "top": 4}

    def test_malformed_top_is_400_not_500(self):
        from sparkdl_tpu_torch.obs.server import ObsServer

        with ObsServer(port=0, cache=ResultCache()) as srv:
            for bad in ("banana", "999"):
                status, payload = _get(
                    f"{srv.url}/debug/cache?top={bad}"
                )
                assert status == 400, (bad, payload)
                assert "top" in payload["error"]

    def test_unwired_cache_is_404(self):
        from sparkdl_tpu_torch.obs.server import ObsServer

        with ObsServer(port=0) as srv:
            status, payload = _get(f"{srv.url}/debug/cache")
            assert status == 404
            assert "cache" in payload["error"]

    def test_index_lists_the_pane(self):
        from sparkdl_tpu_torch.obs.server import ObsServer

        with ObsServer(port=0) as srv:
            status, payload = _get(f"{srv.url}/index")
            assert status == 200
            assert "/debug/cache" in payload["endpoints"]
