"""The port's execution engine (``sparkdl_tpu_torch/engine``) against the JAX
package's (``sparkdl_tpu/engine``).

Cache keys are content addresses, stable across processes and sensitive to
every component, placements included: the JAX key leaves out the placement
of host arguments and of what a function closes over (ROADMAP queue 3), the
port's key does not. The in-memory LRU evicts; a second process loads a
fingerprinted program from disk and compiles nothing; an anonymous function
never reaches the disk; a corrupt entry compiles again.

Two cases run real AOTInductor compiles: the compiled program against eager
and the JAX engine's program on the same numpy inputs, and the two-process
warm start. The logic cases swap the engine's one compile function for
``ExportOnly`` (``tests/torch_fixtures/engine_fixtures.py``), which counts
its calls and stops at ``torch.export``.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.engine import ExecutionEngine as JaxEngine
from sparkdl_tpu.engine import cache_key as jax_cache_key
from sparkdl_tpu_torch.engine import (
    ExecutionEngine,
    PersistentCompileCache,
    cache_key,
    default_cache_dir,
)
from sparkdl_tpu_torch.engine import core
from sparkdl_tpu_torch.resilience.errors import DeviceUnresponsive
from sparkdl_tpu_torch.resilience.watchdog import watchdogged
from sparkdl_tpu_torch.utils.metrics import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures")
sys.path.insert(0, FIXTURES)
from engine_fixtures import ExportOnly, attention_block, port_block  # noqa: E402

_SPEC = (((8, 4), "torch.float32", "cpu"),)
_RUNTIME = {"torch": "0.0.test", "cuda": None, "machine": "x86_64", "cards": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture
def export_only(monkeypatch):
    return ExportOnly.install(monkeypatch)


# ----------------------------------------------------------------------
# cache keys
# ----------------------------------------------------------------------
def test_key_is_deterministic_hex():
    a = cache_key("fp:m1", _SPEC, runtime=_RUNTIME)
    assert a == cache_key("fp:m1", _SPEC, runtime=_RUNTIME)
    assert len(a) == 64 and set(a) <= set("0123456789abcdef")
    # the same contract as the JAX key
    b = jax_cache_key("fp:m1", (((8, 4), "<f4", None),), (), runtime={"jax": "0"})
    assert len(b) == 64 and set(b) <= set("0123456789abcdef")


def test_every_component_changes_the_key():
    base = cache_key("fp:m1", _SPEC, runtime=_RUNTIME)
    variants = [
        cache_key("fp:m2", _SPEC, runtime=_RUNTIME),
        cache_key("fp:m1", (((16, 4), "torch.float32", "cpu"),), runtime=_RUNTIME),
        cache_key("fp:m1", (((8, 4), "torch.bfloat16", "cpu"),), runtime=_RUNTIME),
        cache_key("fp:m1", (((8, 4), "torch.float32", "cuda:0"),), runtime=_RUNTIME),
        cache_key("fp:m1", (((8, 4), "torch.float32", "cuda:1"),), runtime=_RUNTIME),
        cache_key("fp:m1", _SPEC, closure=[("cpu", "torch.float32")], runtime=_RUNTIME),
        cache_key("fp:m1", _SPEC, closure=[("cuda:0", "torch.float32")], runtime=_RUNTIME),
        cache_key("fp:m1", _SPEC, runtime={**_RUNTIME, "torch": "9.9.9"}),
        cache_key("fp:m1", _SPEC, runtime={**_RUNTIME, "cards": {"cuda:0": {"name": "x"}}}),
    ]
    assert len({base, *variants}) == len(variants) + 1


def test_key_is_stable_across_processes():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from sparkdl_tpu_torch.engine.cache import cache_key
        print(cache_key("fp:m1", {_SPEC!r}, [("cpu", "torch.float32")], runtime={_RUNTIME!r}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == cache_key("fp:m1", _SPEC, [("cpu", "torch.float32")],
                                            runtime=_RUNTIME)


def test_default_cache_dir_env(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "/tmp/somewhere")
    assert default_cache_dir() == "/tmp/somewhere"
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    assert default_cache_dir() is None
    monkeypatch.delenv("SPARKDL_COMPILE_CACHE")
    assert default_cache_dir().endswith(os.path.join(".cache", "sparkdl_tpu_torch", "programs"))


def _linear(w):
    def forward(x):
        return torch.tanh(x @ w)

    return forward


@pytest.mark.parametrize("other", ["args_device", "args_dtype", "weights_device",
                                   "weights_dtype"])
def test_key_separates_placements(other):
    """The same fingerprint and shapes with the arguments or the closed-over
    weights on another device or in another dtype is another key (meta
    tensors stand for a second device: keys need no data)."""
    eng = ExecutionEngine(persistent=False)
    w = torch.ones(4, 3)
    x = torch.zeros(2, 4)
    base = eng.key(_linear(w), (x,), fingerprint="placed:v1")
    assert base == eng.key(_linear(w.clone()), (x.clone(),), fingerprint="placed:v1")
    args, weights = x, w
    if other == "args_device":
        args = x.to("meta")
    elif other == "args_dtype":
        args = x.to(torch.bfloat16)
    elif other == "weights_device":
        weights = w.to("meta")
    else:
        weights = w.to(torch.bfloat16)
    assert eng.key(_linear(weights), (args,), fingerprint="placed:v1") != base


def test_placements_never_share_a_disk_entry(tmp_path, export_only):
    """Two programs under one fingerprint and one argument signature whose
    closed-over weights are in other dtypes: the second compiles instead of
    loading the first's package; each loads back its own."""
    cache = PersistentCompileCache(str(tmp_path / "programs"))
    x = torch.ones(2, 4)
    w = torch.linspace(-1, 1, 12).reshape(4, 3)

    def cast_linear(w):
        def forward(x):
            return torch.tanh(x @ w.to(x.dtype))

        return forward

    h32 = ExecutionEngine(cache=cache).program(cast_linear(w), (x,), fingerprint="shared:v1")
    h16 = ExecutionEngine(cache=cache).program(
        cast_linear(w.to(torch.bfloat16)), (x,), fingerprint="shared:v1")
    assert (h32.source, h16.source) == ("compile", "compile")
    assert h32.key != h16.key and cache.stats()["entries"] == 2
    for weights, handle in ((w, h32), (w.to(torch.bfloat16), h16)):
        again = ExecutionEngine(cache=cache).program(cast_linear(weights), (x,),
                                                     fingerprint="shared:v1")
        assert again.source == "disk" and again.key == handle.key
        np.testing.assert_array_equal(again(x).numpy(), cast_linear(weights)(x).numpy())


def test_closure_placements_reach_a_torch_function():
    from sparkdl_tpu_torch.graph import TorchFunction

    fn = TorchFunction(lambda p, x: x @ p["w"], {"w": np.ones((4, 3), np.float32)})
    params = fn.placed_params("cpu")

    def forward(x, _params=params):
        return fn.apply(_params, x)[0]

    assert core.closure_placements(forward) == [("cpu", "torch.float32")]
    assert core.closure_placements(torch.nn.Linear(2, 2).to(torch.bfloat16)) == [
        ("cpu", "torch.bfloat16")]


# ----------------------------------------------------------------------
# in-memory LRU
# ----------------------------------------------------------------------
def test_lru_evicts_under_a_small_maxsize(export_only):
    eng = ExecutionEngine(maxsize=2, persistent=False)

    def fn(x):
        return x + 1.0

    keys = []
    for n in (2, 3, 4):
        h = eng.program(fn, (torch.zeros(n),), fingerprint="lru:t")
        assert h.source == "compile"
        keys.append(h.key)
    assert eng.stats()["programs"] == 2
    assert eng.lookup(keys[0]) is None
    assert eng.lookup(keys[1]) is not None and eng.lookup(keys[2]) is not None
    # the evicted signature compiles again (no disk tier), evicting the next
    h = eng.program(fn, (torch.zeros(2),), fingerprint="lru:t")
    assert h.key == keys[0] and h.source == "compile"
    assert eng.lookup(keys[1]) is None
    assert len(export_only.compiled) == 4


def test_memory_hit_is_free_and_recency_updates(export_only):
    eng = ExecutionEngine(maxsize=2, persistent=False)

    def fn(x):
        return x * 2.0

    k2 = eng.program(fn, (torch.zeros(2),)).key
    eng.program(fn, (torch.zeros(3),))
    h = eng.program(fn, (torch.zeros(2),))
    assert h.source == "memory" and h.seconds == 0.0
    eng.program(fn, (torch.zeros(4),))
    assert eng.lookup(k2) is not None


def test_params_passed_as_an_input_are_not_baked_in(export_only):
    """Weights passed as the program's first input stay inputs: a program
    saved and loaded again (as a package is) reads the tensors it is
    called with, so that an endpoint's programs share one copy. Weights a
    function closes over are copied into the program."""
    w = torch.arange(4, dtype=torch.float32)
    eng = ExecutionEngine(persistent=False)
    as_input = eng.program(lambda p, x: x * p["w"], ({"w": w}, torch.ones(4)))
    closed = eng.program(lambda x: x * w, (torch.ones(4),))
    w.mul_(2.0)
    np.testing.assert_array_equal(as_input({"w": w}, torch.ones(4)).numpy(), [0, 2, 4, 6])
    np.testing.assert_array_equal(closed(torch.ones(4)).numpy(), [0, 1, 2, 3])
    assert len(export_only.compiled) == 2


def test_every_tensor_leaf_reaches_the_package_contiguous(monkeypatch):
    """A package is compiled for the layout of its example inputs: the
    runner makes each tensor leaf contiguous, a transposed weight inside a
    params dict too (on the card a package given 54 non-contiguous Keras
    kernels computed wrong rows). A recording stub stands in for the
    package; nothing is compiled."""
    seen = []

    def record(*args):
        seen.append(args)
        return args[1]

    monkeypatch.setattr(core, "compile_package", lambda fn, example_args, path: None)
    monkeypatch.setattr(core, "load_package", lambda path: record)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    eng = ExecutionEngine(persistent=False)
    prog = eng.program(lambda p, x: x @ p["w"].T, ({"w": w}, torch.ones(2, 4)))
    params = {"w": w.T.contiguous().T, "nested": [w.T], "scale": 2.0}
    assert not params["w"].is_contiguous() and not params["nested"][0].is_contiguous()
    x = torch.ones(4, 2).T
    out = prog(params, x)
    (p, xin), = seen
    assert p["w"].is_contiguous() and p["nested"][0].is_contiguous() and xin.is_contiguous()
    assert p["scale"] == 2.0
    torch.testing.assert_close(p["w"], w, rtol=0, atol=0)
    torch.testing.assert_close(p["nested"][0], w.T, rtol=0, atol=0)
    assert out is xin
    # contiguous leaves pass as they are: no copy on the served path
    prog({"w": w}, torch.ones(2, 4))
    assert seen[1][0]["w"] is w


# ----------------------------------------------------------------------
# the disk tier
# ----------------------------------------------------------------------
def test_anonymous_functions_never_persist(tmp_path, export_only):
    cache = PersistentCompileCache(str(tmp_path / "programs"))
    eng = ExecutionEngine(cache=cache)
    assert eng.program(lambda x: x + 1, (torch.zeros(2),)).source == "compile"
    assert cache.stats()["entries"] == 0
    fn = lambda x: x * 3  # noqa: E731
    k1 = eng.program(fn, (torch.zeros(2),)).key
    assert eng.program(fn, (torch.zeros(2),)).source == "memory"
    assert eng.program(fn, (torch.zeros(2),)).key == k1


def test_corrupt_entry_compiles_again(tmp_path, export_only):
    disk = str(tmp_path / "programs")
    fn = lambda x: x - 1  # noqa: E731
    h = ExecutionEngine(cache=PersistentCompileCache(disk)).program(
        fn, (torch.zeros(2),), fingerprint="corrupt:t")
    (key, path, _, _), = PersistentCompileCache(disk).entries()
    with open(path, "wb") as fh:
        fh.write(b"not a package")
    h2 = ExecutionEngine(cache=PersistentCompileCache(disk)).program(
        fn, (torch.zeros(2),), fingerprint="corrupt:t")
    assert h2.key == h.key == key and h2.source == "compile"
    np.testing.assert_array_equal(h2(torch.zeros(2)).numpy(), -1.0)


def test_failed_compile_raises_and_leaves_no_entry(tmp_path, monkeypatch):
    def broken(fn, args, path):
        raise RuntimeError("compiler says no")

    monkeypatch.setattr(core, "compile_package", broken)
    cache = PersistentCompileCache(str(tmp_path / "programs"))
    with pytest.raises(RuntimeError, match="compiler says no"):
        ExecutionEngine(cache=cache).program(lambda x: x, (torch.zeros(2),), fingerprint="b:v1")
    assert cache.stats()["entries"] == 0
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs]


def test_watchdog_hard_timeout_is_typed():
    start = time.monotonic()
    with pytest.raises(DeviceUnresponsive, match="hard timeout"):
        watchdogged(time.sleep, 5.0, soft_timeout_s=0.1, hard_timeout_s=0.3,
                    name="nap", diagnostic_code="print('alive')")
    assert time.monotonic() - start < 4.0
    assert metrics.counter("resilience.watchdog_hard_timeouts").value == 1


def test_serving_warmup_reports_compile_then_disk(tmp_path, monkeypatch, export_only):
    from sparkdl_tpu_torch.serving.cache import ProgramCache

    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(tmp_path / "serving"))

    def forward(p, x):
        return x * 2.0

    cold = ProgramCache(maxsize=8, compile_counter=metrics.counter("serving.compiles"))
    assert cold.warmup("m1", forward, (4,), np.float32, "cpu", buckets=(1, 2),
                       fingerprint="warm:test:v1") == (1, 2)
    report = cold.stats()["warmup"]["m1"]
    assert {b: r["source"] for b, r in report.items()} == {1: "compile", 2: "compile"}
    assert metrics.counter("serving.compiles").value == 2

    warm = ProgramCache(maxsize=8, compile_counter=metrics.counter("serving.compiles"))
    warm.warmup("m1", forward, (4,), np.float32, "cpu", buckets=(1, 2),
                fingerprint="warm:test:v1")
    report = warm.stats()["warmup"]["m1"]
    assert {b: r["source"] for b, r in report.items()} == {1: "disk", 2: "disk"}
    assert metrics.counter("serving.compiles").value == 2
    assert metrics.counter("serving.cache_load").value == 2
    assert warm.stats()["persistent"]["entries"] == 2


def test_unfingerprinted_warmup_stays_off_disk(tmp_path, monkeypatch, export_only):
    from sparkdl_tpu_torch.serving.cache import ProgramCache

    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(tmp_path / "anon"))
    cache = ProgramCache(maxsize=4)
    cache.warmup("anon", lambda p, x: x + 1, (3,), np.float32, "cpu", buckets=(1,))
    assert cache.stats()["persistent"]["entries"] == 0
    assert cache.stats()["warmup"]["anon"][1]["source"] == "compile"


# ----------------------------------------------------------------------
# real AOTInductor compiles
# ----------------------------------------------------------------------
def test_compiled_program_equals_eager_and_jax(tmp_path):
    """A real AOTInductor compile: the program keeps the flash forward as
    one op node, and its output equals the eager function's and the JAX
    engine's program of the same math (its flash kernel in interpret
    mode) on the same numpy inputs."""
    from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash

    w_qkv, w_out, x = attention_block(seed=0)
    block = port_block(w_qkv, w_out)
    program = core.export_program(block, (torch.from_numpy(x),))
    assert sum("flash_attention_fwd" in str(n.target) for n in program.graph.nodes) == 1

    eng = ExecutionEngine(cache=PersistentCompileCache(str(tmp_path / "programs")))
    h = eng.program(block, (x,), fingerprint="attention-block:seed0", name="block")
    assert h.source == "compile"
    assert metrics.counter("engine.cache_miss").value == 1
    assert metrics.timer("engine.compile").seconds > 0
    got = h(x).numpy()
    with torch.no_grad():
        want = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)

    def jax_block(x):
        b, s, _ = x.shape
        qkv = (x @ w_qkv).reshape(b, s, 3, 2, 32)
        o = jax_flash(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return jnp.tanh(o.reshape(b, s, 64) @ w_out)

    jax_out = np.asarray(JaxEngine(persistent=False).program(jax_block, (x,))(x))
    np.testing.assert_allclose(got, jax_out, atol=1e-5, rtol=1e-4)


_WARM_START = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {fixtures!r})
    torch.set_num_threads(1)
    from engine_fixtures import attention_block, port_block
    from sparkdl_tpu_torch.engine import ExecutionEngine, PersistentCompileCache
    from sparkdl_tpu_torch.utils.metrics import metrics
    w_qkv, w_out, x = attention_block(seed=1)
    eng = ExecutionEngine(cache=PersistentCompileCache({cache!r}))
    h = eng.program(port_block(w_qkv, w_out), (x,), fingerprint="attention-block:seed1")
    np.save({out!r}, h(x).numpy())
    print(json.dumps({{"source": h.source, "key": h.key,
                       **metrics.snapshot("engine.")}}))
""")


def _warm_start_run(tmp_path, name):
    code = _WARM_START.format(repo=REPO, fixtures=FIXTURES,
                              cache=str(tmp_path / "programs"),
                              out=str(tmp_path / f"{name}.npy"))
    env = {k: v for k, v in os.environ.items() if k != "SPARKDL_COMPILE_CACHE"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), np.load(tmp_path / f"{name}.npy")


def test_second_process_loads_instead_of_compiling(tmp_path):
    """The warm start that the JAX package's own test of it fails in the
    repository's test runs (ROADMAP queue 3): a second process with the same
    cache directory loads the package (``engine.cache_hit`` 1, no
    ``engine.compile``) and gives the first process's outputs bit for
    bit."""
    cold, cold_out = _warm_start_run(tmp_path, "cold")
    assert cold["source"] == "compile" and cold["engine.cache_miss"] == 1
    assert cold.get("engine.cache_hit", 0) == 0
    warm, warm_out = _warm_start_run(tmp_path, "warm")
    assert warm["source"] == "disk" and warm["key"] == cold["key"]
    assert warm["engine.cache_hit"] == 1
    assert warm.get("engine.cache_miss", 0) == 0
    assert warm.get("engine.compile.seconds", 0.0) == 0.0
    assert warm_out.tobytes() == cold_out.tobytes()
    w_qkv, w_out, x = attention_block(seed=1)
    with torch.no_grad():
        want = port_block(w_qkv, w_out)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(warm_out, want, atol=1e-6, rtol=1e-6)
