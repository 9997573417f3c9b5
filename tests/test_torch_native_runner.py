"""The port's native second stack on the CPU: AOTInductor packages run by the
C++ runner (``native/aoti_runner.cpp``) in process and by the standalone
``aoti_tool``, against numpy, the port's Python stack and the JAX package.

The hand-written counterparts of ``tests/test_pjrt_native.py``'s nine cases
(that file needs a PJRT plugin, so it cannot be run twin for twin):

- the JAX file's ``tiny_program``, ``(w, b, x) -> (x @ w + b, x.sum(1))``
  with ``w = arange(12) / 10`` as (3, 4), ``b = ones(4)`` and ``x`` of
  ``RandomState(0)`` as (5, 3): its manifest, ``NativeProgram`` over two
  batches on the resident parameters, ``aoti_tool`` over three,
  ``stream()`` against ``__call__`` and a synchronous loop, an abandoned
  ``stream()`` leaving no buffer held, a wrong input shape or count
  (``ValueError``), and a package of another device refused. To numpy at
  ``TINY_TOL``: the same float32 sums in another order. Beside them, no
  fallback when the runner cannot build, and a package that calls the
  flash-attention op: in process it runs, ``aoti_tool`` refuses it by name;
- a float32 MobileNetV2 featurizer (batch 2, source 64x64: the resize on
  the way in is exported too) from seeded Flax weights carried across by
  the registry's converter (``models/convert.py``), through the runner
  against the JAX package's fused forward of ``test_pjrt_native.py``
  (cast, resize, BGR -> RGB, preprocess, the Flax module, float32) at
  ``F32_TOL``, ``tests/test_torch_zoo.py``'s float32 bound;
- ``NativeDeepImageFeaturizer`` over 5 PNG rows of 224x224 in 2 partitions
  at batch 4 (the ragged tail) against the port's and the JAX package's
  ``DeepImageFeaturizer`` on the same weights, at ``F32_TOL``;
- the stage's uint8 batch, resized on the device and rounded as the JAX
  package rounds (bit for bit);
- the sanitizer self-test of the port's batch packer
  (``native/selftest.cpp`` with ``batchpack.cpp``, built with
  ``-fsanitize=address,undefined``).

Everything compiles at first use: the runner library and the tool with
``g++`` against torch's headers, each package with Inductor on one thread;
the builds and packages are module fixtures.
"""

import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu_torch import native
from sparkdl_tpu_torch.native import aoti, featurizer

NATIVE = Path(__file__).resolve().parents[1] / "sparkdl_tpu_torch" / "native"
# float32 sums of three or four terms in another order than numpy's
TINY_TOL = dict(rtol=1e-6, atol=1e-6)
# tests/test_torch_zoo.py's float32 bound (tests/test_models.py's
# Keras-oracle bound): features of unit order from the seeded weights
F32_TOL = dict(rtol=1e-4, atol=1e-4)
W = np.arange(12, dtype=np.float32).reshape(3, 4) / 10.0
B = np.ones((4,), np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch._inductor.config.patch(compile_threads=1):
        yield
    torch.set_num_threads(threads)


def _tiny(p, x):
    return x @ p["w"] + p["b"], x.sum(1)


@pytest.fixture(scope="module")
def tiny_program(tmp_path_factory):
    x = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    d = str(tmp_path_factory.mktemp("prog"))
    manifest = aoti.export_program(_tiny, {"w": W, "b": B}, [x], d,
                                   input_names=["x"], device="cpu")
    return d, manifest


@pytest.fixture(scope="module")
def tool():
    return featurizer.build_tool()


def _flax_mobilenet_tree(seed: int = 0):
    """Seeded MobileNetV2 variables in the Flax layout, as
    ``tests/test_torch_zoo.py`` draws them: He-normal convs, BN scales and
    variances ``1 + 0.1|n|`` (a fifth of that on each residual branch's
    last BN), means and biases ``0.1 n``."""
    from sparkdl_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMobileNetV2

    shapes = jax.eval_shape(FlaxMobileNetV2().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        layer, name, shape = path[-2].key, path[-1].key, leaf.shape
        if len(shape) == 4:
            std = np.sqrt((1.0 if name == "depthwise_kernel" else 2.0) / np.prod(shape[:-1]))
        elif name == "kernel":
            std = 1.0 / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
            return v * np.float32(0.2) if name == "scale" and layer.endswith("_project_BN") else v
        else:
            std = 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def flax_weights():
    return _flax_mobilenet_tree()


@pytest.fixture(scope="module")
def featurizer_64(tmp_path_factory, flax_weights):
    """The float32 MobileNetV2 featurizer at batch 2 from 64x64 sources."""
    d = str(tmp_path_factory.mktemp("mnv2_64"))
    featurizer.export_featurizer("MobileNetV2", batch_size=2, out_dir=d, source_hw=(64, 64),
                                 model_weights=flax_weights, compute_dtype="float32",
                                 device="cpu")
    return d


# ---------------------------------------------------------------------------
# the tiny program
# ---------------------------------------------------------------------------

def test_export_manifest(tiny_program):
    d, manifest = tiny_program
    # the parameters in the pytree's order (a dict's insertion order; the
    # JAX package's tree sorts its keys)
    assert [p["shape"] for p in manifest["params"]] == [[3, 4], [4]]
    assert manifest["device"] == "cpu"
    assert manifest["inputs"] == [{"name": "x", "dtype": "f32", "shape": [5, 3]}]
    assert [(o["dtype"], o["shape"]) for o in manifest["outputs"]] == [("f32", [5, 4]),
                                                                      ("f32", [5])]
    for f in ("program.pt2", "params.bin", "manifest.json", "manifest.txt"):
        assert os.path.exists(os.path.join(d, f)), f
    assert os.path.getsize(os.path.join(d, "params.bin")) == (12 + 4) * 4
    assert Path(d, "manifest.txt").read_text().splitlines() == [
        "device cpu", "param f32 3,4", "param f32 4", "input f32 5,3",
        "output f32 5,4", "output f32 5"]


def test_native_program_matches_numpy(tiny_program):
    """In process: the resident parameters serve two batches."""
    d, _ = tiny_program
    rng = np.random.RandomState(1)
    with aoti.NativeProgram(d, device="cpu") as prog:
        for _ in range(2):
            x = rng.rand(5, 3).astype(np.float32)
            y, s = prog(x)
            np.testing.assert_allclose(y, x @ W + B, **TINY_TOL)
            np.testing.assert_allclose(s, x.sum(1), **TINY_TOL)
            # a tensor input takes the same path
            y2, _ = prog(torch.from_numpy(x))
            np.testing.assert_array_equal(y2, y)
        assert prog.live_buffers == 0


def test_cli_tool_streams_batches(tiny_program, tool, tmp_path):
    """The standalone binary: no Python in its process."""
    d, _ = tiny_program
    batches = np.random.RandomState(2).rand(3, 5, 3).astype(np.float32)
    batches.tofile(tmp_path / "in.bin")
    proc = subprocess.run([tool, d, str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "batches=3" in proc.stderr and "live_buffers=0" in proc.stderr
    raw = np.fromfile(tmp_path / "out.bin", np.float32)
    per_batch = 5 * 4 + 5
    assert raw.size == 3 * per_batch
    for i, rec in enumerate(raw.reshape(3, per_batch)):
        np.testing.assert_allclose(rec[:20].reshape(5, 4), batches[i] @ W + B, **TINY_TOL)
        np.testing.assert_allclose(rec[20:], batches[i].sum(1), **TINY_TOL)
    # a partial batch is an error with a message, never a crash
    batches.reshape(-1)[:7].tofile(tmp_path / "short.bin")
    proc = subprocess.run([tool, d, str(tmp_path / "short.bin"), str(tmp_path / "o.bin")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "partial batch" in proc.stderr


def test_stream_matches_call_and_a_synchronous_loop(tiny_program):
    """``stream()`` (batch i+1 enqueued before batch i is fetched) yields
    each batch's outputs in order, bit for bit those of ``__call__`` and of
    a loop over the runner's synchronous put, execute and get."""
    d, _ = tiny_program
    rng = np.random.RandomState(5)
    batches = [rng.rand(5, 3).astype(np.float32) for _ in range(5)]
    with aoti.NativeProgram(d, device="cpu") as prog:
        want = [prog(x) for x in batches]
        got = list(prog.stream(iter(batches)))
        runner = prog.runner
        sync = []
        for x in batches:
            in_id = runner.put(0, x.ctypes.data, False)
            out_ids = runner.execute([in_id], 2)
            sync.append([runner.get(o, torch.empty(shape)).numpy()
                         for o, shape in zip(out_ids, ((5, 4), (5,)))])
            for buf_id in [in_id, *out_ids]:
                runner.free(buf_id)
        assert prog.live_buffers == 0
    assert len(got) == len(want) == len(sync) == 5
    for g, w, s in zip(got, want, sync):
        for ga, wa, sa in zip(g, w, s):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(ga, sa)


def test_abandoned_stream_frees_its_buffers(tiny_program):
    d, _ = tiny_program
    rng = np.random.RandomState(6)
    batches = [rng.rand(5, 3).astype(np.float32) for _ in range(4)]
    with aoti.NativeProgram(d, device="cpu") as prog:
        gen = prog.stream(iter(batches))
        next(gen)  # one result out, one batch in flight
        assert prog.live_buffers > 0
        gen.close()
        assert prog.live_buffers == 0
        y, _ = prog(batches[0])  # the runner still serves
        np.testing.assert_allclose(y, batches[0] @ W + B, **TINY_TOL)


def test_wrong_input_shape_or_count_raises(tiny_program):
    d, _ = tiny_program
    with aoti.NativeProgram(d, device="cpu") as prog:
        with pytest.raises(ValueError, match=r"expects shape \[5, 3\]"):
            prog(np.zeros((4, 3), np.float32))
        with pytest.raises(ValueError, match="takes 1 inputs, got 2"):
            prog(np.zeros((5, 3), np.float32), np.zeros((5, 3), np.float32))
        with pytest.raises(ValueError, match="takes 1 inputs"):
            next(prog.stream(iter([(np.zeros((5, 3), np.float32),) * 2])))
        assert prog.live_buffers == 0


def test_package_of_another_device_is_refused(tiny_program, tmp_path):
    """A package runs only on the device type it was compiled for: the
    runner refuses another, naming both, before it loads anything."""
    d, _ = tiny_program
    other = tmp_path / "other"
    shutil.copytree(d, other)
    text = (other / "manifest.txt").read_text()
    (other / "manifest.txt").write_text(text.replace("device cpu", "device cuda"))
    with pytest.raises(RuntimeError, match="compiled for 'cuda'.*asked for 'cpu'"):
        aoti.NativeProgram(str(other), device="cpu")
    with pytest.raises(RuntimeError, match="compiled for 'cpu'.*asked for 'cuda'"):
        aoti.AotiRunner(d, "cuda")


def test_no_fallback_when_the_runner_cannot_build(tiny_program, monkeypatch):
    """A runner that does not build raises with the compiler's failure,
    and so does every later call: nothing runs in its place.
    ``SPARKDL_NO_NATIVE=1`` (the batch packer's switch) leaves it on."""
    d, _ = tiny_program
    monkeypatch.setenv("SPARKDL_NO_NATIVE", "1")
    with aoti.NativeProgram(d, device="cpu") as prog:
        prog(np.zeros((5, 3), np.float32))
    monkeypatch.setattr(aoti, "_runner", native.Once())
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="runner is unavailable"):
            aoti.NativeProgram(d, device="cpu")
    assert not aoti.is_available()


def test_closed_runner_raises_and_waits_for_a_call_in_progress(tiny_program):
    """A close waits for the call in progress on another thread, and every
    later call raises ``RuntimeError``: never a call into a destroyed
    runner."""
    d, _ = tiny_program
    x = np.ones((5, 3), np.float32)
    prog = aoti.NativeProgram(d, device="cpu")
    errors, done = [], threading.Event()

    def caller():
        while not done.is_set():
            try:
                np.testing.assert_allclose(prog(x)[0], x @ W + B, **TINY_TOL)
            except RuntimeError as e:
                errors.append(str(e))
                return

    t = threading.Thread(target=caller)
    t.start()
    time.sleep(0.2)
    prog.close()
    t.join(timeout=30.0)
    done.set()
    assert not t.is_alive()
    assert errors and "closed runner" in errors[0]
    with pytest.raises(RuntimeError, match="closed runner"):
        prog(x)
    prog.close()  # a second close is a no-op


class _FakeProgram:
    def __init__(self, name):
        self.name, self.closed = name, False

    def close(self):
        self.closed = True


def test_program_cache_closes_an_evicted_program_after_its_last_lease():
    """``NativeDeepImageFeaturizer``'s program cache (two programs): a
    program evicted while a transform holds it stays open until that lease
    ends; one no lease holds closes at once; a thread that loses the race
    to make a program closes its own copy and uses the cached one."""
    from sparkdl_tpu_torch.transformers.native_image import _ClosingLRU

    cache = _ClosingLRU(2)
    made = {}

    def make(name):
        def build():
            made.setdefault(name, []).append(_FakeProgram(name))
            return made[name][-1]
        return build

    with cache.lease("a", make("a")) as a:
        with cache.lease("b", make("b")) as b:
            pass
        with cache.lease("c", make("c")):  # evicts "a", the least recently used
            assert len(cache) == 2
        assert not a.closed, "closed under the thread that holds it"
        assert not b.closed
    assert a.closed
    with cache.lease("b", make("b")) as again:
        assert again is b and len(made["b"]) == 1
    with cache.lease("d", make("d")):  # evicts "c", which no lease holds
        assert made["c"][0].closed and not b.closed

    # two threads miss at once: one copy is kept, the other closed
    gate = threading.Barrier(2)
    copies, got = [], []

    def slow_make():
        gate.wait(timeout=10.0)
        copies.append(_FakeProgram("e"))
        return copies[-1]

    def use():
        with cache.lease("e", slow_make) as prog:
            got.append(prog)

    threads = [threading.Thread(target=use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert len(copies) == 2 and got[0] is got[1] and not got[0].closed
    assert [c.closed for c in copies].count(True) == 1
    assert len(cache) == 2


def test_tool_names_an_op_registered_from_python(tool, tmp_path):
    """A package that calls the flash-attention op (registered from
    Python) runs in process, where the port registered it, and makes
    ``aoti_tool`` exit 1 at load with the op's name: no crash."""
    from sparkdl_tpu_torch.ops.flash_attention import flash_attention

    q = np.random.RandomState(7).rand(1, 8, 2, 32).astype(np.float32)
    d = str(tmp_path / "flash")
    aoti.export_program(lambda p, x: flash_attention(x, x * p["s"], x),
                        {"s": np.full((1,), 0.5, np.float32)}, [q], d, device="cpu")
    with aoti.NativeProgram(d, device="cpu") as prog:
        got, = prog(q)
    qt = torch.from_numpy(q)
    np.testing.assert_allclose(got, flash_attention(qt, qt * 0.5, qt).numpy(), **TINY_TOL)
    q.tofile(tmp_path / "q.bin")
    proc = subprocess.run([tool, d, str(tmp_path / "q.bin"), str(tmp_path / "o.bin")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "sparkdl_tpu_torch::flash_attention_fwd" in proc.stderr


# ---------------------------------------------------------------------------
# the featurizer
# ---------------------------------------------------------------------------

def test_native_featurizer_oracle(featurizer_64, flax_weights, tool, monkeypatch):
    """The exported float32 MobileNetV2 featurizer, through the runner in
    process and through ``aoti_tool``, against the JAX package's fused
    forward on the same weights and uint8 batch. The tool runs on one
    OpenMP thread, as this process does, so its sums are in the same order
    and its features bit for bit the runner's."""
    from sparkdl_tpu.models import get_keras_application_model
    from sparkdl_tpu.transformers.utils import cast_and_resize_on_device

    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (2, 64, 64, 3), np.uint8)
    with aoti.NativeProgram(featurizer_64, device="cpu") as prog:
        assert prog.manifest["inputs"] == [{"name": "image", "dtype": "u8",
                                            "shape": [2, 64, 64, 3]}]
        got, = prog(x)

    entry = get_keras_application_model("MobileNetV2")
    module = entry.make_module(dtype=jnp.float32)
    h, w = entry.input_size

    def forward(v, xx):
        xx = cast_and_resize_on_device(xx, (h, w))
        xx = entry.preprocess(xx[..., ::-1])
        out = module.apply(v, xx.astype(jnp.float32), features_only=True)
        return out.reshape(out.shape[0], -1).astype(jnp.float32)

    want = np.asarray(jax.jit(forward)(flax_weights, x))
    assert got.shape == want.shape == (2, 1280)
    np.testing.assert_allclose(got, want, **F32_TOL)

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cli = featurizer.run_featurizer_cli(featurizer_64, np.stack([x, x[::-1]]))
    np.testing.assert_array_equal(cli[0], got)
    np.testing.assert_array_equal(cli[1], got[::-1])


def test_native_featurizer_stage_matches_both_python_stacks(tmp_path, flax_weights):
    """``NativeDeepImageFeaturizer`` (the C++ packer's decode, then the C++
    runner) against the port's ``DeepImageFeaturizer`` and the JAX
    package's on the same weights: 5 rows, 2 partitions, batch 4."""
    from PIL import Image

    from sparkdl_tpu import DeepImageFeaturizer as JaxDeepImageFeaturizer
    from sparkdl_tpu.image import imageIO as jax_imageIO
    from sparkdl_tpu.sql.session import TPUSession
    from sparkdl_tpu_torch import DeepImageFeaturizer, NativeDeepImageFeaturizer
    from sparkdl_tpu_torch.image import imageIO
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.utils.metrics import metrics

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (224, 224, 3), np.uint8)).save(img_dir / f"im{i}.png")
    prog_dir = str(tmp_path / "prog")
    featurizer.export_featurizer("MobileNetV2", batch_size=4, out_dir=prog_dir,
                                 model_weights=flax_weights, compute_dtype="float32",
                                 device="cpu")

    df = imageIO.readImages(str(img_dir), TorchSession.builder.getOrCreate(), numPartitions=2)
    stage = NativeDeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                                      programDir=prog_dir, device="cpu")
    metrics.reset()
    native = stage.transform(df).collect()
    snap = metrics.snapshot()
    # partitions of 3 and 2 rows: one padded batch of 4 each
    assert snap["sparkdl.rows_processed"] == 5 and snap["sparkdl.batches_run"] == 2
    python = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                                 modelWeights=flax_weights, computeDtype="float32",
                                 batchSize=4, device="cpu").transform(df).collect()
    jax_df = jax_imageIO.readImages(str(img_dir), TPUSession.builder.getOrCreate(),
                                    numPartitions=2)
    reference = JaxDeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                                       modelWeights=flax_weights, computeDtype="float32",
                                       batchSize=4).transform(jax_df).collect()

    got = np.stack([r["f"].toArray() for r in native])
    assert got.dtype == np.float64 and got.shape == (5, 1280)
    assert [r["image"]["origin"] for r in native] == [r["image"]["origin"] for r in python]
    np.testing.assert_allclose(got, np.stack([r["f"].toArray() for r in python]), **F32_TOL)
    np.testing.assert_allclose(got, np.stack([r["f"].toArray() for r in reference]), **F32_TOL)

    # no card, no run: device=None is the card, never the CPU in its place
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NativeDeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                                  programDir=prog_dir).transform(df).collect()


def test_stage_batch_stays_on_the_device_and_rounds_as_the_reference():
    """The stage's batch (``uint8_batch``): uint8 rows at the source size
    are the packer's bytes; rows that need a resize are resized on the
    device and rounded half to even and clipped there, the host path's
    floats put through the JAX package's ``np.clip(np.rint(x), 0, 255)``,
    bit for bit."""
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.transformers.native_image import uint8_batch
    from sparkdl_tpu_torch.transformers.utils import decode_image_batch

    rng = np.random.RandomState(3)
    same = [imageArrayToStruct(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8))
            for _ in range(3)]
    mixed = same[:2] + [imageArrayToStruct(rng.randint(0, 256, (9, 31, 3)).astype(np.uint8)),
                        imageArrayToStruct((rng.rand(20, 24, 3) * 255).astype(np.float32))]
    got = uint8_batch(same, (20, 24), "cpu")
    assert got.dtype == torch.uint8 and isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        got.numpy(), decode_image_batch(same, (20, 24), prefer_uint8=True, device="cpu"))
    got = uint8_batch(mixed, (20, 24), "cpu")
    host = decode_image_batch(mixed, (20, 24), always_resize=True, prefer_uint8=True,
                              device="cpu")
    assert host.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), np.clip(np.rint(host), 0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# the batch packer under the sanitizers
# ---------------------------------------------------------------------------

def test_batch_packer_sanitizer_selftest(tmp_path):
    binary = tmp_path / "selftest"
    build = subprocess.run(
        [os.environ.get("CXX") or "g++", "-g", "-O1", "-std=c++17", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         str(NATIVE / "batchpack.cpp"), str(NATIVE / "selftest.cpp"), "-o", str(binary)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-2000:]
    run = subprocess.run([str(binary)], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip() == "native selftest OK"
