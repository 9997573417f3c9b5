"""The port's C++ batch packer (``sparkdl_tpu_torch/native``) on the CPU.

- ``tests/test_native.py``: each body that runs unchanged against the port
  runs as its twin (``tests/torch_fixtures/twin.py``: the same source with
  its imports naming ``sparkdl_tpu_torch``), against the numpy pack and
  ``jax.image.resize`` at the reference's tolerances (``atol=2e-2`` for a
  pack with a resize, exact without one, ``atol=1e-2`` for
  ``resize_batch``). The four bodies that call the JAX package's
  ``decode_image_batch(rows, n_channels, target_hw, ...)`` are written here
  with the same data and tolerances against the port's signature
  (``target_hw`` second, ``n_channels`` a keyword);
- ``tests/test_native_loader.py``'s single-flight case for the port's
  loader, and the loader's own rules: the build's name,
  ``SPARKDL_NO_NATIVE=1`` read at every call, and each call's threads
  chosen by the call (the same bytes on any count);
- ``decode_image_batch`` and ``make_image_decode_plan`` with the packer and
  under ``SPARKDL_NO_NATIVE=1``: the same dtype and bytes;
- the callers that reach the packer through the decode plan
  (``DeepImageFeaturizer``, ``TFImageTransformer``, the Keras image UDF)
  give the same rows with the packer and without it.

The library builds once per process at first use (``g++``, about a second
and a half of one core), and every frame here is a few small images.
"""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparkdl_tpu.image import imageIO as jax_imageIO  # noqa: E402
from sparkdl_tpu.transformers import utils as jax_utils  # noqa: E402
from sparkdl_tpu_torch import native  # noqa: E402
from sparkdl_tpu_torch.image import imageIO  # noqa: E402
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402
from sparkdl_tpu_torch.sql.types import Row  # noqa: E402
from sparkdl_tpu_torch.transformers import utils  # noqa: E402
from sparkdl_tpu_torch.transformers.utils import decode_image_batch  # noqa: E402

REFERENCE = Path(__file__).with_name("test_native.py")
PORT_SUBS = (("from sparkdl_tpu import native", "from sparkdl_tpu_torch import native"),
             *twin.PORT_SUBS[:1])


def _load_reference():
    """The port's twin of test_native.py, executed with the port's packer
    off: its skip mark asks ``native.is_available()`` as it is imported,
    and collecting this file should build nothing (the fixture builds; the
    port's loader keeps no verdict under ``SPARKDL_NO_NATIVE=1``)."""
    saved = os.environ.get("SPARKDL_NO_NATIVE")
    os.environ["SPARKDL_NO_NATIVE"] = "1"
    try:
        return twin.load(REFERENCE, "_native_port_tests", PORT_SUBS)
    finally:
        if saved is None:
            del os.environ["SPARKDL_NO_NATIVE"]
        else:
            os.environ["SPARKDL_NO_NATIVE"] = saved


PORT_TESTS = _load_reference()
#: the bodies of test_native.py that call decode_image_batch with the JAX
#: package's signature; each has a case written below
SIGNATURE_CHANGED = {
    "test_decode_image_batch_uses_native_and_matches": "test_decode_with_and_without_native",
    "test_unknown_mode_falls_back_to_python_error": "test_unknown_mode_raises_the_numpy_error",
    "test_uint8_pack_native_and_python": "test_uint8_pack_native_and_numpy",
    "test_uint8_pack_rejects_float_rows": "test_uint8_pack_rejects_float_rows",
}
TWIN_CASES = [c for c, _ in twin.cases(PORT_TESTS) if c not in SIGNATURE_CHANGED]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _packer(monkeypatch):
    """The library, built (once per process) before each case; a case that
    turns it off does so through the environment, which the loader reads
    at every call."""
    monkeypatch.delenv("SPARKDL_NO_NATIVE", raising=False)
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    if not native.is_available():
        pytest.skip("the native batch packer did not build (no C++ compiler?)")


def _without_native(monkeypatch, fn):
    """``fn()`` under ``SPARKDL_NO_NATIVE=1``."""
    with monkeypatch.context() as mp:
        mp.setenv("SPARKDL_NO_NATIVE", "1")
        assert not native.is_available()
        return fn()


def test_every_reference_case_is_covered():
    assert PORT_TESTS.native is native and PORT_TESTS.imageIO is imageIO
    cases = [c for c, _ in twin.cases(PORT_TESTS)]
    assert len(cases) == 8
    assert sorted(TWIN_CASES + list(SIGNATURE_CHANGED)) == sorted(cases)
    assert all(name in globals() for name in SIGNATURE_CHANGED.values())


@pytest.mark.parametrize("case_id", TWIN_CASES)
def test_native_case_runs_against_the_port(case_id, tmp_path, monkeypatch):
    twin.run_body(PORT_TESTS, case_id, {}, {
        "tmp_path": lambda: tmp_path,
        "monkeypatch": lambda: monkeypatch,
    })


# -- the bodies of test_native.py on the port's signature ----------------------

def test_decode_with_and_without_native(monkeypatch):
    rng = np.random.RandomState(4)
    rows = PORT_TESTS._rows(rng)
    with_native = decode_image_batch(rows, (48, 48), n_channels=3, to_rgb=True, device="cpu")
    without = _without_native(monkeypatch, lambda: decode_image_batch(
        rows, (48, 48), n_channels=3, to_rgb=True, device="cpu"))
    np.testing.assert_allclose(with_native, without, atol=2e-2)


def test_unknown_mode_raises_the_numpy_error():
    bad = dict(origin="", height=4, width=4, nChannels=3, mode=99, data=bytes(4 * 4 * 3))
    assert native.pack_image_rows([Row(**bad)], (8, 8), 3) is None
    with pytest.raises(KeyError):
        decode_image_batch([Row(**bad)], (8, 8), device="cpu")


def test_uint8_pack_native_and_numpy(monkeypatch):
    rng = np.random.RandomState(5)
    arrs = [rng.randint(0, 255, (20, 24, 3), dtype=np.uint8) for _ in range(4)]
    rows = [imageIO.imageArrayToStruct(a) for a in arrs]

    got = native.pack_image_rows_u8(rows, (20, 24), 3, bgr_to_rgb=True)
    assert got is not None and got.dtype == np.uint8
    want = np.stack([a[..., ::-1] for a in arrs])
    np.testing.assert_array_equal(got, want)

    batch = decode_image_batch(rows, (64, 64), to_rgb=True, prefer_uint8=True, device="cpu")
    assert batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, want)
    numpy_batch = _without_native(monkeypatch, lambda: decode_image_batch(
        rows, (64, 64), to_rgb=True, prefer_uint8=True, device="cpu"))
    assert numpy_batch.dtype == np.uint8
    np.testing.assert_array_equal(numpy_batch, want)
    mixed = rows + [imageIO.imageArrayToStruct(
        rng.randint(0, 255, (10, 12, 3), dtype=np.uint8))]
    fbatch = decode_image_batch(mixed, (16, 16), to_rgb=True, prefer_uint8=True, device="cpu")
    assert fbatch.dtype == np.float32 and fbatch.shape == (5, 16, 16, 3)


def test_uint8_pack_rejects_float_rows():
    rng = np.random.RandomState(6)
    rows = [imageIO.imageArrayToStruct((rng.rand(8, 8, 3) * 255).astype(np.float32))]
    assert native.pack_image_rows_u8(rows, (8, 8), 3) is None
    batch = decode_image_batch(rows, None, prefer_uint8=True, device="cpu")
    assert batch.dtype == np.float32


# -- the loader ------------------------------------------------------------------

def test_load_builds_once_outside_the_lock(monkeypatch, tmp_path):
    """``tests/test_native_loader.py``'s contract: while one thread builds,
    the loader's lock is free; four first callers share one build; the
    verdict is kept."""
    calls = []
    build_started = threading.Event()
    release_build = threading.Event()

    def slow_build(path):
        calls.append(path)
        build_started.set()
        assert release_build.wait(timeout=30.0), "test never released build"
        return False  # "toolchain unavailable": the loader must give None

    src = tmp_path / "src.cpp"
    src.write_text("// never compiled")
    monkeypatch.setattr(native, "_build", slow_build)
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_packer", native.Once())

    results = []
    threads = [threading.Thread(target=lambda: results.append(native._load()))
               for _ in range(4)]
    for t in threads:
        t.start()
    assert build_started.wait(timeout=30.0), "no thread reached the build"
    assert native._packer._lock.acquire(timeout=5.0), (
        "loader lock held across the native build: the single-flight "
        "pattern regressed to build-under-lock")
    native._packer._lock.release()

    release_build.set()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1, "concurrent first callers must share one build"
    assert calls[0].startswith(str(tmp_path / "build"))
    assert results == [None] * 4
    assert native._load() is None
    assert len(calls) == 1


def test_build_is_named_by_source_compiler_and_flags(monkeypatch, tmp_path):
    path = native._library_path()
    assert Path(path).parent == Path(native._HERE) / "_build"
    assert Path(path).exists(), "the loaded library lies at its hashed name"
    src = tmp_path / "batchpack.cpp"
    src.write_bytes(Path(native._SRC_PATH).read_bytes())
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    assert Path(native._library_path()).name == Path(path).name
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    edited = native._library_path()
    assert Path(edited).name != Path(path).name
    monkeypatch.setenv("CXX", "clang++")
    assert native._library_path() != edited
    monkeypatch.setattr(native, "_SRC_PATH", str(tmp_path / "absent.cpp"))
    assert native._library_path() is None


def test_no_native_is_read_at_every_call(monkeypatch):
    lib = native._load()
    monkeypatch.setenv("SPARKDL_NO_NATIVE", "1")
    assert not native.is_available()
    rows = [imageIO.imageArrayToStruct(np.zeros((4, 4, 3), np.uint8))]
    assert native.pack_image_rows(rows, (4, 4), 3) is None
    assert native.pack_image_rows_u8(rows, (4, 4), 3) is None
    assert native.resize_batch(np.zeros((1, 4, 4, 3), np.float32), (2, 2)) is None
    monkeypatch.delenv("SPARKDL_NO_NATIVE")
    assert native._load() is lib


def test_threads_follow_the_output_size():
    cpus = len(os.sched_getaffinity(0))
    assert native.threads_for(32, 32 * 96 * 96 * 3) == 1
    assert native.threads_for(32, 0) == 1
    assert native.threads_for(2, 1 << 40) == min(2, cpus)
    assert native.threads_for(64, 1 << 40) == min(64, cpus)
    assert native.threads_for(64, 3 * native.BYTES_PER_THREAD) == min(3, cpus)


@pytest.mark.parametrize("n_threads", [None, 0, 1, 3])
def test_every_thread_count_packs_the_same_bytes(n_threads):
    rng = np.random.RandomState(13)
    rows = [imageIO.imageArrayToStruct(rng.randint(0, 256, (9, 7, 3)).astype(np.uint8))
            for _ in range(5)]
    want = np.stack([imageIO.imageStructToArray(r)[..., ::-1] for r in rows])
    got = native.pack_image_rows_u8(rows, (9, 7), 3, bgr_to_rgb=True, n_threads=n_threads)
    np.testing.assert_array_equal(got, want)
    got = native.pack_image_rows(rows, (9, 7), 3, bgr_to_rgb=True, n_threads=n_threads)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    x = want.astype(np.float32)
    np.testing.assert_array_equal(native.resize_batch(x, (4, 5), n_threads=n_threads),
                                  native.resize_batch(x, (4, 5), n_threads=1))


# -- decode_image_batch and the plan, with and without the packer --------------

def _decode_rows(case):
    rng = np.random.RandomState(11)
    if case == "uint8_one_size":
        images = [rng.randint(0, 256, (9, 11, 3)).astype(np.uint8) for _ in range(3)]
    elif case == "gray_and_bgra":
        images = [rng.randint(0, 256, (9, 11)).astype(np.uint8),
                  rng.randint(0, 256, (9, 11, 4)).astype(np.uint8)]
    elif case == "gray_only":
        images = [rng.randint(0, 256, (7, 5)).astype(np.uint8) for _ in range(2)]
    elif case == "float_one_size":
        images = [(rng.rand(9, 11, 3) * 255).astype(np.float32) for _ in range(2)]
    else:  # "mixed_sizes"
        images = [rng.randint(0, 256, (9, 11, 3)).astype(np.uint8),
                  (rng.rand(14, 6, 3) * 255).astype(np.float32),
                  rng.randint(0, 256, (9, 11, 3)).astype(np.uint8),
                  rng.randint(0, 256, (12, 12, 3)).astype(np.uint8)]
    return images


DECODE_CASES = ["uint8_one_size", "gray_and_bgra", "gray_only", "float_one_size",
                "mixed_sizes"]


@pytest.mark.parametrize("n_channels,to_rgb", [(3, False), (3, True), (1, False)])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_plan_gives_the_same_bytes_without_native(case, n_channels, to_rgb, monkeypatch):
    rows = [imageIO.imageArrayToStruct(img) for img in _decode_rows(case)]
    calls = []
    for name in ("pack_image_rows", "pack_image_rows_u8"):
        orig = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))

    def run():
        plan = utils.make_image_decode_plan(rows, (12, 12), device="cpu",
                                            n_channels=n_channels, to_rgb=to_rgb)
        return plan(rows)

    got = run()
    assert calls, "the decode did not reach the packer"
    want = _without_native(monkeypatch, run)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plan_matches_jax_in_one_channel(case):
    """``n_channels=1``: one-channel uint8 rows of one size pack as uint8,
    as the JAX package's plan packs them; the rest as float32."""
    images = _decode_rows(case)
    port_rows = [imageIO.imageArrayToStruct(img) for img in images]
    jax_rows = [jax_imageIO.imageArrayToStruct(img) for img in images]
    got = utils.make_image_decode_plan(port_rows, (12, 12), device="cpu",
                                       n_channels=1)(port_rows)
    want = jax_utils.make_image_decode_plan(jax_rows, 1, (12, 12))(jax_rows)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.dtype == np.uint8) == (case == "gray_only")
    # the resize: the device resize's einsum against the packer's, both of
    # jax.image.resize's weights (test_native.py's tolerance)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=0, atol=2e-2)


def test_resize_batch_matches_the_device_resize():
    """The packer's host resize and the port's device resize compute one
    function (``jax.image.resize``'s bilinear), within test_native.py's
    ``resize_batch`` tolerance."""
    x = (np.random.RandomState(12).rand(2, 30, 20, 3) * 255).astype(np.float32)
    for size in ((45, 16), (12, 40)):
        host = native.resize_batch(x, size)
        device = utils.resize_bilinear(torch.from_numpy(x), size).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), method="bilinear"))
        np.testing.assert_allclose(host, device, atol=1e-2)
        np.testing.assert_allclose(host, want, atol=1e-2)


# -- the callers, with the packer and without it ---------------------------------

def _images(sizes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw if len(hw) == 3 else (*hw, 3)).astype(np.uint8)
            for hw in sizes]


def _frame(sizes, seed, parts=2, col="image"):
    """Rows in ``parts`` partitions: the first all of ``sizes[0]`` (packed as
    uint8 at source size), the last mixing sizes (float32, resized)."""
    rows = [{col: imageIO.imageArrayToStruct(img, origin=f"img{i}")}
            for i, img in enumerate(_images(sizes, seed))]
    return TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=parts)


def _vectors(rows, col):
    return np.stack([np.asarray(r[col].toArray()) for r in rows])


def _same_rows(monkeypatch, transform, col):
    calls = []
    orig = native.pack_image_rows_u8
    monkeypatch.setattr(native, "pack_image_rows_u8",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _vectors(transform(), col)
    assert calls, "the caller did not reach the packer"
    want = _vectors(_without_native(monkeypatch, transform), col)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


SIZES = [(20, 24), (20, 24), (20, 24), (31, 17)]


def test_featurizer_rows_with_and_without_native(monkeypatch):
    from sparkdl_tpu_torch import DeepImageFeaturizer

    df = _frame(SIZES, seed=1)
    stage = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                modelName="MobileNetV2", modelWeights="random",
                                computeDtype="float32", batchSize=2, device="cpu")
    _same_rows(monkeypatch, lambda: stage.transform(df).collect(), "features")


@pytest.mark.parametrize("order", ["RGB", "L"])
def test_tf_image_transformer_rows_with_and_without_native(monkeypatch, order):
    from sparkdl_tpu_torch import TFImageTransformer
    from sparkdl_tpu_torch.graph import TorchFunction

    if order == "L":  # one-channel rows: the uint8 pack in one channel
        rows = [{"image": imageIO.imageArrayToStruct(img[..., 0], origin=f"g{i}")}
                for i, img in enumerate(_images(SIZES[:3], seed=3))]
        df = TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=2)
    else:
        df = _frame(SIZES, seed=2)
    stage = TFImageTransformer(
        inputCol="image", outputCol="out", inputShape=(16, 16), channelOrder=order,
        batchSize=2, device="cpu",
        graph=TorchFunction.from_callable(lambda x: x.mean(dim=(1, 2)), name="chan_mean"))
    _same_rows(monkeypatch, lambda: stage.transform(df).collect(), "out")


def _layer(cls, name, **config):
    return {"module": "keras.layers", "class_name": cls, "config": {"name": name, **config}}


def test_keras_image_udf_rows_with_and_without_native(monkeypatch, tmp_path):
    from sparkdl_tpu_torch import registerKerasImageUDF
    from sparkdl_tpu_torch.models.keras_model import write_keras_file

    config = {"module": "keras", "class_name": "Sequential", "config": {
        "name": "small_cnn", "layers": [
            _layer("InputLayer", "input_layer", batch_shape=[None, 16, 16, 3]),
            _layer("Conv2D", "conv2d", filters=4, kernel_size=[3, 3], strides=[1, 1],
                   padding="valid", activation="relu", use_bias=True),
            _layer("GlobalAveragePooling2D", "global_average_pooling2d"),
            _layer("Dense", "dense", units=5, activation="linear", use_bias=True),
        ]}}
    rng = np.random.default_rng(0)
    weights = {"conv2d": [rng.standard_normal((3, 3, 3, 4)) * 0.01, np.zeros(4)],
               "dense": [rng.standard_normal((4, 5)), rng.standard_normal(5)]}
    path = str(tmp_path / "small_cnn.keras")
    write_keras_file(path, config, {k: [np.asarray(w, np.float32) for w in v]
                                    for k, v in weights.items()})
    udf = registerKerasImageUDF("native_small_cnn", path, device="cpu")
    df = _frame(SIZES, seed=4)
    _same_rows(monkeypatch, lambda: df.select(udf("image").alias("preds")).collect(),
               "preds")
