"""The port's failure taxonomy, its fault injection into the data pipeline,
and ``DataFrame.sample``'s seed, against the JAX package's, on the CPU.

- Each case of ``tests/test_resilience.py``'s ``TestClassify`` and
  ``TestDataIntegration`` runs twice: as it is, and as its port twin
  (``tests/torch_fixtures/twin.py``: the same source with its imports
  naming ``sparkdl_tpu_torch``). Both must pass their own assertions:
  ``register`` teaches ``classify`` a foreign type, ``error="decode"``
  injects an ``ImageDecodeError``, and a permanent error fails fast with no
  retry. The module's autouse ``fresh_metrics`` is applied by hand around
  each body. Two cases cannot run on the port unchanged:
  ``test_xla_status_words_by_type_name`` (XLA's status words are the JAX
  package's; the port reads torch's out-of-memory error, checked here) and
  ``test_streaming_shard_loader_retries_uri_loads`` (the port's
  ``StreamingShardLoader`` takes ``batch_size`` and no retry policy).
- ``ImageDecodeError`` is a ``PermanentError`` and a ``ValueError`` in both
  packages.
- ``sample`` with a fraction in the first place keeps its seed: one seed,
  one set of rows, the JAX package's ``sample(False, 0.5, 7)`` rows. These
  cases draw with no help from ``twin.seeded_draws`` (which would seed an
  unseeded draw and so hide an ignored seed).
"""

import os
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

from sparkdl_tpu.image.imageIO import ImageDecodeError as JaxImageDecodeError  # noqa: E402
from sparkdl_tpu.resilience import errors as jax_errors  # noqa: E402
from sparkdl_tpu.sql.session import TPUSession  # noqa: E402
from sparkdl_tpu_torch.image.imageIO import ImageDecodeError  # noqa: E402
from sparkdl_tpu_torch.resilience import errors  # noqa: E402
from sparkdl_tpu_torch.resilience.inject import FaultPlan, Rule  # noqa: E402
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402

REFERENCE = Path(__file__).with_name("test_resilience.py")
JAX_TESTS = twin.load(REFERENCE, "_resilience_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_resilience_port_tests", twin.PORT_SUBS[:1])
#: the reference's cases the port cannot run unchanged, and why
NOT_TWINNED = {
    "TestClassify::test_xla_status_words_by_type_name":
        "XLA status words; the port classifies torch.OutOfMemoryError",
    "TestDataIntegration::test_streaming_shard_loader_retries_uri_loads":
        "the port's StreamingShardLoader takes batch_size and no retry policy",
}
CASES = [c for c, _ in twin.cases(JAX_TESTS)
         if c.startswith(("TestClassify::", "TestDataIntegration::")) and c not in NOT_TWINNED]


def _run(module, case_id, tmp_path):
    module.metrics.reset()  # the module's autouse fresh_metrics
    try:
        with pytest.MonkeyPatch.context() as mp:
            twin.run_body(module, case_id, {}, {
                "tmp_path": lambda: tmp_path,
                "monkeypatch": lambda: mp,
            })
    finally:
        module.metrics.reset()


def test_every_case_is_twinned_or_named():
    listed = [c for c, _ in twin.cases(JAX_TESTS)
              if c.startswith(("TestClassify::", "TestDataIntegration::"))]
    assert len(listed) == 12
    assert sorted(CASES + list(NOT_TWINNED)) == sorted(listed)


@pytest.mark.parametrize("case_id", CASES)
def test_resilience_case_passes_in_both_packages(case_id, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    _run(JAX_TESTS, case_id, tmp_path / "jax")
    _run(PORT_TESTS, case_id, tmp_path / "torch")


def test_card_out_of_memory_is_transient():
    """The port's counterpart of XLA's ``RESOURCE_EXHAUSTED``."""
    assert errors.is_transient(torch.OutOfMemoryError("CUDA out of memory"))
    assert not errors.is_transient(RuntimeError("CUDA out of memory"))


def test_register_narrows_and_is_consulted_before_the_built_in_rules():
    class VendorBlip(ConnectionError):
        pass

    class VendorFatal(VendorBlip):
        pass

    assert errors.is_transient(VendorFatal("x"))  # a ConnectionError
    errors.register(VendorBlip, transient=True)
    errors.register(VendorFatal, transient=False)
    try:
        assert errors.is_transient(VendorBlip("x"))
        assert not errors.is_transient(VendorFatal("x"))
        assert errors.classify(errors.TransientError("x")) is errors.TransientError
    finally:
        errors._REGISTERED.remove((VendorBlip, True))
        errors._REGISTERED.remove((VendorFatal, False))


def test_image_decode_error_is_permanent_in_both_packages():
    got, want = ImageDecodeError("f.png"), JaxImageDecodeError("f.png")
    assert isinstance(want, jax_errors.PermanentError) and isinstance(want, ValueError)
    assert isinstance(got, errors.PermanentError) and isinstance(got, ValueError)
    assert str(got) == str(want)
    assert errors.classify(got) is errors.PermanentError


def test_decode_shorthand_injects_an_image_decode_error():
    err = Rule("data.map", at=1, error="decode").make_error()
    assert type(err) is ImageDecodeError and "data.map" in err.origin
    assert FaultPlan().add("data.source", error="decode", p=1.0).sites() == ("data.source",)
    with pytest.raises(ValueError, match="decode"):
        Rule("data.map", at=1, error="corrupt")


# -- DataFrame.sample's seed ----------------------------------------------------------

def _frames():
    rows = [(i,) for i in range(400)]
    return (TorchSession.builder.getOrCreate().createDataFrame(rows, ["i"], numPartitions=3),
            TPUSession.builder.getOrCreate().createDataFrame(rows, ["i"], numPartitions=3))


def _ids(df):
    return [r.i for r in df.collect()]


@pytest.mark.parametrize("args,kwargs", [
    ((0.5,), {"seed": 7}),
    ((0.5, 7), {}),
    ((False, 0.5, 7), {}),
    ((), {"fraction": 0.5, "seed": 7}),
], ids=["keyword_seed", "positional_seed", "explicit", "keywords"])
def test_sample_keeps_its_seed(args, kwargs):
    port, ref = _frames()
    got = _ids(port.sample(*args, **kwargs))
    assert got == _ids(port.sample(*args, **kwargs))
    assert got == _ids(ref.sample(False, 0.5, 7))
    assert 0 < len(got) < 400


def test_sample_with_replacement_and_other_seeds():
    port, ref = _frames()
    assert _ids(port.sample(True, 0.5, 7)) == _ids(ref.sample(True, 0.5, 7))
    assert _ids(port.sample(0.5, seed=8)) != _ids(port.sample(0.5, seed=7))
    assert _ids(port.sample(0.5, seed=8)) == _ids(ref.sample(False, 0.5, 8))
