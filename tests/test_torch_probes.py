"""The port's bounded liveness probe (``utils/probes.py``) and its opt-in
profiler wrapper (``utils/profiler.py``) against the JAX package's, on the
CPU.

- Each case of ``tests/test_probes.py`` runs twice: as it is, and as its
  port twin (``tests/torch_fixtures/twin.py``: the same source with its
  imports naming ``sparkdl_tpu_torch``). Both must pass their own
  assertions. On the port the profiler cases capture a real
  ``torch.profiler`` trace (CPU activity here).
- The port's own cases: a capture writes a ``*.pt.trace.json``, a nested
  capture writes nothing, the probe module loads without torch, and
  ``SPARKDL_PROFILE_DIR`` makes a batched transform (a two-row
  ``DeepImageFeaturizer`` on the CPU) write a trace with no code change, and
  nothing when it is unset.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

from sparkdl_tpu_torch.image import imageIO  # noqa: E402
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402
from sparkdl_tpu_torch.transformers.named_image import DeepImageFeaturizer  # noqa: E402
from sparkdl_tpu_torch.utils import profiler  # noqa: E402
from sparkdl_tpu_torch.utils.probes import bounded_subprocess_probe  # noqa: E402

REFERENCE = Path(__file__).with_name("test_probes.py")
JAX_TESTS = twin.load(REFERENCE, "_probes_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_probes_port_tests", twin.PORT_SUBS[:1])
CASES = [c for c, _ in twin.cases(JAX_TESTS)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traces(directory):
    return sorted(Path(directory).rglob("*.pt.trace.json"))


def test_every_case_is_twinned():
    assert len(CASES) == 10
    assert [c for c, _ in twin.cases(PORT_TESTS)] == CASES


@pytest.mark.parametrize("case_id", CASES)
def test_probes_case_passes_in_both_packages(case_id, tmp_path):
    for side, module in (("jax", JAX_TESTS), ("torch", PORT_TESTS)):
        (tmp_path / side).mkdir()
        with pytest.MonkeyPatch.context() as mp:
            twin.run_body(module, case_id, {}, {
                "tmp_path": lambda: tmp_path / side,
                "monkeypatch": lambda: mp,
            })


def test_a_capture_writes_a_trace_and_a_nested_one_nothing(tmp_path):
    with profiler.trace(str(tmp_path / "outer")):
        with profiler.trace(str(tmp_path / "inner")):
            with profiler.annotate("nested_matmul"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = _traces(tmp_path / "outer")
    assert _traces(tmp_path / "inner") == []
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "nested_matmul" for e in events)
    assert not profiler._trace_active


def test_the_probe_module_loads_without_torch():
    ok, msg = bounded_subprocess_probe(
        "import sys\n"
        "import sparkdl_tpu_torch.utils.probes\n"
        "assert 'torch' not in sys.modules, 'probes.py imported torch'\n"
        "print('torch-free')",
        timeout_s=120,
    )
    assert ok, msg
    assert msg == "torch-free"


def test_profile_dir_traces_a_batched_transform(tmp_path, monkeypatch):
    """``SPARKDL_PROFILE_DIR`` reaches ``run_batched_rows`` with no code
    change: a two-row MobileNetV2 featurizer on small images writes one trace
    holding the model's convolutions; unset, the same transform writes
    nothing."""
    rng = np.random.RandomState(0)
    structs = [imageIO.imageArrayToStruct(rng.randint(0, 255, (32, 32, 3)).astype(np.uint8),
                                          origin=f"img{i}") for i in range(2)]
    df = TorchSession.builder.getOrCreate().createDataFrame([{"image": s} for s in structs],
                                                            numPartitions=1)
    stage = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                                modelWeights="random", computeDtype="float32", batchSize=2,
                                device="cpu")
    traced, untraced = tmp_path / "traced", tmp_path / "untraced"
    monkeypatch.setenv("SPARKDL_PROFILE_DIR", str(traced))
    rows = stage.transform(df).collect()
    monkeypatch.delenv("SPARKDL_PROFILE_DIR")
    cwd_before = sorted(os.listdir(tmp_path))
    plain = stage.transform(df).collect()
    assert sorted(os.listdir(tmp_path)) == cwd_before and not untraced.exists()
    (path,) = _traces(traced)
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert any("conv" in str(n) for n in names), sorted(map(str, names))[:20]
    assert len(rows) == len(plain) == 2
    np.testing.assert_array_equal(np.stack([r["f"].toArray() for r in rows]),
                                  np.stack([r["f"].toArray() for r in plain]))
