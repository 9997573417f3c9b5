"""Per-tenant fair-share admission of the port (``serving/admission.py``'s
``TenantPolicy``, DRR ``take`` and the two shed layers, and a ``ModelServer``
that enforces them) against the JAX package's, on the CPU.

Each case of ``tests/test_tenancy.py`` runs twice: as it is, and as its port
twin (``tests/torch_fixtures/twin.py``: the same source with its imports
naming ``sparkdl_tpu_torch``, and its ``ModelServer`` built with
``device="cpu"``, since the port's serves on the card by default). Both must
pass their own assertions. This is the fair share that the fleet simulator's
replicas run on (``sim/replica.py`` drives the real ``AdmissionQueue``).
"""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

REFERENCE = Path(__file__).with_name("test_tenancy.py")
JAX_TESTS = twin.load(REFERENCE, "_tenancy_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_tenancy_port_tests", twin.PORT_SUBS[:1] + (
    ("server = ModelServer(cfg)", 'server = ModelServer(cfg, device="cpu")'),))
CASES = [c for c, _ in twin.cases(JAX_TESTS)]


def test_every_case_is_twinned():
    assert len(CASES) == 22
    assert [c for c, _ in twin.cases(PORT_TESTS)] == CASES


@pytest.mark.parametrize("case_id", CASES)
def test_tenancy_case_passes_in_both_packages(case_id):
    for module in (JAX_TESTS, PORT_TESTS):
        with pytest.MonkeyPatch.context() as mp:
            twin.run_body(module, case_id, {}, {"monkeypatch": lambda: mp})
