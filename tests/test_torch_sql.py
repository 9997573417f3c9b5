"""The port's SQL dialect and DataFrame engine against the JAX package's, on
the CPU.

One differential case for each test of ``tests/test_sql.py``: the test's own
body runs twice, once as it is (``TPUSession``) and once as its port twin
(``tests/torch_fixtures/twin.py``: the same source with its imports naming
``sparkdl_tpu_torch``, so the same data goes through the same queries and
DataFrame calls on ``TorchSession``). Both must pass their own assertions,
so where the reference expects an error (``pytest.raises``) the port raises
the same type, and every action the two bodies take that hands back data
(``collect``, ``count``, ``toPandas``, ``to_arrow``, ``corr``, ``cov``) must
agree exactly: schema and result, floats bit for bit (both packages are the
same host Python), in order. Order is compared everywhere, also where a query
leaves it open: both sides evaluate the same partitions in the same process.

``test_sql_beyond_the_old_subset`` holds five queries that the port's first
SQL layer refused to the JAX package's results.

One fault of the JAX package is not copied: its ``DataFrame.sample`` with a
fraction in the first place moves the fraction's slot into ``seed`` and
drops a keyword seed, so ``sample(0.5, seed=7)`` draws unseeded. The port
keeps the seed. The JAX side of each case therefore runs with ``sample``'s
arguments read as pyspark reads them (:func:`_jax_sample_read_as_pyspark`):
``sample(0.5, seed=7)`` there is the JAX package's ``sample(False, 0.5, 7)``.
"""

import contextlib
import os
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

from sparkdl_tpu.sql.dataframe import DataFrame as JaxDataFrame  # noqa: E402
from sparkdl_tpu.sql.session import TPUSession  # noqa: E402
from sparkdl_tpu_torch.sql.dataframe import DataFrame as TorchDataFrame  # noqa: E402
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402

REFERENCE = Path(__file__).with_name("test_sql.py")
JAX_TESTS = twin.load(REFERENCE, "_sql_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_sql_port_tests", twin.PORT_SUBS)
CASES = twin.cases(JAX_TESTS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _sessions():
    return (TPUSession.builder.master("local[*]").appName("tests").getOrCreate(),
            TorchSession.builder.master("local[*]").appName("tests").getOrCreate())


@contextlib.contextmanager
def _jax_sample_read_as_pyspark():
    """While the block runs, the JAX package's ``DataFrame.sample`` takes a
    fraction in the first place as pyspark does: a second positional
    argument is the seed, else the keyword seed stands."""
    orig = JaxDataFrame.sample

    def sample(self, withReplacement=None, fraction=None, seed=None):
        if isinstance(withReplacement, (int, float)) and not isinstance(withReplacement, bool):
            if fraction is not None:
                seed = fraction
            withReplacement, fraction = False, withReplacement
        return orig(self, withReplacement, fraction, seed)

    JaxDataFrame.sample = sample
    try:
        yield
    finally:
        JaxDataFrame.sample = orig


def _run(module, case_id, args, session, df_cls, tmp_path):
    with twin.recording(df_cls) as log, twin.seeded_draws(), \
            pytest.MonkeyPatch.context() as mp:
        twin.run_body(module, case_id, args, {
            "tpu_session": lambda: session,
            "tmp_path": lambda: tmp_path,
            "monkeypatch": lambda: mp,
        })
    return log


def test_every_reference_test_has_a_case():
    assert len(CASES) == 242
    assert [c for c, _ in twin.cases(PORT_TESTS)] == [c for c, _ in CASES]


@pytest.mark.parametrize("case_id,args", CASES, ids=[c for c, _ in CASES])
def test_sql_case_matches_jax(case_id, args, tmp_path):
    jax_session, torch_session = _sessions()
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    with _jax_sample_read_as_pyspark():
        want = _run(JAX_TESTS, case_id, args, jax_session, JaxDataFrame, tmp_path / "jax")
    got = _run(PORT_TESTS, case_id, args, torch_session, TorchDataFrame, tmp_path / "torch")
    assert got == want, twin.first_difference(got, want)


# the five queries the port's first SQL layer refused (it took only
# SELECT <column | * | udf(columns)> FROM <view>); each now gives what the
# JAX package gives, rows or the error's type
OLD_SUBSET_QUERIES = [
    "SELECT v FROM vectors WHERE v IS NOT NULL",
    "SELECT count(*) FROM vectors",
    "SELECT v + 1 AS w FROM vectors",
    "SELECT v FROM vectors ORDER BY v",
    "SELECT a.v FROM vectors a JOIN vectors b ON a.v = b.v",
]


def _outcome(session, query):
    session.createDataFrame([([1.0],)], ["v"]).createOrReplaceTempView("vectors")
    try:
        df = session.sql(query)
        return ("rows", df.schema.simpleString(), twin.normalize(df.collect()))
    except Exception as exc:  # noqa: BLE001 - the type is the result
        return ("raises", type(exc).__name__)
    finally:
        session.catalog.dropTempView("vectors")


@pytest.mark.parametrize("query", OLD_SUBSET_QUERIES)
def test_sql_beyond_the_old_subset(query):
    jax_session, torch_session = _sessions()
    want = _outcome(jax_session, query)
    assert _outcome(torch_session, query) == want
    assert not (want[0] == "raises" and want[1] == "NotImplementedError")
