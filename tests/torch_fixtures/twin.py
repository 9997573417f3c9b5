"""Run a test file of the JAX package against the port, body for body.

``load(path, name, subs)`` executes a test file as a fresh module; with
``PORT_SUBS`` its imports name the port (``sparkdl_tpu.`` ->
``sparkdl_tpu_torch.``, ``TPUSession`` -> ``TorchSession``), so the port's
twin of each test runs the same data through the same calls. Each
substitution must apply, so a reference file that drifts fails loudly.
``cases(module)`` lists its tests (``Class::name``, expanded over
``parametrize`` marks) and ``run_body`` calls one, with its fixtures: the
module's and class's own, resolved by name, and the built-in ones the caller
passes (``tpu_session``, ``tmp_path``, ``monkeypatch``).

``seeded_draws()`` seeds numpy's unseeded ``RandomState`` alike on both
sides. ``recording(df_cls)`` logs every action of a DataFrame class that hands data
back (``collect``, ``count``, ``toPandas``, ...: its schema and result, made
comparable across the packages by ``normalize``), and
``jsonl_outputs(root)`` reads every ``.jsonl`` file a body wrote, the
``epoch`` of each line dropped (epoch boundaries follow the micro-batches a
poller thread happens to cut; window contents and their order do not).
"""

from __future__ import annotations

import inspect
import itertools
import json
import math
import types
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

PORT_SUBS: Tuple[Tuple[str, str], ...] = (
    ("sparkdl_tpu.", "sparkdl_tpu_torch."),
    ("TPUSession", "TorchSession"),
)


def load(path: Path, name: str, subs: Sequence[Tuple[str, str]] = ()) -> types.ModuleType:
    """``path`` executed as module ``name``, after each ``(old, new)`` of
    ``subs`` is replaced throughout its source."""
    source = Path(path).read_text()
    for old, new in subs:
        if old not in source:
            raise AssertionError(f"{path}: {old!r} is not in the source any more")
        source = source.replace(old, new)
    module = types.ModuleType(name)
    module.__file__ = str(path)
    exec(compile(source, f"{path} ({name})", "exec"), module.__dict__)
    return module


def _param_sets(fn) -> List[Tuple[str, Dict[str, Any]]]:
    """(id suffix, arguments) for each call ``fn``'s parametrize marks
    ask for: the product of the marks, indexed as ``[i-j]``."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return [("", {})]
    axes = []
    for mark in marks:
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = []
        for i, value in enumerate(values):
            value = getattr(value, "values", value)  # pytest.param(...)
            if len(names) == 1:
                value = (value,) if not isinstance(value, tuple) or len(value) != 1 else value
            rows.append((str(i), dict(zip(names, value))))
        axes.append(rows)
    out = []
    for combo in itertools.product(*axes):
        args: Dict[str, Any] = {}
        for _, a in combo:
            args.update(a)
        out.append(("[" + "-".join(i for i, _ in combo) + "]", args))
    return out


def cases(module: types.ModuleType) -> List[Tuple[str, Dict[str, Any]]]:
    """Every test of ``module`` as ``(qualified id, parametrize arguments)``:
    module-level ``test*`` functions and the ``test*`` methods of its
    ``Test*`` classes, in file order."""
    out = []
    for name, obj in vars(module).items():
        if name.startswith("test") and inspect.isfunction(obj):
            out += [(name + sfx, args) for sfx, args in _param_sets(obj)]
        elif name.startswith("Test") and inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if mname.startswith("test") and inspect.isfunction(meth):
                    out += [(f"{name}::{mname}{sfx}", args)
                            for sfx, args in _param_sets(meth)]
    return out


def _raw(fixture) -> Callable:
    get = getattr(fixture, "_get_wrapped_function", None)
    return get() if get is not None else getattr(fixture, "__wrapped__", fixture)


def run_body(module: types.ModuleType, case_id: str, args: Dict[str, Any],
             builtins: Dict[str, Callable[[], Any]]) -> None:
    """Call test ``case_id`` of ``module`` (its parametrize ``args`` given),
    resolving each other argument as pytest would: a built-in (``builtins``
    maps a name to a factory), else a fixture of the test's class, else one
    of the module. Generator fixtures are finalized, in reverse, after the
    body."""
    qual = case_id.split("[")[0]
    cls_name, fn_name = qual.split("::") if "::" in qual else (None, qual)
    owner = getattr(module, cls_name)() if cls_name else None
    fn = getattr(owner, fn_name) if owner is not None else getattr(module, fn_name)
    values: Dict[str, Any] = dict(args)
    finalizers: List[Callable[[], None]] = []

    def resolve(name: str) -> Any:
        if name in values:
            return values[name]
        if name in builtins:
            value = builtins[name]()
        else:
            bound = owner is not None and name in type(owner).__dict__
            fixture = type(owner).__dict__[name] if bound else getattr(module, name)
            raw = _raw(fixture)
            params = [p for p in inspect.signature(raw).parameters if p != "self"]
            call_args = [resolve(p) for p in params]
            value = raw(owner, *call_args) if bound else raw(*call_args)
            if inspect.isgenerator(value):
                gen = value
                value = next(gen)
                finalizers.append(lambda g=gen: next(g, None))
        values[name] = value
        return value

    try:
        fn(**{p: resolve(p) for p in inspect.signature(fn).parameters})
    finally:
        for fin in reversed(finalizers):
            fin()


def normalize(v: Any) -> Any:
    """``v`` as plain tuples that compare equal across the two packages
    exactly when the values are: floats by their bits (NaN equal to NaN),
    arrays by dtype, shape and bytes, rows by fields and values, each with
    its type's name."""
    if hasattr(v, "_fields") and hasattr(v, "_values"):
        return ("Row", tuple(v._fields), tuple(normalize(x) for x in v._values))
    if isinstance(v, (bool, np.bool_)):
        return (type(v).__name__, bool(v))
    if isinstance(v, (int, np.integer)):
        return (type(v).__name__, int(v))
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return (type(v).__name__, "nan" if math.isnan(f) else f.hex())
    if v is None or isinstance(v, (str, bytes)):
        return v
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ("ndarray", "O", v.shape, normalize(v.tolist()))
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(normalize(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple((normalize(k), normalize(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(repr(normalize(x)) for x in v)))
    if hasattr(v, "toArray"):
        return (type(v).__name__, normalize(np.asarray(v.toArray())))
    return (type(v).__name__, repr(v).replace("sparkdl_tpu_torch", "sparkdl_tpu"))


def _plain(method: str, value: Any) -> Any:
    if method == "toPandas":
        return (list(value.columns), value.to_dict("list"))
    if method == "to_arrow":
        return (value.schema.names, value.to_pydict())
    return value


#: the DataFrame actions that hand data to the caller
RECORDED = ("collect", "count", "toPandas", "to_arrow", "corr", "cov")


@contextmanager
def recording(df_cls):
    """Log ``(action, schema, normalized result)`` of every call of a
    :data:`RECORDED` action on ``df_cls`` while the block runs (a nested
    call, ``tail`` through ``collect``, logs too); yields the log."""
    log: List[Tuple[str, str, Any]] = []
    originals = {m: getattr(df_cls, m) for m in RECORDED}

    def wrap(method, orig):
        def action(self, *a, **kw):
            out = orig(self, *a, **kw)
            log.append((method, self.schema.simpleString(), normalize(_plain(method, out))))
            return out
        return action

    for method, orig in originals.items():
        setattr(df_cls, method, wrap(method, orig))
    try:
        yield log
    finally:
        for method, orig in originals.items():
            setattr(df_cls, method, orig)


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(0 if seed is None else seed)


@contextmanager
def seeded_draws():
    """While the block runs, ``np.random.RandomState()`` without a seed is
    seeded with 0, so a body that draws unseeded (``DataFrame.sample(1.0)``,
    no seed given) draws the same numbers on both sides. A seeded draw is
    untouched: the port's ``sample`` is held to its own seed, not to this."""
    orig = np.random.RandomState
    np.random.RandomState = _SeededRandomState
    try:
        yield
    finally:
        np.random.RandomState = orig


def jsonl_outputs(root: Path) -> Dict[str, List[str]]:
    """Each ``.jsonl`` file under ``root`` (by relative path) as its
    complete lines re-serialized without their ``epoch`` key."""
    out = {}
    for path in sorted(Path(root).rglob("*.jsonl")):
        lines = []
        with open(path) as fh:
            for line in fh:
                if not line.endswith("\n"):
                    continue
                row = json.loads(line)
                row.pop("epoch", None)
                lines.append(json.dumps(row))
        out[str(path.relative_to(root))] = lines
    return out


def first_difference(got: List[Any], want: List[Any]) -> str:
    """Where two logs part: the first index and both entries."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"entry {i}:\n  port: {g!r}\n  JAX:  {w!r}"
    return f"lengths {len(got)} (port) and {len(want)} (JAX)"
