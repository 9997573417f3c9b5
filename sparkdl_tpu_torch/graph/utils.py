"""Name utilities of the graph layer: a copy of ``sparkdl_tpu.graph.utils``.

TF 1.x told op names (``"x"``) from tensor names (``"x:0"``). A
:class:`~sparkdl_tpu_torch.graph.function.TorchFunction` names its inputs
and outputs plainly, and these helpers let callers pass either form.
"""

from __future__ import annotations


def tensor_name(name: str) -> str:
    """Canonical tensor form: ``"x"`` -> ``"x:0"``; ``"x:1"`` unchanged."""
    if ":" in name:
        _, idx = name.rsplit(":", 1)
        if not idx.isdigit():
            raise ValueError(f"Invalid tensor name {name!r}")
        return name
    return f"{name}:0"


def op_name(name: str) -> str:
    """Canonical op form: ``"x:0"`` -> ``"x"``."""
    if ":" in name:
        base, idx = name.rsplit(":", 1)
        if not idx.isdigit():
            raise ValueError(f"Invalid tensor name {name!r}")
        return base
    return name


def add_scope_to_name(scope: str, name: str) -> str:
    return f"{scope}/{name}" if scope else name


def validated_input(fn, name: str) -> str:
    """Check that ``name`` is an input of ``fn`` (a TorchFunction)."""
    base = op_name(name)
    if base not in fn.input_names:
        raise ValueError(
            f"{base!r} is not an input of {fn.name!r} (inputs: {fn.input_names})"
        )
    return base


def validated_output(fn, name: str) -> str:
    """Check that ``name`` is an output of ``fn`` (a TorchFunction)."""
    base = op_name(name)
    if base not in fn.output_names:
        raise ValueError(
            f"{base!r} is not an output of {fn.name!r} (outputs: {fn.output_names})"
        )
    return base


def validated_graph(fn):
    """Check a TorchFunction's surface: inputs and outputs declared, no
    name twice."""
    from sparkdl_tpu_torch.graph.function import TorchFunction

    if not isinstance(fn, TorchFunction):
        raise TypeError(f"Expected TorchFunction, got {type(fn)}")
    if not fn.input_names or not fn.output_names:
        raise ValueError("TorchFunction must declare inputs and outputs")
    if len(set(fn.input_names)) != len(fn.input_names):
        raise ValueError("Duplicate input names")
    if len(set(fn.output_names)) != len(fn.output_names):
        raise ValueError("Duplicate output names")
    return fn
