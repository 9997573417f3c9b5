"""TorchFunction: a function and its params, composable and exportable.

Port of ``sparkdl_tpu.graph.function`` (``XlaFunction``, the analog of the
original TF ``TFInputGraph`` / ``GraphFunction``). The holder keeps the JAX
package's surface:

- ``apply(params, *args) -> tuple`` is the canonical call; params ride
  apart from the function and are frozen in only when it is exported;
- constructors: :meth:`TorchFunction.from_callable`, :meth:`from_module`
  (the ``from_flax`` analog, for an ``nn.Module`` and its ``state_dict``),
  :meth:`from_npz`, :meth:`from_checkpoint` and :meth:`from_exported`;
  composition by :meth:`compose` and :meth:`from_list`;
- serialization: :meth:`export` is ``torch.export`` with the batch as a
  symbolic ``Dim`` and the params frozen in as buffers, and :meth:`save` /
  :meth:`load` write and read a ``function.pt2`` beside the JAX package's
  ``manifest.json``.

Differences by design:

- where the JAX package jits onto the default accelerator, a call here
  runs eagerly under ``torch.inference_mode()`` on the card, or on the
  CPU when the caller passes ``device="cpu"``;
- ``from_checkpoint`` reads a params tree that ``torch.save`` wrote (the
  JAX package reads orbax checkpoints);
- a saved program is a ``torch.export`` ``.pt2`` archive, not StableHLO.
  Its constants are kept on the CPU in the file, and a loaded function
  runs its program on the device of its inputs (the card when it has no
  tensor input), moved there once by
  ``torch.export.passes.move_to_device_pass``;
- ``from_keras`` builds the Keras config into a torch module and reads the
  file's weights with the port's own HDF5 reader: neither Keras nor
  ``h5py`` is available to the port. ``from_saved_model`` raises
  ``NotImplementedError``: TensorFlow is not available either.

The port's flash-attention forward is a ``torch.library`` op, so a
function that reaches it exports with the op node in its graph, and its
loaded program launches the CUDA kernel on the card.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch.utils.device import place_params, resolve_device

_PROGRAM = "function.pt2"
_MANIFEST = "manifest.json"


def _as_tuple(x) -> Tuple:
    if isinstance(x, tuple):
        return x
    if isinstance(x, list):
        return tuple(x)
    return (x,)


def _to_tensor(leaf):
    """A numpy array (or scalar) as a tensor sharing its memory where it
    can; tensors and other leaves as they are."""
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


def _tensor_tree(params):
    """``params`` with every numpy leaf turned into a tensor."""
    return pytree.tree_map(_to_tensor, params)


def _torch_dtype(dtype) -> torch.dtype:
    """A spec's dtype (``torch.float32``, ``np.float32`` or ``"float32"``)
    as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _dtype_name(dtype) -> str:
    return str(_torch_dtype(dtype)).removeprefix("torch.")


def _params_device(params) -> torch.device:
    for leaf in pytree.tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class _Frozen(torch.nn.Module):
    """``apply_fn`` with the tensors of ``params`` frozen in as buffers:
    the module that :meth:`TorchFunction.export` traces."""

    def __init__(self, apply_fn: Callable, params):
        super().__init__()
        leaves, self._spec = pytree.tree_flatten(params)
        self._leaves = list(leaves)
        self._slots: List[int] = []
        for i, leaf in enumerate(self._leaves):
            if isinstance(leaf, torch.Tensor):
                self.register_buffer(f"param_{i}", leaf.detach())
                self._slots.append(i)
        self._apply_fn = apply_fn

    def forward(self, *args):
        leaves = list(self._leaves)
        for i in self._slots:
            leaves[i] = getattr(self, f"param_{i}")
        return _as_tuple(self._apply_fn(pytree.tree_unflatten(leaves, self._spec), *args))


class _Method(torch.nn.Module):
    """``module.<method>`` as a module's forward, so that
    ``torch.func.functional_call`` can swap the params in under it."""

    def __init__(self, module: torch.nn.Module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.method)(*args, **kwargs)


class _ExportedRunner:
    """The apply function of a loaded program: runs it on the device of
    its first tensor input (the card when there is none), moving the
    program there once per device."""

    def __init__(self, program):
        self.program = program
        self._modules: Dict[str, torch.nn.Module] = {}

    def __call__(self, params, *args):
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
        if device is None:
            device = resolve_device(None)
        module = self._modules.get(str(device))
        if module is None:
            program = self.program
            if device.type != "cpu":
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, device)
            module = self._modules[str(device)] = program.module()
        # the program was traced on contiguous inputs: a layout op that was
        # a no-op then is not in its graph
        return module(*(a.contiguous() if isinstance(a, torch.Tensor) else a for a in args))


class TorchFunction:
    """A function over tensors and its params.

    ``apply_fn(params, *args)`` returns one tensor or a tuple matching
    ``output_names``. ``params`` is a tree (nested dicts, lists, tuples) of
    tensors; numpy leaves become tensors. ``input_specs`` is a list of
    ``(shape, dtype)`` per input with shape[0] the batch, when known, so
    that :meth:`save` needs no specs from its caller. ``fingerprint`` is a
    durable identity of (function, params) where the constructor can give
    one (a loaded program's sha256), else None."""

    def __init__(
        self,
        apply_fn: Callable,
        params: Any = None,
        input_names: Sequence[str] = ("input",),
        output_names: Sequence[str] = ("output",),
        name: str = "torch_function",
    ):
        self.apply_fn = apply_fn
        self.params = {} if params is None else _tensor_tree(params)
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.name = name
        self.input_specs: Optional[List[Tuple[Tuple[int, ...], Any]]] = None
        self.fingerprint: Optional[str] = None
        self._serialized: Optional[bytes] = None
        # (params, device, params placed there): __call__'s placement of
        # its own params, redone when either changes
        self._placed: Optional[Tuple[Any, torch.device, Any]] = None

    # ------------------------------------------------------------------
    # calling
    # ------------------------------------------------------------------
    def apply(self, params, *args) -> Tuple:
        return _as_tuple(self.apply_fn(params, *args))

    def __call__(self, *args, params=None, device=None):
        """Run the function eagerly under ``torch.inference_mode()`` on
        ``device`` (``None``: the card, which raises without one; pass
        ``"cpu"`` for the CPU), with its own params unless ``params`` is
        given. Inputs and params, numpy or tensors, are put on ``device``
        first (a no-op for tensors already there); the function's own
        params are placed once per device. One output comes back alone,
        several as a tuple."""
        device = resolve_device(device)
        params = self.placed_params(device) if params is None else place_params(params, device)
        args = place_params(args, device)
        with torch.inference_mode():
            out = self.apply(params, *args)
        return out[0] if len(self.output_names) == 1 else out

    def placed_params(self, device=None):
        """The function's own params on ``device`` (``None``: the card),
        placed once per device and kept, so that a stage run again does not
        copy the weights again."""
        device = resolve_device(device)
        placed = self._placed
        if placed is None or placed[0] is not self.params or placed[1] != device:
            placed = self._placed = (self.params, device, place_params(self.params, device))
        return placed[2]

    # ------------------------------------------------------------------
    # composition (the GraphFunction.fromList analog)
    # ------------------------------------------------------------------
    def compose(self, other: "TorchFunction", name: Optional[str] = None) -> "TorchFunction":
        """Feed this function's outputs into ``other``."""
        first, second = self, other

        def chained(params, *args):
            mid = first.apply(params["f0"], *args)
            return second.apply(params["f1"], *mid)

        return TorchFunction(
            chained,
            {"f0": first.params, "f1": second.params},
            first.input_names,
            second.output_names,
            name or f"{first.name}>>{second.name}",
        )

    @classmethod
    def from_list(cls, functions: Sequence["TorchFunction"], name: str = "pipeline"):
        """Pipeline stages: the outputs of stage i feed the inputs of stage
        i+1 positionally."""
        functions = list(functions)
        if not functions:
            raise ValueError("from_list requires at least one function")
        params = {f"f{i}": f.params for i, f in enumerate(functions)}

        def chained(p, *args):
            cur = args
            for i, f in enumerate(functions):
                cur = f.apply(p[f"f{i}"], *cur)
            return cur

        return cls(chained, params, functions[0].input_names,
                   functions[-1].output_names, name)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_callable(
        cls,
        fn: Callable,
        params: Any = None,
        input_names=("input",),
        output_names=("output",),
        name="callable",
        takes_params: bool = False,
    ) -> "TorchFunction":
        """Wrap a callable over tensors. If ``takes_params`` is False,
        ``fn`` has the signature ``fn(*args)`` and the params are empty."""
        if takes_params:
            return cls(fn, params, input_names, output_names, name)
        return cls(lambda p, *args: fn(*args), {}, input_names, output_names, name)

    @classmethod
    def from_module(
        cls,
        module: torch.nn.Module,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        input_names=("input",),
        output_names=("output",),
        name: Optional[str] = None,
        method: Optional[str] = None,
        **kwargs,
    ) -> "TorchFunction":
        """From an ``nn.Module`` and a ``state_dict`` (its own when None):
        ``apply(params, *args)`` is ``module.<method or forward>(*args,
        **kwargs)`` with ``params`` swapped in by
        ``torch.func.functional_call``. The module is put in eval mode."""
        module.eval()
        params = dict(module.state_dict() if state_dict is None else state_dict)
        target = module if method is None else _Method(module, method)
        prefix = "" if method is None else "module."

        def apply_fn(p, *args):
            swapped = {prefix + k: v for k, v in p.items()}
            return torch.func.functional_call(target, swapped, args, kwargs)

        return cls(apply_fn, params, input_names, output_names,
                   name or type(module).__name__)

    @classmethod
    def from_keras(cls, model_or_path, name: Optional[str] = None,
                   compute_dtype: Optional[str] = None) -> "TorchFunction":
        """From a Keras model, or a ``.keras`` / ``.h5`` file, without Keras:
        the config is built into a torch module
        (:class:`~sparkdl_tpu_torch.models.keras_model.KerasModel`) that takes
        NHWC batches as Keras does, its weights read by the port's HDF5
        reader, then :meth:`from_module`.

        ``compute_dtype="bfloat16"`` (or ``"float16"``) runs a file under
        Keras's ``mixed_<dtype>`` policy: every layer computes in that type,
        the variables stay float32. It applies to files only: an in-memory
        model's layers already carry their dtype policy. As in the JAX
        package, the function's ``input_hw`` is the first input's static
        ``(H, W)`` (else None), ``input_specs`` is set when every non-batch
        dimension is static, and a file's fingerprint is
        ``keras:<abspath>:<mtime_ns>:<size>:<dtype>``."""
        from sparkdl_tpu_torch.models.keras_model import (
            KerasModel,
            read_keras_file,
            read_keras_model,
        )

        if compute_dtype == "float32":
            compute_dtype = None  # the saved-model default; a no-op
        if compute_dtype not in (None, "bfloat16", "float16"):
            raise ValueError(
                f"unsupported compute_dtype {compute_dtype!r}; expected "
                "'float32', 'bfloat16', or 'float16'"
            )
        fingerprint = None
        if isinstance(model_or_path, (str, os.PathLike)):
            src = os.path.abspath(os.fspath(model_or_path))
            st = os.stat(src)
            fingerprint = (f"keras:{src}:{st.st_mtime_ns}:{st.st_size}:"
                           f"{compute_dtype or 'float32'}")
            config, weights = read_keras_file(src)
        else:
            if compute_dtype is not None:
                raise ValueError(
                    "compute_dtype applies when loading from a saved file; "
                    "set a keras dtype policy before building in-memory "
                    "models instead"
                )
            config, weights = read_keras_model(model_or_path)
        module = KerasModel(config, weights, compute_dtype=compute_dtype)
        fn = cls.from_module(module, name=name or module.name)
        fn.fingerprint = fingerprint
        # static NHWC spatial input size, when the model declares one:
        # image-serving callers (udf.keras_image_model) resize to it
        shape = module.input_shapes[0] if module.input_shapes else None
        fn.input_hw = (
            (int(shape[1]), int(shape[2]))
            if shape is not None and len(shape) == 4 and shape[1] and shape[2]
            else None
        )
        if shape is not None and all(d is not None for d in shape[1:]):
            fn.input_specs = [((1,) + tuple(int(d) for d in shape[1:]), np.float32)]
        return fn

    @classmethod
    def from_saved_model(cls, path: str, signature: str = "serving_default",
                         input_names=("input",), output_names=("output",),
                         name: Optional[str] = None) -> "TorchFunction":
        raise NotImplementedError(
            "TorchFunction.from_saved_model raises by design: a SavedModel needs "
            "TensorFlow, which the port does not use; load the model with from_keras, "
            "from_checkpoint or from_npz instead"
        )

    @classmethod
    def from_npz(
        cls,
        npz_path: str,
        apply_fn: Callable,
        input_names=("input",),
        output_names=("output",),
        name: Optional[str] = None,
    ) -> "TorchFunction":
        """Params from a ``.npz`` archive: flat ``scope/var`` keys become a
        nested dict of tensors."""
        params: Dict[str, Any] = {}
        with np.load(npz_path) as flat:
            for key in flat.files:
                node = params
                parts = key.split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = torch.from_numpy(flat[key])
        return cls(apply_fn, params, input_names, output_names, name or "npz")

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        apply_fn: Callable,
        input_names=("input",),
        output_names=("output",),
        name: Optional[str] = None,
    ) -> "TorchFunction":
        """Params from a tree of tensors that ``torch.save`` wrote to
        ``path``, read onto the CPU (the JAX package reads an orbax
        checkpoint directory here)."""
        params = torch.load(path, map_location="cpu", weights_only=True)
        return cls(apply_fn, params, input_names, output_names, name or "checkpoint")

    # ------------------------------------------------------------------
    # serialization (the frozen-GraphDef analog)
    # ------------------------------------------------------------------
    def export(self, *input_specs, batch_polymorphic: bool = True) -> bytes:
        """The function with its params frozen in, traced by
        ``torch.export`` and serialized as ``.pt2`` bytes.

        ``input_specs``: per input ``(shape, dtype)`` with shape[0] the
        batch; with ``batch_polymorphic`` the batch is one symbolic ``Dim``
        shared by all inputs (traced at batch 2, so that it does not
        specialize to 1). The trace runs on the params' device (the CPU
        without params); the saved constants are on the CPU."""
        if not input_specs:
            raise ValueError("export needs one (shape, dtype) per input")
        device = _params_device(self.params)
        frozen = _Frozen(self.apply_fn, self.params)
        examples = []
        for shape, dtype in input_specs:
            shape = tuple(int(d) for d in shape)
            if batch_polymorphic:
                shape = (2,) + shape[1:]
            examples.append(torch.zeros(shape, dtype=_torch_dtype(dtype), device=device))
        dynamic = None
        if batch_polymorphic:
            batch = torch.export.Dim("batch")
            dynamic = (tuple({0: batch} for _ in examples),)
        with torch.no_grad():
            program = torch.export.export(frozen, tuple(examples), dynamic_shapes=dynamic)
        if device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, "cpu")
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    def save(self, path: str, *input_specs, **export_kwargs) -> None:
        """Save to a directory: ``function.pt2`` and ``manifest.json``.

        With ``input_specs`` (or, for a function that was not loaded, the
        specs its constructor recorded) the function is exported anew; a
        loaded function writes its program back as it was read."""
        if input_specs:
            blob = self.export(*input_specs, **export_kwargs)
        elif self._serialized is not None:
            blob, input_specs = self._serialized, tuple(self.input_specs or ())
        elif self.input_specs:
            input_specs = tuple(self.input_specs)
            blob = self.export(*input_specs, **export_kwargs)
        else:
            raise ValueError(
                f"TorchFunction {self.name!r} has no recorded input specs; "
                "pass (shape, dtype) per input to save()"
            )
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _PROGRAM), "wb") as fh:
            fh.write(blob)
        manifest = {
            "name": self.name,
            "input_names": self.input_names,
            "output_names": self.output_names,
            "input_specs": [[[int(d) for d in shape], _dtype_name(dtype)]
                            for shape, dtype in input_specs],
        }
        with open(os.path.join(path, _MANIFEST), "w") as fh:
            json.dump(manifest, fh)

    @classmethod
    def load(cls, path: str) -> "TorchFunction":
        with open(os.path.join(path, _MANIFEST)) as fh:
            manifest = json.load(fh)
        with open(os.path.join(path, _PROGRAM), "rb") as fh:
            blob = fh.read()
        fn = cls.from_exported(blob, input_names=manifest["input_names"],
                               output_names=manifest["output_names"],
                               name=manifest["name"])
        fn.input_specs = [(tuple(shape), _torch_dtype(dtype))
                          for shape, dtype in manifest.get("input_specs", [])] or None
        return fn

    @classmethod
    def from_exported(
        cls,
        serialized: bytes,
        input_names=("input",),
        output_names=("output",),
        name: str = "exported",
    ) -> "TorchFunction":
        """Rehydrate a frozen function from ``.pt2`` bytes. Its program runs
        on the device of its inputs; its fingerprint is the bytes' sha256
        (the params are frozen in, so the bytes are the function)."""
        # defines the port's ops, which a saved program may call
        import sparkdl_tpu_torch.ops.flash_attention  # noqa: F401

        program = torch.export.load(io.BytesIO(serialized))
        fn = cls(_ExportedRunner(program), {}, input_names, output_names, name)
        fn._serialized = bytes(serialized)
        fn.fingerprint = f"pt2:{hashlib.sha256(serialized).hexdigest()}"
        return fn

    @property
    def exported_program(self):
        """The ``torch.export.ExportedProgram`` of a loaded function, else
        None."""
        runner = self.apply_fn
        return runner.program if isinstance(runner, _ExportedRunner) else None

    def __repr__(self):
        n_params = len(pytree.tree_leaves(self.params))
        return (
            f"TorchFunction(name={self.name!r}, inputs={self.input_names}, "
            f"outputs={self.output_names}, param_leaves={n_params})"
        )


# The JAX package's name for the composable graph value object.
GraphFunction = TorchFunction
