"""The native second stack: AOTInductor packages run from C++.

Port of ``sparkdl_tpu.native.pjrt``. Where the JAX package exported
StableHLO and ran it on a PJRT plugin from C++, the port exports a function
with ``torch.export``, compiles it ahead of time with
``torch._inductor.aoti_compile_and_package`` for one device, and runs the
package through ``native/aoti_runner.cpp``, a C ABI over
``torch::inductor::AOTIModelPackageLoader``: the parameters are read once
into tensors resident on the device, and batches stream through. Python is
only the orchestration here; ``native/aoti_tool.cpp`` takes it away
entirely (:func:`~sparkdl_tpu_torch.native.featurizer.build_tool`).

A program directory, written by :func:`export_program`:

    program.pt2     the AOTInductor package, the parameter leaves as its
                    leading inputs
    params.bin      the parameter leaves' raw little-endian bytes
    manifest.json   the device, and the dtype and shape of each parameter,
                    input and output (the JAX package's fields and dtype
                    names: ``f32``, ``bf16``, ``u8``, ...)
    manifest.txt    the same as plain lines, for the C++ side

The runner library is built at first use, as the batch packer is
(:mod:`sparkdl_tpu_torch.native`): ``$CXX`` (default ``g++``) against the
headers and libraries of the running torch
(``torch.utils.cpp_extension.include_paths`` and ``library_paths``, with
torch's C++ ABI flag and an rpath to ``torch/lib``; on a CUDA build of
torch also ``libtorch_cuda`` and ``libc10_cuda``), into ``native/_build/``
under a name that hashes the source, the compiler, the flags and
``torch.__version__``, through a process-unique temporary file renamed
into place. One thread builds while the others wait on an event. Unlike the
batch packer nothing falls back: a runner that does not build or load
raises, with the compiler's message. ``SPARKDL_NO_NATIVE`` does not touch
it (that switch is the batch packer's).

A package runs only on the device type it was compiled for: the runner
refuses another and says so. The flash-attention op
(``sparkdl_tpu_torch::flash_attention_fwd``) is registered from Python, so a
package that calls it runs in a Python process that imported the port
(:class:`NativeProgram`), and ``aoti_tool`` fails on it with the op's name.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch import native
from sparkdl_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_SRC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "aoti_runner.cpp")
_ABI_VERSION = 1

#: the manifest's dtype names, the JAX package's
DTYPE_NAMES = {
    torch.float32: "f32",
    torch.float64: "f64",
    torch.float16: "f16",
    torch.bfloat16: "bf16",
    torch.uint8: "u8",
    torch.int8: "s8",
    torch.int16: "s16",
    torch.int32: "s32",
    torch.int64: "s64",
    torch.bool: "pred",
}
_DTYPES = {name: dtype for dtype, name in DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype for the native runner: {dtype}") from None


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def torch_link_flags() -> List[str]:
    """The flags that compile and link C++ against the running torch: its
    headers, its C++ ABI, its libraries with an rpath to them, and on a CUDA
    build of torch its CUDA libraries (kept however few of their symbols
    the code names: they register the card's stream and event
    implementations)."""
    from torch.utils import cpp_extension

    flags = ["-std=c++17", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    libs = cpp_extension.library_paths()
    flags += [f"-L{p}" for p in libs] + [f"-Wl,-rpath,{p}" for p in libs]
    flags += ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda is not None and any(
            os.path.exists(os.path.join(p, "libtorch_cuda.so")) for p in libs):
        flags += ["-ltorch_cuda", "-lc10_cuda"]
    return flags + ["-Wl,--as-needed"]


def _runner_flags() -> List[str]:
    return ["-O2", "-fPIC", "-shared", *torch_link_flags()]


_runner = native.Once()


def library_path() -> str:
    """Where the build of the runner for the running torch lies."""
    return native.build_path("aoti_runner", [_SRC_PATH], _runner_flags(),
                             extra=[torch.__version__])


def _load() -> ctypes.CDLL:
    """The runner library, built and loaded at most once a process
    (:class:`~sparkdl_tpu_torch.native.Once`: the compiler and the ``dlopen``
    run with no lock held). Raises ``RuntimeError`` where it did not build or
    load, now and at every later call."""
    return _runner.get(_resolve)


def _resolve() -> ctypes.CDLL:
    try:
        path = native.build([_SRC_PATH], _runner_flags(), library_path())
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the native AOTInductor runner is unavailable: {e}") from e
    if lib.aoti_abi_version() != _ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {lib.aoti_abi_version()}, not {_ABI_VERSION}")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    signatures = {
        "aoti_runner_create": (vp, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, i32]),
        "aoti_runner_last_error": (ctypes.c_char_p, [vp]),
        "aoti_runner_put": (i64, [vp, i32, vp, i32]),
        "aoti_runner_put_async": (i64, [vp, i32, vp, i32]),
        "aoti_runner_await_buffer": (i32, [vp, i64]),
        "aoti_runner_execute": (i32, [vp, ctypes.POINTER(i64), i32, ctypes.POINTER(i64)]),
        "aoti_runner_execute_async": (i32, [vp, ctypes.POINTER(i64), i32, ctypes.POINTER(i64)]),
        "aoti_runner_get": (i32, [vp, i64, vp, i64, i32]),
        "aoti_runner_free_buffer": (i32, [vp, i64]),
        "aoti_runner_live_buffers": (i64, [vp]),
        "aoti_runner_alloc_host": (vp, [vp, i64]),
        "aoti_runner_free_host": (i32, [vp, vp]),
        "aoti_runner_destroy": (None, [vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    logger.info("native AOTInductor runner loaded (%s)", path)
    return lib


def is_available() -> bool:
    """Whether the runner builds and loads here (building it at first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class AotiRunner:
    """One program loaded onto one device, its parameters resident there:
    the ctypes face of ``aoti_runner.cpp``. Buffer ids name tensors the
    runner holds until :meth:`free`.

    Safe under threads: a call and the read of its error hold the runner's
    lock, and :meth:`close` takes it too, so a close waits for a call in
    progress, and a call after it raises ``RuntimeError`` (never a call into
    a destroyed runner)."""

    def __init__(self, program_dir: str, device):
        lib = _load()
        self._lib = lib
        self._mu = threading.Lock()
        self.device = torch.device(device)
        err = ctypes.create_string_buffer(8192)
        self._h = lib.aoti_runner_create(os.fsencode(program_dir), str(self.device).encode(),
                                         err, len(err))
        if not self._h:
            raise RuntimeError(f"aoti_runner_create({program_dir}, {self.device}) failed: "
                               f"{err.value.decode(errors='replace')}")

    def _call(self, what: str, fn, *args):
        """``fn(handle, *args)`` under the lock; a negative or null result
        raises with the runner's error."""
        with self._mu:
            if not self._h:
                raise RuntimeError(f"{what} on a closed runner")
            rc = fn(self._h, *args)
            if rc is None or rc < 0:
                msg = self._lib.aoti_runner_last_error(self._h).decode(errors="replace")
                raise RuntimeError(f"{what} failed: {msg}")
            return rc

    def put(self, index: int, ptr: int, on_device: bool, wait: bool = True) -> int:
        fn = self._lib.aoti_runner_put if wait else self._lib.aoti_runner_put_async
        return self._call("put", fn, index, ptr, int(on_device))

    def await_buffer(self, buf_id: int) -> None:
        self._call("await_buffer", self._lib.aoti_runner_await_buffer, buf_id)

    def execute(self, buf_ids: Sequence[int], n_outputs: int, wait: bool = True) -> List[int]:
        fn = self._lib.aoti_runner_execute if wait else self._lib.aoti_runner_execute_async
        ids = (ctypes.c_int64 * max(len(buf_ids), 1))(*buf_ids)
        outs = (ctypes.c_int64 * max(n_outputs, 1))()
        got = self._call("execute", fn, ids, len(buf_ids), outs)
        return [int(outs[i]) for i in range(got)]

    def get(self, buf_id: int, out: torch.Tensor) -> torch.Tensor:
        """Copy buffer ``buf_id`` into the contiguous tensor ``out``."""
        self._call("get", self._lib.aoti_runner_get, buf_id, out.data_ptr(),
                   out.numel() * out.element_size(), int(out.device.type != "cpu"))
        return out

    def free(self, buf_id: int) -> None:
        self._call("free", self._lib.aoti_runner_free_buffer, buf_id)

    def alloc_host(self, nbytes: int) -> int:
        return self._call("alloc_host", self._lib.aoti_runner_alloc_host, nbytes)

    def free_host(self, ptr: int) -> None:
        self._call("free_host", self._lib.aoti_runner_free_host, ptr)

    @property
    def live_buffers(self) -> int:
        return self._call("live_buffers", self._lib.aoti_runner_live_buffers)

    def close(self) -> None:
        mu = getattr(self, "_mu", None)
        if mu is None:  # __init__ failed before the handle
            return
        with mu:
            if self._h:
                self._lib.aoti_runner_destroy(self._h)
                self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class _Flat(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _spec(t, name: Optional[str] = None) -> dict:
    spec = {"dtype": dtype_name(t.dtype), "shape": [int(d) for d in t.shape]}
    return spec if name is None else {"name": name, **spec}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def export_program(
    fn: Callable,
    params: Any,
    example_inputs: Sequence[Any],
    out_dir: str,
    input_names: Optional[Sequence[str]] = None,
    device=None,
) -> dict:
    """Export ``fn(params, *inputs)`` for the native runner, compiled for
    ``device`` (``None``: the card).

    ``params`` is a pytree of tensors (a ``state_dict``, say). The program
    is ``torch.export`` of ``flat_fn(*param_leaves, *inputs)``, **the leaves
    as its leading inputs**, as in the JAX package: the runner reads
    ``params.bin`` once and keeps them resident, where constants would be
    copied into every package. Every leaf and example is made contiguous on
    ``device``, the layout the runner gives them. Returns the manifest (also
    written to ``manifest.json``)."""
    device = resolve_device(device)
    leaves, treedef = pytree.tree_flatten(params)
    leaves = [_as_tensor(leaf).detach().to(device).contiguous() for leaf in leaves]
    examples = [_as_tensor(x).to(device).contiguous() for x in example_inputs]
    n = len(leaves)

    def flat_fn(*args):
        out = fn(pytree.tree_unflatten(list(args[:n]), treedef), *args[n:])
        return tuple(pytree.tree_leaves(out))

    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        program = torch.export.export(_Flat(flat_fn), tuple(leaves + examples))
    (output_node,) = program.graph.find_nodes(op="output")
    outputs = [node.meta["val"] for node in output_node.args[0]]
    torch._inductor.aoti_compile_and_package(
        program, package_path=os.path.join(out_dir, "program.pt2"))
    with open(os.path.join(out_dir, "params.bin"), "wb") as fh:
        for leaf in leaves:
            fh.write(leaf.cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    manifest = {
        "device": device.type,
        "torch": torch.__version__,
        "params": [_spec(leaf) for leaf in leaves],
        "inputs": [_spec(x, input_names[i] if input_names else f"input_{i}")
                   for i, x in enumerate(examples)],
        "outputs": [_spec(t) for t in outputs],
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    # the plain-text twin for the C++ side (no JSON parser there)
    with open(os.path.join(out_dir, "manifest.txt"), "w") as fh:
        fh.write(f"device {device.type}\n")
        for kind in ("params", "inputs", "outputs"):
            for spec in manifest[kind]:
                dims = ",".join(str(d) for d in spec["shape"]) or "scalar"
                fh.write(f"{kind[:-1]} {spec['dtype']} {dims}\n")
    return manifest


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class NativeProgram:
    """An exported program directory loaded onto ``device`` (``None``: the
    card): the in-process counterpart of ``aoti_tool``. The parameters are
    read once into resident tensors; :meth:`__call__` runs one batch and
    :meth:`stream` a sequence of them, double-buffered. Inputs are numpy
    arrays or tensors, on the host or on the program's device; outputs come
    back as numpy arrays (a bf16 output as a CPU tensor, which numpy cannot
    hold)."""

    def __init__(self, program_dir: str, device=None):
        with open(os.path.join(program_dir, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        self.device = resolve_device(device)
        self.runner = AotiRunner(program_dir, self.device)
        self._in_specs = [(_DTYPES[s["dtype"]], tuple(s["shape"]), s["name"])
                          for s in self.manifest["inputs"]]
        self._out_specs = [(_DTYPES[s["dtype"]], tuple(s["shape"]))
                           for s in self.manifest["outputs"]]

    def _tensors(self, inputs) -> Tuple[torch.Tensor, ...]:
        """The inputs as contiguous tensors of the manifest's dtypes and
        shapes; ``ValueError`` on a wrong count or shape."""
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        if len(inputs) != len(self._in_specs):
            raise ValueError(f"program takes {len(self._in_specs)} inputs, got {len(inputs)}")
        out = []
        for x, (dtype, shape, name) in zip(inputs, self._in_specs):
            x = _as_tensor(x)
            if tuple(x.shape) != shape:
                raise ValueError(f"input {name} expects shape {list(shape)}, got {list(x.shape)}")
            if x.device.type not in ("cpu", self.device.type):
                raise ValueError(f"input {name} lies on {x.device}; the program runs on "
                                 f"{self.device}")
            out.append(x.to(dtype).contiguous())
        return tuple(out)

    def _fetch(self, out_ids: Sequence[int]) -> List[Any]:
        outs = []
        for buf_id, (dtype, shape) in zip(out_ids, self._out_specs):
            host = self.runner.get(buf_id, torch.empty(shape, dtype=dtype))
            outs.append(host if dtype == torch.bfloat16 else host.numpy())
        return outs

    def _on_device(self, x: torch.Tensor) -> bool:
        return x.device.type != "cpu"

    def __call__(self, *inputs) -> List[Any]:
        xs = self._tensors(inputs)
        ids: List[int] = []
        out_ids: List[int] = []
        try:
            for i, x in enumerate(xs):
                ids.append(self.runner.put(i, x.data_ptr(), self._on_device(x)))
            out_ids = self.runner.execute(ids, len(self._out_specs))
            return self._fetch(out_ids)
        finally:
            for buf_id in ids + out_ids:
                self.runner.free(buf_id)

    def stream(self, batches):
        """Double-buffered batches (a generator): batch i+1's copy in and
        run are enqueued on the runner's stream before batch i's outputs
        are fetched (on the fetch stream), so the copies and runs of
        consecutive batches overlap. Yields one output list a batch, in
        order. ``batches`` yields one input (or a tuple of them) a step.

        On the card a host batch goes through one of two page-locked
        staging buffers a input; a buffer is refilled only after the copy
        that last read it has completed (the rule of
        :class:`~sparkdl_tpu_torch.engine.executor.PinnedStaging`). An
        abandoned generator frees its batch in flight and its staging
        buffers."""
        runner = self.runner
        staged = self.device.type != "cpu"
        # per input, two slots of [pointer, id of the buffer last copied from it]
        slots: List[List[List[Optional[int]]]] = [[[None, None], [None, None]]
                                                  for _ in self._in_specs]
        live = set()  # the ids this generator holds
        pending = None  # (input ids, output ids, the inputs held alive)

        def put(i: int, x: torch.Tensor, step: int) -> int:
            if not staged or self._on_device(x):
                return runner.put(i, x.data_ptr(), self._on_device(x), wait=not staged)
            slot = slots[i][step % 2]
            if slot[0] is None:
                slot[0] = runner.alloc_host(x.numel() * x.element_size())
            elif slot[1] is not None and slot[1] in live:
                runner.await_buffer(slot[1])
            ctypes.memmove(slot[0], x.data_ptr(), x.numel() * x.element_size())
            slot[1] = runner.put(i, slot[0], False, wait=False)
            return slot[1]

        def release(ids):
            for buf_id in ids:
                runner.free(buf_id)
                live.discard(buf_id)

        def fetch(entry):
            ids, out_ids, _ = entry
            try:
                return self._fetch(out_ids)
            finally:
                release(ids + out_ids)

        try:
            for step, inputs in enumerate(batches):
                xs = self._tensors(inputs)
                ids: List[int] = []
                try:
                    for i, x in enumerate(xs):
                        ids.append(put(i, x, step))
                        live.add(ids[-1])
                    out_ids = runner.execute(ids, len(self._out_specs), wait=not staged)
                except BaseException:
                    release(ids)  # this batch's; the one pending is freed below
                    raise
                live.update(out_ids)
                prev, pending = pending, (ids, out_ids, xs)
                if prev is not None:
                    yield fetch(prev)
            if pending is not None:
                prev, pending = pending, None
                yield fetch(prev)
        finally:
            if pending is not None:  # the consumer abandoned the generator
                release(pending[0] + pending[1])
            for per_input in slots:
                for ptr, _ in per_input:
                    if ptr is not None:
                        runner.free_host(ptr)

    @property
    def live_buffers(self) -> int:
        """The buffers the runner holds: 0 between calls."""
        return self.runner.live_buffers

    def close(self) -> None:
        self.runner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
