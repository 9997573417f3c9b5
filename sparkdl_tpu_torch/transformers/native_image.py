"""NativeDeepImageFeaturizer: the second-stack featurizer as a pipeline
stage.

Port of ``sparkdl_tpu.transformers.native_image``, the Scala
``DeepImageFeaturizer``'s analog: rows are decoded by the C++ batch packer
(``native/batchpack.cpp``) and the frozen model, an exported program
directory (:func:`~sparkdl_tpu_torch.native.featurizer.export_featurizer`),
runs through the C++ AOTInductor runner (``native/aoti_runner.cpp``) with
its weights resident on the device. Python only orchestrates partitions.

Each partition's rows go through
:func:`~sparkdl_tpu_torch.transformers.utils.decode_image_batch` at the
program's source size (``always_resize``, ``prefer_uint8``) onto the
stage's device; a batch that had to be resized (float32) is rounded to
uint8 there (the program ingests uint8, as the Scala stack's awt resize
gave uint8), and reaches the runner as a device tensor, never copied back
through the host. Where the JAX package resized on the host before the
rounding, the port resizes on the card. Numerics match
``DeepImageFeaturizer``'s by construction (the program is its forward)
where no resize is needed, and given the same rounded batch where one is.

Nothing falls back: a runner that does not build or load raises, and the
Python stack is never run in its place.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import tempfile
import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.shared import HasDevice, HasInputCol, HasOutputCol
from sparkdl_tpu_torch.transformers.utils import decode_image_batch
from sparkdl_tpu_torch.utils.device import resolve_device
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


class _ClosingLRU:
    """A tiny LRU of programs that closes what it evicts: each cached
    program holds a runner and the model's weights on the device, so an
    eviction releases them, not just the Python reference.

    Safe under threads (stages transform in several at once under
    ``CrossValidator(parallelism=k)``): every access holds the lock, and a
    program is used through :meth:`lease`, which counts its users, so a
    program evicted while another thread still runs it is closed when that
    thread lets it go, never under it."""

    def __init__(self, maxsize: int):
        from collections import OrderedDict

        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._data = OrderedDict()  # key -> [program, users]
        self._evicted = []  # [program, users] of evicted programs still in use

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @contextlib.contextmanager
    def lease(self, key, make):
        """The program under ``key`` (``make()`` builds it on a miss, with
        no lock held), held open until the ``with`` block ends."""
        with self._lock:
            entry = self._data.get(key)
            if entry is not None:
                self._data.move_to_end(key)
                entry[1] += 1
        if entry is None:
            made = make()
            with self._lock:
                entry = self._data.get(key)
                if entry is None:  # else another thread made it first: keep theirs
                    entry = self._data[key] = [made, 0]
                    made = None
                entry[1] += 1
                to_close = self._evict()
            to_close += [made] if made is not None else []
            self._close(to_close)
        try:
            yield entry[0]
        finally:
            with self._lock:
                entry[1] -= 1
                to_close = []
                if entry[1] == 0 and any(e is entry for e in self._evicted):
                    self._evicted = [e for e in self._evicted if e is not entry]
                    to_close = [entry[0]]
            self._close(to_close)

    def _evict(self) -> list:
        """Drop the least recently used entries beyond ``maxsize`` (under the
        lock); returns the programs no thread uses, to close."""
        to_close = []
        while len(self._data) > self.maxsize:
            _, entry = self._data.popitem(last=False)
            if entry[1]:
                self._evicted.append(entry)
            else:
                to_close.append(entry[0])
        return to_close

    @staticmethod
    def _close(programs) -> None:
        for prog in programs:
            try:
                prog.close()
            except Exception:  # a release is best effort; a transform never fails on it
                logger.warning("failed to close an evicted native program", exc_info=True)


# one live NativeProgram (a runner and resident weights) per
# (model, weights key, batch, device)
_PROGRAM_CACHE = _ClosingLRU(2)


def _program_cache_dir() -> str:
    root = os.environ.get(
        "SPARKDL_NATIVE_PROGRAM_CACHE",
        os.path.join(tempfile.gettempdir(), "sparkdl_native_programs"),
    )
    os.makedirs(root, exist_ok=True)
    return root


def uint8_batch(rows: Sequence, source_hw: Tuple[int, int], device) -> torch.Tensor:
    """The stage's device batch of ``rows``: decoded at ``source_hw``
    (``always_resize``, ``prefer_uint8``) onto ``device``, and where that
    resized them (float32), rounded half to even and clipped to uint8
    there, as the JAX package's ``np.rint`` rounds."""
    x = decode_image_batch(rows, source_hw, always_resize=True, prefer_uint8=True,
                           device=device, on_device=True)
    if x.dtype != torch.uint8:
        x = x.round_().clamp_(0, 255).to(torch.uint8)
    return x


class NativeDeepImageFeaturizer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Penultimate-layer CNN features through the native (C++ AOTInductor)
    stack, on ``device`` (``None``: the card). The output contract of
    :class:`~sparkdl_tpu_torch.transformers.named_image.DeepImageFeaturizer`
    (float64 ``DenseVector`` rows, in order); needs a C++ compiler and
    torch's headers for the runner (built at first use)."""

    modelName = Param("undefined", "modelName", "named CNN to featurize with")
    modelWeights = Param(
        "undefined", "modelWeights",
        "'imagenet' (default), 'random', or a weights path, as in "
        "DeepImageFeaturizer",
    )
    batchSize = Param(
        "undefined", "batchSize",
        "fixed device batch (the exported program's static shape)",
    )
    programDir = Param(
        "undefined", "programDir",
        "optional pre-exported program directory (skips export)",
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        batchSize: int = 32,
        programDir: Optional[str] = None,
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(modelWeights=None, batchSize=32, programDir=None, device=None)
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        batchSize: int = 32,
        programDir: Optional[str] = None,
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    # ------------------------------------------------------------------
    def _program_source(self, device: torch.device):
        """The program cache's key of this stage's program on ``device``, and
        the function that loads it (exporting it first where needed)."""
        from sparkdl_tpu_torch.models.registry import get_keras_application_model
        from sparkdl_tpu_torch.native.aoti import NativeProgram
        from sparkdl_tpu_torch.native.featurizer import export_featurizer

        model_name = self.getOrDefault(self.modelName)
        weights = self.getOrDefault(self.modelWeights) or "imagenet"
        batch = int(self.getOrDefault(self.batchSize))
        get_keras_application_model(model_name)  # validate the name early

        explicit = self.getOrDefault(self.programDir)
        if explicit:
            return ((os.path.abspath(explicit), str(device)),
                    lambda: NativeProgram(explicit, device=device))

        if not isinstance(weights, str):
            raise ValueError(
                "NativeDeepImageFeaturizer takes string modelWeights ('imagenet', "
                "'random', or a weights-file path): exported programs are cached on disk "
                "by that key. Pass in-memory weights to DeepImageFeaturizer, or export "
                "them with native.featurizer.export_featurizer and set programDir"
            )
        # the disk cache is keyed by content: a weights file adds its mtime
        # and size, so retraining it in place exports again
        parts = [model_name, f"b{batch}", weights, device.type]
        if os.path.exists(weights):
            st = os.stat(weights)
            parts.append(f"{st.st_mtime_ns}:{st.st_size}")
        digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

        def make():
            d = os.path.join(_program_cache_dir(),
                             f"{model_name}_b{batch}_{device.type}_{digest}")
            logger.info("native featurizer program in %s", d)
            export_featurizer(model_name, batch_size=batch, out_dir=d, model_weights=weights,
                              device=device)
            return NativeProgram(d, device=device)

        return (model_name, weights, batch, str(device), digest), make

    def _transform(self, dataset):
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        device = resolve_device(self.getDevice())
        with _PROGRAM_CACHE.lease(*self._program_source(device)) as prog:
            # the program's static input shape is the truth (an explicit
            # programDir may have been exported at any batch and source size)
            batch, height, width, _ = prog.manifest["inputs"][0]["shape"]

            def process_partition(part):
                rows = part[input_col]
                out = dict(part)
                if not rows:
                    out[output_col] = []
                    return out
                # 'sparkdl.serve' covers decode through fetch, as in the Python
                # stack; 'sparkdl.forward' the runner's part
                with metrics.timer("sparkdl.serve").time():
                    x = uint8_batch(rows, (height, width), device)
                    n = x.shape[0]

                    def chunks():
                        for lo in range(0, n, batch):
                            chunk = x[lo:lo + batch]
                            if chunk.shape[0] < batch:  # the ragged tail repeats its last row
                                chunk = torch.cat(
                                    [chunk, chunk[-1:].expand(batch - chunk.shape[0], -1, -1, -1)])
                            yield chunk

                    feats = []
                    with metrics.timer("sparkdl.forward").time():
                        for i, outs in enumerate(prog.stream(chunks())):
                            feats.append(outs[0][:min(batch, n - i * batch)])
                metrics.counter("sparkdl.rows_processed").add(n)
                metrics.counter("sparkdl.batches_run").add(-(-n // batch))
                flat = np.concatenate(feats).astype(np.float64)
                out[output_col] = [DenseVector(v) for v in flat]
                return out

            return dataset.mapPartitions(process_partition)
