"""The batched inference loop of the port's transformers, and the image
decode and resize in front of it.

Ports of ``sparkdl_tpu.transformers.utils``:

- ``make_loader_decode_plan``, ``run_batched_rows``, ``run_batched_multi``
  and ``run_batched``. The JAX loops padded the ragged last chunk to
  ``batch_size`` so that XLA compiled one static shape; PyTorch runs
  eagerly, so the last chunk runs at its own size and every row still
  comes back once, in input order. All of them run through one loop
  (:func:`_run_chunks`): a depth-N dispatch window
  (:mod:`sparkdl_tpu_torch.engine.executor`, ``SPARKDL_DISPATCH_DEPTH``),
  pinned input buffers on the card, and for ``run_batched_rows`` a
  two-chunk decode prefetch (:mod:`sparkdl_tpu_torch.data`);
  ``SPARKDL_SERIAL_INFERENCE=1`` turns the overlaps off;
- ``decode_image_batch`` and ``make_image_decode_plan``: uint8 rows of one
  size pack as uint8 at source size, anything else packs as float32,
  resized where the sizes are mixed; ``n_channels=1`` gives ITU-R 601
  luminance and ``to_rgb`` flips the stored BGR order. The packing runs in
  the C++ batch packer (:mod:`sparkdl_tpu_torch.native`,
  ``native/batchpack.cpp``) where it is built, else in numpy, with the same
  bytes. Mixed sizes pack each shape group at its source size and resize
  it on the device (:func:`device_resize`), where the JAX package resizes
  in the C++ packer;
- ``normalize_channels``, ``place_params``, ``make_input_prologue`` and
  ``load_keras_function``; ``pad_to_batch``, ``shape_bucket`` and
  ``bucket_ladder``, the padded serving ladder's;
- ``device_resize`` and ``cast_and_resize_on_device``. The resize is
  ``jax.image.resize(..., "bilinear")``'s: half-pixel centers, a triangle
  kernel widened by the downscale factor (antialiasing), weights
  renormalised per output cell. :func:`resize_weights` builds its two
  weight matrices in numpy, as ``jax._src.image.scale.compute_weight_mat``
  does, and :func:`resize_bilinear` applies them as two matrix products on
  the batch's device. Shape groups always resize on the device: with no
  compile per shape there is no host fallback to take.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch import native
from sparkdl_tpu_torch.data.dataset import Dataset
from sparkdl_tpu_torch.engine.executor import DispatchWindow, PinnedStaging
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.utils.device import place_params, resolve_device  # noqa: F401
from sparkdl_tpu_torch.utils.lru import LRUCache
from sparkdl_tpu_torch.utils.metrics import metrics

DEFAULT_BATCH_SIZE = 32

#: image-struct modes whose pixel data is uint8 (CV_8UC1/3/4)
_U8_MODES = frozenset({0, 16, 24})


class MixedImageSizesError(ValueError):
    """A partition mixes (H, W) shapes and no target size is configured."""


def normalize_channels(img: np.ndarray, n_channels: int = 3) -> np.ndarray:
    """Coerce an HWC array to ``n_channels`` (3: replicate gray, drop alpha;
    1: ITU-R 601 luminance of the stored BGR order) so a partition with
    mixed image modes still forms one batch."""
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[-1]
    if c == n_channels:
        return img
    if n_channels == 3:
        if c == 1:
            return np.repeat(img, 3, axis=-1)
        if c == 4:
            return img[:, :, :3]
    if n_channels == 1 and c >= 3:
        return (
            0.114 * img[:, :, :1] + 0.587 * img[:, :, 1:2] + 0.299 * img[:, :, 2:3]
        ).astype(img.dtype)
    raise ValueError(f"Cannot convert image with {c} channels to {n_channels} channels")


@functools.lru_cache(maxsize=32)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The ``(in_size, out_size)`` float32 weights of
    ``jax.image.resize(method="bilinear", antialias=True)`` along one axis
    (scale ``out_size / in_size``, no translation). Read-only."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    weights = np.maximum(np.float32(0), np.float32(1) - x / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    keep = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(keep, weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, 0).astype(np.float32)
    weights.setflags(write=False)
    return weights


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize a float NHWC batch to ``size`` on its own device, as
    ``jax.image.resize(x, (n, h, w, c), "bilinear")``: one matrix product per
    axis whose size changes. The result is contiguous NHWC, the layout an
    exported program was traced with."""
    height, width = int(size[0]), int(size[1])
    if x.shape[1] != height:
        w = torch.tensor(resize_weights(x.shape[1], height), dtype=x.dtype, device=x.device)
        x = torch.einsum("nhwc,hk->nkwc", x, w)
    if x.shape[2] != width:
        w = torch.tensor(resize_weights(x.shape[2], width), dtype=x.dtype, device=x.device)
        x = torch.einsum("nhwc,wk->nhkc", x, w)
    return x.contiguous()


def device_resize(
    images: Sequence[np.ndarray], size: Tuple[int, int], device=None, on_device: bool = False
):
    """Resize a list of HWC float arrays to ``size`` and stack them; images
    of one source shape resize together on ``device`` (``None``: the card),
    images already at ``size`` pass through. ``on_device`` returns the
    stack as a tensor on ``device``, the resized groups never copied back to
    the host. Advances the ``sparkdl.resize`` timer."""
    device = resolve_device(device)
    height, width = int(size[0]), int(size[1])
    with metrics.timer("sparkdl.resize").time():
        out: List[Optional[np.ndarray]] = [None] * len(images)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, img in enumerate(images):
            groups.setdefault(tuple(img.shape), []).append(i)
        stacked = None
        for shape, idxs in groups.items():
            batch = np.stack([np.asarray(images[i], dtype=np.float32) for i in idxs])
            if on_device:
                batch = torch.from_numpy(batch).to(device)
                if shape[:2] != (height, width):
                    batch = resize_bilinear(batch, (height, width))
                if stacked is None:
                    stacked = batch.new_empty((len(images), *batch.shape[1:]))
                stacked[torch.tensor(idxs, device=device)] = batch
                continue
            if shape[:2] != (height, width):
                batch = resize_bilinear(
                    torch.from_numpy(batch).to(device), (height, width)
                ).cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = batch[j]
        return stacked if on_device else np.stack(out)


def _packs_as_uint8(rows: Sequence, n_channels: int) -> bool:
    """Whether ``rows`` pack to ``n_channels`` as uint8 without a change of
    value: uint8 rows, and in one channel only one-channel rows (luminance
    is not a uint8)."""
    return (all(int(r["mode"]) in _U8_MODES for r in rows)
            and (n_channels == 3
                 or (n_channels == 1 and all(int(r["nChannels"]) == 1 for r in rows))))


def _native_pack(rows: Sequence, n_channels: int, to_rgb: bool) -> Optional[List[np.ndarray]]:
    """Each row decoded at its source size to float32 by the C++ packer,
    one call per shape group; None where the packer is off or refuses a
    row (the numpy path then packs, or raises the canonical error)."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault((int(r["height"]), int(r["width"])), []).append(i)
    images: List[Optional[np.ndarray]] = [None] * len(rows)
    for hw, idxs in groups.items():
        try:
            batch = native.pack_image_rows([rows[i] for i in idxs], hw, n_channels,
                                           bgr_to_rgb=to_rgb)
        except ValueError:
            return None  # a channel conversion the packer does not do
        if batch is None:
            return None
        for j, i in enumerate(idxs):
            images[i] = batch[j]
    return images


def decode_image_batch(
    rows: Sequence,
    target_hw: Optional[Tuple[int, int]] = None,
    always_resize: bool = False,
    prefer_uint8: bool = False,
    device=None,
    n_channels: int = 3,
    to_rgb: bool = False,
    on_device: bool = False,
):
    """Decode image-struct Rows into one NHWC batch of ``n_channels``
    (:func:`normalize_channels`), in stored (BGR) channel order unless
    ``to_rgb``.

    Rows of one (H, W) pack at source size (the caller's forward resizes);
    with ``prefer_uint8`` and uint8 rows they pack as uint8, a quarter of
    the bytes to the card (in one channel only from one-channel rows).
    Everything else packs as float32; mixed sizes (or ``always_resize``)
    resized to ``target_hw`` on ``device`` (``None``: the card);
    ``target_hw=None`` requires one size. The C++ packer packs where it is
    built and on (:func:`native.is_available`), numpy where not, with the
    same bytes. ``on_device`` returns the batch as a tensor on ``device``
    (the card's resize output stays there).
    Advances ``sparkdl.decode``."""
    hws = {(int(r["height"]), int(r["width"])) for r in rows}
    uniform = len(hws) == 1
    source_hw = next(iter(hws)) if uniform else None
    if not uniform and target_hw is None:
        raise MixedImageSizesError(
            f"partition mixes image sizes {sorted(hws)} and no target size "
            "is configured; resize upstream or set an input size"
        )
    if uniform and not (always_resize and target_hw is not None):
        out_hw = source_hw
    else:
        out_hw = (int(target_hw[0]), int(target_hw[1]))
    metrics.counter("sparkdl.images_processed").add(len(rows))

    if prefer_uint8 and out_hw == source_hw and _packs_as_uint8(rows, n_channels):
        with metrics.timer("sparkdl.decode").time():
            batch = native.pack_image_rows_u8(rows, out_hw, n_channels, bgr_to_rgb=to_rgb)
            if batch is None:
                images = [normalize_channels(imageIO.imageStructToArray(r), n_channels)
                          for r in rows]
                if to_rgb and n_channels == 3:
                    images = [img[..., ::-1] for img in images]
                batch = np.stack(images)
        return torch.from_numpy(batch).to(resolve_device(device)) if on_device else batch

    with metrics.timer("sparkdl.decode").time():
        images = _native_pack(rows, n_channels, to_rgb)
        if images is None:
            images = [
                normalize_channels(imageIO.imageStructToArray(r).astype(np.float32),
                                   n_channels)
                for r in rows
            ]
            if to_rgb and n_channels >= 3:
                images = [img[..., ::-1] for img in images]
    # a pure pack where every row is at out_hw; each other shape group
    # resizes on the device
    return device_resize(images, out_hw, device, on_device=on_device)


def make_image_decode_plan(
    rows: Sequence,
    size: Optional[Tuple[int, int]],
    device=None,
    n_channels: int = 3,
    to_rgb: bool = False,
) -> Callable[[Sequence], np.ndarray]:
    """One decode policy for a whole partition, for :func:`run_batched_rows`.

    Pack at source size or resize while packing, uint8 or float32: decided
    over ALL rows, so no two chunks of one partition reach the forward in
    two dtypes or shapes. Raises :class:`MixedImageSizesError` when the
    partition mixes sizes and ``size`` is None. ``device=None`` resizes
    on the card; ``n_channels`` and ``to_rgb`` as
    :func:`decode_image_batch` takes them."""
    device = resolve_device(device)
    hws = {(int(r["height"]), int(r["width"])) for r in rows}
    uniform = len(hws) == 1
    if not uniform and size is None:
        raise MixedImageSizesError(
            f"partition mixes image sizes {sorted(hws)} and no target size "
            "is configured; resize upstream or set an input size"
        )
    prefer_u8 = uniform and _packs_as_uint8(rows, n_channels)

    def decode(chunk):
        return decode_image_batch(
            chunk, size, prefer_uint8=prefer_u8, always_resize=not uniform,
            device=device, n_channels=n_channels, to_rgb=to_rgb,
        )

    return decode


def pad_to_batch(batch: np.ndarray, batch_size: int) -> np.ndarray:
    """``batch``'s leading dim padded up to ``batch_size`` by repeating the
    last row (the caller slices the pad rows off). A real row, not zeros,
    keeps the pad inert for row-independent forwards without feeding the
    model values it never sees."""
    k = batch.shape[0]
    if k >= batch_size:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], batch_size - k, axis=0)], axis=0)


def shape_bucket(n: int, max_batch: int) -> int:
    """The padded leading dim of an ``n``-row batch: the smallest power of
    two at least ``n``, capped at ``max_batch`` (always its own bucket,
    power of two or not)."""
    if n <= 0:
        raise ValueError(f"shape_bucket requires n >= 1, got {n}")
    if n >= max_batch:
        return int(max_batch)
    return min(1 << (int(n) - 1).bit_length(), int(max_batch))


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """Every bucket :func:`shape_bucket` gives for ``max_batch``: the
    program set a padded serving endpoint compiles at warmup, so that no
    request shape compiles at request time."""
    if max_batch <= 0:
        raise ValueError(f"bucket_ladder requires max_batch >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(int(max_batch))
    return tuple(out)


def cast_and_resize_on_device(
    x: torch.Tensor, size: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """The device half of :func:`decode_image_batch`: cast an NHWC batch
    (uint8 ingest) to float32 and resize it to ``size`` when it arrived at
    source size."""
    x = x.float()
    if size is not None and tuple(x.shape[1:3]) != (int(size[0]), int(size[1])):
        x = resize_bilinear(x, size)
    return x


def make_input_prologue(
    size: Optional[Tuple[int, int]] = None,
    preprocess: Optional[Callable] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The input prologue of a forward as one callable: cast (uint8
    ingest), bilinear resize to ``size`` where the batch is at another size,
    then ``preprocess`` (such as a registry entry's ``preprocess_input``).
    ``preprocess`` must keep rows apart: row i of its output depends only
    on row i of its input."""

    def prologue(x: torch.Tensor) -> torch.Tensor:
        x = cast_and_resize_on_device(x, size)
        if preprocess is not None:
            x = preprocess(x)
        return x

    return prologue


def make_loader_decode_plan(
    load_one: Callable, what: str = "imageLoader"
) -> Callable[[Sequence], np.ndarray]:
    """Chunked decode plan for user-loader inputs (``load_one(uri) ->
    ndarray``), for :func:`run_batched_rows`.

    Enforces the one-fixed-shape loader contract ACROSS chunks (the first
    chunk's shape binds the partition), so a chunk-aligned shape change
    still raises the contract error instead of a raw concatenate failure.
    Advances the ``sparkdl.load`` timer and the images counter.
    """
    expected_shape: List[Optional[Tuple[int, ...]]] = [None]

    def decode(chunk):
        with metrics.timer("sparkdl.load").time():
            arrays = [
                np.asarray(load_one(v), dtype=np.float32) for v in chunk
            ]
        metrics.counter("sparkdl.images_processed").add(len(arrays))
        shapes = {a.shape for a in arrays}
        if expected_shape[0] is not None:
            shapes.add(expected_shape[0])
        if len(shapes) > 1:
            raise ValueError(
                f"{what} must produce one fixed array shape per image; "
                f"this partition mixes {sorted(shapes)} — resize inside "
                f"the {what}"
            )
        expected_shape[0] = arrays[0].shape
        return np.stack(arrays)

    return decode


def _serial_inference() -> bool:
    """The kill switch of the pipelined loop: ``SPARKDL_SERIAL_INFERENCE=1``
    (or true, yes, on) decodes each chunk inline and fetches each result
    right after its launch (dispatch window depth 0)."""
    return os.environ.get("SPARKDL_SERIAL_INFERENCE", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


def _single_output(result) -> torch.Tensor:
    """The one tensor :func:`run_batched_rows` fetches."""
    if isinstance(result, (tuple, list)):
        raise TypeError(
            "run_batched_rows requires a single-output fn "
            f"(got {len(result)} outputs); unwrap the output in the forward, "
            "or use run_batched_multi"
        )
    return result


def _outputs(result) -> Tuple[torch.Tensor, ...]:
    """A forward's output as a tuple of tensors; bfloat16, which numpy
    cannot hold, widened (exactly) to float32 where it lies."""
    result = tuple(result) if isinstance(result, (tuple, list)) else (result,)
    return tuple(y.float() if y.dtype == torch.bfloat16 else y for y in result)


def _run_chunks(
    fn: Callable,
    chunks: Iterator[Tuple[np.ndarray, ...]],
    device: torch.device,
    forward_timer,
    serial: bool,
) -> List[List[np.ndarray]]:
    """``fn(*inputs)`` over host chunks (tuples of row-aligned arrays) on
    ``device``, through a :class:`DispatchWindow` (depth 0 when ``serial``,
    else ``SPARKDL_DISPATCH_DEPTH``); on CUDA each chunk goes to the card
    through :class:`PinnedStaging`. Returns, per output, the host arrays of
    every chunk, in order."""
    collected: List[List[np.ndarray]] = []

    def collect(pairs) -> None:
        for host, _ in pairs:
            if not collected:
                collected.extend([] for _ in host)
            for acc, y in zip(collected, host):
                acc.append(y)

    window = DispatchWindow(depth=0 if serial else None)
    cuda = device.type == "cuda"
    try:
        with torch.cuda.device(device) if cuda else contextlib.nullcontext():
            staging = PinnedStaging(device, slots=window.depth + 1) if cuda else None
            for arrays in chunks:
                with forward_timer.time():
                    if cuda:
                        xs = staging.place(arrays)
                    else:
                        xs = tuple(torch.from_numpy(a) for a in arrays)
                    ys = _outputs(fn(*xs))
                    collect(window.submit(ys, meta=arrays[0].shape[0]))
            with forward_timer.time():
                collect(window.drain())
    finally:
        window.abandon()
    return collected


def run_batched_rows(
    fn: Callable[[torch.Tensor], torch.Tensor],
    rows: Sequence,
    decode: Callable[[Sequence], np.ndarray],
    batch_size: int = DEFAULT_BATCH_SIZE,
    device: "torch.device | str" = "cuda",
) -> np.ndarray:
    """Decode + forward pipeline over row chunks of ``batch_size`` rows.

    - the decode is a :mod:`sparkdl_tpu_torch.data` pipeline,
      ``from_items(chunk bounds) -> map(decode) -> prefetch(2)``: up to two
      chunks decode on a background thread (``sparkdl-decode``) while the
      card runs, and closing the loop (at its end or on an error) joins it;
    - the results ride a depth-N :class:`DispatchWindow`
      (``SPARKDL_DISPATCH_DEPTH``, default 2): each chunk's device-to-host
      copy starts at once into a pinned buffer, and the host reads it N
      chunks later;
    - on CUDA each chunk goes to the card through pinned input buffers with
      ``non_blocking`` copies (:class:`PinnedStaging`).

    ``SPARKDL_SERIAL_INFERENCE=1`` turns both overlaps off: each chunk
    decodes inline and each result is fetched after its launch.
    ``decode(chunk_rows) -> np.ndarray`` must be row-aligned with ``rows``;
    ``fn`` takes the batch on ``device`` and returns one tensor. Returns the
    outputs of all rows, in order, as one host array.
    """
    device = torch.device(device)
    n = len(rows)
    if n == 0:
        raise ValueError("run_batched_rows requires non-empty rows")
    bounds = [(lo, min(lo + batch_size, n)) for lo in range(0, n, batch_size)]
    serial = _serial_inference()

    def decode_chunk(bound: Tuple[int, int]) -> Tuple[np.ndarray]:
        lo, hi = bound
        batch = decode(rows[lo:hi])
        if batch.shape[0] != hi - lo:
            raise ValueError(
                f"decode returned {batch.shape[0]} rows for a chunk of "
                f"{hi - lo}; it must be row-aligned with its input"
            )
        return (batch,)

    if serial:
        chunks = (decode_chunk(b) for b in bounds)
    else:
        # prefetch(2) holds at most two decoded chunks ahead of the loop
        chunks = iter(Dataset.from_items(bounds, name="chunk_bounds")
                      .map(decode_chunk).prefetch(2, name="sparkdl-decode"))
    # 'sparkdl.forward' times dispatch + fetch; 'sparkdl.serve' the whole
    # loop, load waits included (the rate images_per_sec() reports)
    serve_timer = metrics.timer("sparkdl.serve")
    forward_timer = metrics.timer("sparkdl.forward")
    try:
        with serve_timer.time():
            collected = _run_chunks(lambda x: _single_output(fn(x)), chunks,
                                    device, forward_timer, serial)
    finally:
        chunks.close()
    metrics.counter("sparkdl.rows_processed").add(n)
    metrics.counter("sparkdl.batches_run").add(len(bounds))
    return np.concatenate(collected[0], axis=0)


def run_batched_multi(
    fn: Callable,
    arrays: Sequence[np.ndarray],
    batch_size: int = DEFAULT_BATCH_SIZE,
    device: "torch.device | str" = "cuda",
) -> Tuple[np.ndarray, ...]:
    """``fn(*inputs)`` over row-aligned host arrays in chunks of
    ``batch_size`` rows on ``device``, through the dispatch window and the
    pinned staging of :func:`run_batched_rows` (depth 0 under
    ``SPARKDL_SERIAL_INFERENCE=1``). ``fn`` takes one tensor per array and
    returns one tensor or a tuple. Returns one host array per output, all
    rows in order."""
    device = torch.device(device)
    n = arrays[0].shape[0] if len(arrays) else 0
    if n == 0:
        raise ValueError("run_batched requires non-empty inputs")
    bounds = [(lo, min(lo + batch_size, n)) for lo in range(0, n, batch_size)]
    # the inputs come decoded, so the loop is all dispatch + fetch
    serve_timer = metrics.timer("sparkdl.serve")
    forward_timer = metrics.timer("sparkdl.forward")
    with serve_timer.time():
        chunks = (tuple(a[lo:hi] for a in arrays) for lo, hi in bounds)
        collected = _run_chunks(fn, chunks, device, forward_timer, _serial_inference())
    metrics.counter("sparkdl.rows_processed").add(n)
    metrics.counter("sparkdl.batches_run").add(len(bounds))
    return tuple(np.concatenate(acc, axis=0) for acc in collected)


def run_batched(
    fn: Callable,
    batch: np.ndarray,
    batch_size: int = DEFAULT_BATCH_SIZE,
    device: "torch.device | str" = "cuda",
) -> np.ndarray:
    """Single-input, single-output :func:`run_batched_multi`."""
    return run_batched_multi(fn, [batch], batch_size, device)[0]


_KERAS_FN_CACHE = LRUCache(8)


def load_keras_function(path: str, compute_dtype: Optional[str] = None):
    """``TorchFunction.from_keras`` cached per (path, mtime, dtype): repeated
    transforms of the same saved model reuse one function, and so its
    params placed on the card (:meth:`TorchFunction.placed_params`)."""
    import os

    from sparkdl_tpu_torch.graph.function import TorchFunction

    if compute_dtype == "float32":
        compute_dtype = None  # same artifact as the default: share the entry
    key = (os.path.abspath(path), os.path.getmtime(path), compute_dtype)
    fn = _KERAS_FN_CACHE.get(key)
    if fn is None:
        fn = TorchFunction.from_keras(path, compute_dtype=compute_dtype)
        _KERAS_FN_CACHE[key] = fn
    return fn
