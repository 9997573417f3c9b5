"""Image I/O and the Spark-compatible image schema.

A trimmed copy of ``sparkdl_tpu.image.imageIO``: the struct ``(origin,
height, width, nChannels, mode, data)`` with OpenCV type codes and BGR
channel order in ``data``, the array <-> struct codecs, and the file readers
(``filesToDF``, ``readImages``). PIL is imported only inside the decode of
compressed bytes, so this module imports where PIL is not installed; only
``readImages`` needs it. The resize helpers (``PIL_decode_and_resize``,
``resizeImage``) are not ported yet.
"""

from __future__ import annotations

import glob
import io
import logging
import os
from collections import namedtuple
from typing import Callable, List, Optional

import numpy as np

from sparkdl_tpu_torch.resilience.errors import PermanentError
from sparkdl_tpu_torch.sql.types import (
    BinaryType,
    IntegerType,
    Row,
    StringType,
    StructField,
    StructType,
)
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

imageSchema = StructType(
    [
        StructField("origin", StringType()),
        StructField("height", IntegerType()),
        StructField("width", IntegerType()),
        StructField("nChannels", IntegerType()),
        StructField("mode", IntegerType()),
        StructField("data", BinaryType()),
    ]
)

_OcvType = namedtuple("_OcvType", ["name", "ord", "nChannels", "dtype"])

_OCV_TYPES = [
    _OcvType(name="Undefined", ord=-1, nChannels=-1, dtype="N/A"),
    _OcvType(name="CV_8UC1", ord=0, nChannels=1, dtype="uint8"),
    _OcvType(name="CV_8UC3", ord=16, nChannels=3, dtype="uint8"),
    _OcvType(name="CV_8UC4", ord=24, nChannels=4, dtype="uint8"),
    _OcvType(name="CV_32FC1", ord=5, nChannels=1, dtype="float32"),
    _OcvType(name="CV_32FC3", ord=21, nChannels=3, dtype="float32"),
    _OcvType(name="CV_32FC4", ord=29, nChannels=4, dtype="float32"),
]

ocvTypes = {t.name: t.ord for t in _OCV_TYPES}


class imageType:
    """Lookup helpers between OpenCV type codes and (nChannels, dtype)."""

    @staticmethod
    def byOrdinal(ord_: int) -> _OcvType:
        for t in _OCV_TYPES:
            if t.ord == ord_:
                return t
        raise KeyError(f"Unknown OpenCV type ordinal: {ord_}")

    @staticmethod
    def byName(name: str) -> _OcvType:
        for t in _OCV_TYPES:
            if t.name == name:
                return t
        raise KeyError(f"Unknown OpenCV type name: {name}")

    @staticmethod
    def forArray(arr: np.ndarray) -> _OcvType:
        if arr.ndim == 2:
            n_channels = 1
        elif arr.ndim == 3:
            n_channels = arr.shape[2]
        else:
            raise ValueError(f"Image array must be 2-d or 3-d, got shape {arr.shape}")
        dtype = str(arr.dtype)
        for t in _OCV_TYPES:
            if t.nChannels == n_channels and t.dtype == dtype:
                return t
        raise ValueError(
            f"Unsupported image array: {n_channels} channels, dtype {dtype}"
        )


imageTypeByOrdinal = imageType.byOrdinal
imageTypeByName = imageType.byName


def imageArrayToStruct(imgArray: np.ndarray, origin: str = "") -> Row:
    """Pack a (H, W[, C]) array, already in stored (BGR) channel order, into
    an image struct Row; :func:`rgbArrayToStruct` takes RGB."""
    if imgArray.ndim == 2:
        imgArray = imgArray[:, :, None]
    ocv = imageType.forArray(imgArray)
    height, width, n_channels = imgArray.shape
    return Row(
        origin=origin,
        height=int(height),
        width=int(width),
        nChannels=int(n_channels),
        mode=int(ocv.ord),
        data=np.ascontiguousarray(imgArray).tobytes(),
    )


def imageStructToArray(imageRow: Row) -> np.ndarray:
    """Unpack an image struct Row into a (H, W, C) array in stored channel
    order (BGR for color images)."""
    ocv = imageType.byOrdinal(imageRow["mode"])
    shape = (imageRow["height"], imageRow["width"], imageRow["nChannels"])
    return np.frombuffer(imageRow["data"], dtype=ocv.dtype).reshape(shape)


def rgbArrayToStruct(rgbArray: np.ndarray, origin: str = "") -> Row:
    """Pack an RGB(A) array, converting to the stored BGR(A) order."""
    arr = rgbArray
    if arr.ndim == 3 and arr.shape[2] >= 3:
        arr = arr[:, :, ::-1] if arr.shape[2] == 3 else arr[:, :, [2, 1, 0, 3]]
    return imageArrayToStruct(arr, origin)


def imageStructToRGBArray(imageRow: Row) -> np.ndarray:
    """Unpack to RGB(A) order (undoing the stored BGR(A))."""
    arr = imageStructToArray(imageRow)
    if arr.shape[2] == 3:
        return arr[:, :, ::-1]
    if arr.shape[2] == 4:
        return arr[:, :, [2, 1, 0, 3]]
    return arr


class ImageDecodeError(ValueError, PermanentError):
    """A file's bytes could not be decoded into an image; ``origin`` names
    the file and ``cause`` is the underlying error, if any. A
    :class:`~sparkdl_tpu_torch.resilience.errors.PermanentError`: corrupt
    bytes do not heal on retry, so skip the row or fail fast."""

    def __init__(self, origin: str, cause: Optional[BaseException] = None):
        self.origin = origin
        self.cause = cause
        detail = f": {cause}" if cause is not None else ""
        super().__init__(f"cannot decode image {origin!r}{detail}")


def _decode_image_bytes(raw: bytes, origin: str = "") -> Optional[Row]:
    """Decode compressed image bytes (PNG/JPEG/...) -> image struct, or None
    if undecodable."""
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(raw))
        if img.mode not in ("L", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img)
    except Exception:
        return None
    return rgbArrayToStruct(arr, origin) if arr.ndim == 3 else imageArrayToStruct(arr, origin)


def _list_files(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f))
        )
    return sorted(glob.glob(path))


def _session(session):
    from sparkdl_tpu_torch.sql.session import TorchSession

    return session or TorchSession.builder.getOrCreate()


def filesToDF(session, path: str, numPartitions: int = 4):
    """Read files from a directory or glob -> DataFrame (filePath, fileData)."""
    rows = []
    for f in _list_files(path):
        with open(f, "rb") as fh:
            rows.append((f, fh.read()))
    return _session(session).createDataFrame(
        rows, ["filePath", "fileData"], numPartitions=numPartitions
    )


def readImages(path: str, session=None, numPartitions: int = 4,
               on_error: str = "skip"):
    """Read images from a directory or glob -> DataFrame with an ``image``
    struct column. ``on_error="skip"`` drops undecodable files, counting
    each in ``data.decode_errors``; ``"raise"`` raises
    :class:`ImageDecodeError` naming the file. Needs PIL."""
    return readImagesWithCustomFn(
        path, decode_f=_decode_image_bytes, numPartitions=numPartitions,
        session=session, on_error=on_error,
    )


def readImagesWithCustomFn(
    path: str,
    decode_f: Callable[[bytes, str], Optional[Row]],
    numPartitions: int = 4,
    session=None,
    on_error: str = "skip",
):
    """Like :func:`readImages` with a custom ``decode_f(bytes, origin) ->
    Optional[Row]``; a None return (or a raise) is a decode failure,
    handled per ``on_error``."""
    if on_error not in ("skip", "raise"):
        raise ValueError(f'on_error must be "skip" or "raise", got {on_error!r}')
    files_df = filesToDF(session, path, numPartitions=numPartitions)

    def decode_partition(part):
        decode_errors = metrics.counter("data.decode_errors")
        images, origins = [], []
        for fp, raw in zip(part["filePath"], part["fileData"]):
            try:
                struct = decode_f(raw, fp)
            except Exception as exc:
                if on_error == "raise":
                    raise ImageDecodeError(fp, exc) from exc
                struct = None
            if struct is None:
                if on_error == "raise":
                    raise ImageDecodeError(fp)
                decode_errors.add(1)
                logger.warning("dropping undecodable image %s", fp)
                continue
            images.append(struct)
            origins.append(fp)
        return {"filePath": origins, "image": images}

    schema = StructType(
        [StructField("filePath", StringType()), StructField("image", imageSchema)]
    )
    return files_df.mapPartitions(decode_partition, schema=schema)
