"""Stage persistence: the ``DefaultParamsWritable`` / ``Readable`` analog,
which ``ml.base`` mixes into every stage as ``MLWritable`` / ``MLReadable``.

A trimmed copy of ``sparkdl_tpu.ml.util``. ``stage.write().overwrite()
.save(path)`` writes ``metadata.json`` (the port's class path, uid, params)
and typed artifacts beside it; ``Class.load(path)`` or :func:`load_stage`
rebuilds the stage. Each param value is encoded as:

- JSON-safe values: inline in the metadata;
- a :class:`~sparkdl_tpu_torch.graph.TorchFunction` (the JAX package's
  ``XlaFunction`` encoding): a directory written by ``TorchFunction.save``
  (``function.pt2`` and ``manifest.json``), loaded back by
  ``TorchFunction.load``;
- numpy arrays and nested dicts of arrays (Flax variables): ``.npz``;
- anything else (callables such as ``imageLoader``): pickle;
- a param a stage names in ``_file_params`` (``HasKerasModel.modelFile``):
  the file it names, copied into the directory, so the saved stage no
  longer needs the original;
- a Keras model: a ``.keras`` file, written by ``write_keras_file`` for the
  port's :class:`~sparkdl_tpu_torch.models.keras_model.KerasModel`, or by
  the model's own ``save`` for a Keras object (duck-typed: its type's
  module starts with ``keras`` and it has ``save``), as the JAX package
  writes it. It loads back as a ``KerasModel`` through ``read_keras_file``,
  whichever wrote it: the port runs without Keras (a difference by design:
  the JAX package loads a Keras model).

A directory saved by the JAX package does not load here: its metadata names
the JAX package's classes.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

_METADATA = "metadata.json"


def _is_jsonable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False


def _flatten_arrays(tree, prefix="") -> Optional[Dict[str, np.ndarray]]:
    """Nested dict-of-arrays -> {'a/b': ndarray}; None if not such a tree."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            if not isinstance(key, str) or "/" in key:
                return None
            sub = _flatten_arrays(value, f"{prefix}{key}/")
            if sub is None:
                return None
            out.update(sub)
        return out
    try:
        arr = np.asarray(tree)
    except (TypeError, ValueError):
        return None
    if arr.dtype == object:
        return None
    return {prefix.rstrip("/"): arr}


def _unflatten_arrays(flat: Dict[str, np.ndarray]):
    if list(flat) == [""]:
        return flat[""]
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return root


def _is_keras_model(value) -> bool:
    mod = type(value).__module__ or ""
    return mod.startswith("keras") and hasattr(value, "save")


def _encode_param(instance, name: str, value, path: str) -> Dict[str, Any]:
    from sparkdl_tpu_torch.graph.function import TorchFunction

    if name in getattr(instance, "_file_params", ()) and isinstance(value, (str, os.PathLike)):
        ref = f"param_{name}{os.path.splitext(str(value))[1]}"
        shutil.copy2(str(value), os.path.join(path, ref))
        return {"t": "file", "ref": ref}
    if _is_jsonable(value):
        return {"t": "json", "v": value}
    if isinstance(value, TorchFunction):
        ref = f"param_{name}_torchfn"
        value.save(os.path.join(path, ref))
        return {"t": "torch_function", "ref": ref}
    from sparkdl_tpu_torch.models.keras_model import KerasModel, write_keras_file

    if isinstance(value, KerasModel) or _is_keras_model(value):
        ref = f"param_{name}.keras"
        if isinstance(value, KerasModel):
            write_keras_file(os.path.join(path, ref), value.config, value.keras_weights())
        else:
            value.save(os.path.join(path, ref))
        return {"t": "keras_model", "ref": ref}
    flat = _flatten_arrays(value)
    if flat is not None:
        ref = f"param_{name}.npz"
        np.savez(os.path.join(path, ref), **flat)
        kind = "pytree" if isinstance(value, dict) else "ndarray"
        return {"t": kind, "ref": ref}
    ref = f"param_{name}.pkl"
    try:
        with open(os.path.join(path, ref), "wb") as fh:
            pickle.dump(value, fh)
    except (pickle.PicklingError, TypeError, AttributeError) as exc:
        raise ValueError(
            f"Cannot persist param {name!r} of {type(instance).__name__}: "
            f"value {type(value).__name__} is neither JSON-serializable, an "
            f"array pytree, nor picklable ({exc}). Use module-level functions "
            "for callable params."
        ) from exc
    return {"t": "pickle", "ref": ref}


def _decode_param(desc: Dict[str, Any], path: str):
    kind = desc["t"]
    if kind == "json":
        return desc["v"]
    ref = os.path.join(path, desc["ref"])
    if kind == "file":
        return ref
    if kind == "torch_function":
        from sparkdl_tpu_torch.graph.function import TorchFunction

        return TorchFunction.load(ref)
    if kind == "keras_model":
        from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file

        return KerasModel(*read_keras_file(ref))
    if kind in ("pytree", "ndarray"):
        with np.load(ref) as data:
            flat = {k: data[k] for k in data.files}
        return _unflatten_arrays(flat)
    if kind == "pickle":
        with open(ref, "rb") as fh:
            return pickle.load(fh)
    raise ValueError(f"Unknown param encoding {kind!r}")


def reset_uid(instance, uid: str):
    """Re-key an instance (and its param maps) to a persisted uid, so
    Param identity — ``(parent uid, name)`` — survives save/load."""
    old_set = {p.name: v for p, v in instance._paramMap.items()}
    old_default = {p.name: v for p, v in instance._defaultParamMap.items()}
    instance.uid = uid
    instance._copy_params()
    instance._paramMap = {instance.getParam(n): v for n, v in old_set.items()}
    instance._defaultParamMap = {
        instance.getParam(n): v for n, v in old_default.items()
    }
    return instance


def _class_path(instance) -> str:
    cls = type(instance)
    return f"{cls.__module__}.{cls.__qualname__}"


def _import_class(path: str):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def _check_savable(stage):
    """Raise before anything is written when ``stage``, or a stage it
    holds, cannot be saved, so that an overwrite never removes the old
    directory for nothing. A stage with state outside its params checks it
    in ``_check_save()``; a composite lists its stages in
    ``_held_stages()``. A function-valued param needs the input specs that
    its export traces with (or a loaded program to write back)."""
    from sparkdl_tpu_torch.graph.function import TorchFunction

    check = getattr(stage, "_check_save", None)
    if check is not None:
        check()
    for param, value in stage._paramMap.items():
        if (isinstance(value, TorchFunction) and not value.input_specs
                and value.exported_program is None):
            raise ValueError(
                f"param {param.name!r} of {type(stage).__name__} holds the "
                f"TorchFunction {value.name!r}, which has no recorded input "
                "specs; set its input_specs to (shape, dtype) per input to save it"
            )
    if hasattr(stage, "_held_stages"):
        for held in stage._held_stages():
            _check_savable(held)


def _prepare_dir(path: str, overwrite: bool):
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(
                f"Path {path} already exists; use .write().overwrite()"
            )
        shutil.rmtree(path)
    os.makedirs(path)


class MLWriter:
    """Writer handle: ``stage.write().overwrite().save(path)``."""

    def __init__(self, instance):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def save(self, path: str):
        from sparkdl_tpu_torch import VERSION

        instance = self._instance
        _check_savable(instance)
        _prepare_dir(path, self._overwrite)
        skip = set(getattr(instance, "_exclude_params_from_save", ()))
        params = {
            p.name: _encode_param(instance, p.name, v, path)
            for p, v in instance._paramMap.items()
            if p.name not in skip
        }
        metadata = {
            "class": _class_path(instance),
            "uid": instance.uid,
            "timestamp": int(time.time() * 1000),
            "sparkdl_tpu_torch_version": VERSION,
            "params": params,
        }
        if hasattr(instance, "_save_artifacts"):
            extra = instance._save_artifacts(path)
            if extra is not None:
                metadata["extra"] = extra
        with open(os.path.join(path, _METADATA), "w") as fh:
            json.dump(metadata, fh, indent=2)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _METADATA)) as fh:
        return json.load(fh)


def load_stage(path: str, **kwargs):
    """Load any persisted stage without knowing its class up front.
    ``kwargs`` go to the class's ``_load_instance`` (such as the device of
    a ``TorchImageFileTransformer``)."""
    metadata = load_metadata(path)
    cls = _import_class(metadata["class"])
    if hasattr(cls, "_load_instance"):
        instance = cls._load_instance(metadata, path, **kwargs)
    else:
        instance = cls()
    reset_uid(instance, metadata["uid"])
    for name, desc in metadata["params"].items():
        if instance.hasParam(name):
            instance._paramMap[instance.getParam(name)] = _decode_param(desc, path)
    if hasattr(instance, "_load_artifacts"):
        instance._load_artifacts(metadata.get("extra") or {}, path)
    return instance


class MLReader:
    def __init__(self, cls):
        self._cls = cls

    def load(self, path: str):
        instance = load_stage(path)
        if not isinstance(instance, self._cls):
            raise TypeError(
                f"Loaded {type(instance).__name__} from {path}, expected "
                f"{self._cls.__name__}"
            )
        return instance


class MLWritable:
    """Mixin: ``save(path)`` / ``write()``. Params are saved from
    ``_paramMap``; classes with other state implement
    ``_save_artifacts(path) -> dict`` and ``_load_artifacts(extra, path)``
    (and ``_load_instance`` where the constructor takes arguments)."""

    def write(self) -> MLWriter:
        return MLWriter(self)

    def save(self, path: str):
        self.write().save(path)


class MLReadable:
    @classmethod
    def read(cls) -> MLReader:
        return MLReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)
