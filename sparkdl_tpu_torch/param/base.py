"""Core ``Param`` / ``Params`` machinery (pyspark.ml.param semantics).

A copy of ``sparkdl_tpu.param.base``: ``Param``, ``Params``,
``TypeConverters`` and ``keyword_only``, so stages of the port take the same
params with the same ``copy(extra)`` semantics as the JAX package's.
"""

from __future__ import annotations

import copy as _copy
import functools
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def keyword_only(func: Callable) -> Callable:
    """Decorator that forces keyword arguments and records them.

    The wrapped method can read the passed kwargs from
    ``self._input_kwargs`` — identical contract to pyspark's decorator.
    """

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                "Method %s only takes keyword arguments." % func.__name__
            )
        # RLock: @keyword_only __init__ calls @keyword_only setParams while
        # holding the lock (pyspark's decorator is reentrant the same way).
        self._input_kwargs_lock = getattr(
            self, "_input_kwargs_lock", threading.RLock()
        )
        with self._input_kwargs_lock:
            self._input_kwargs = kwargs
            return func(self, **kwargs)

    return wrapper


class Param:
    """A typed parameter with self-contained documentation.

    Identity semantics match pyspark: equality is (parent uid, name), so a
    param looked up on a copy of a stage still resolves.
    """

    def __init__(
        self,
        parent: "Params | str",
        name: str,
        doc: str,
        typeConverter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = str(name)
        self.doc = str(doc)
        self.typeConverter = (
            TypeConverters.identity if typeConverter is None else typeConverter
        )

    def _copy_new_parent(self, parent: "Params") -> "Param":
        new = _copy.copy(self)
        new.parent = parent.uid
        return new

    def __str__(self):
        return f"{self.parent}__{self.name}"

    def __repr__(self):
        return f"Param(parent={self.parent!r}, name={self.name!r}, doc={self.doc!r})"

    def __hash__(self):
        return hash(str(self))

    def __eq__(self, other):
        if isinstance(other, Param):
            return self.parent == other.parent and self.name == other.name
        return False


class TypeConverters:
    """Type conversion/validation callables attached to ``Param``s."""

    @staticmethod
    def identity(value):
        return value

    @staticmethod
    def toInt(value):
        if isinstance(value, bool):
            raise TypeError("Could not convert %r to int" % (value,))
        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, (float, np.floating)) and float(value).is_integer():
            return int(value)
        raise TypeError("Could not convert %r to int" % (value,))

    @staticmethod
    def toFloat(value):
        if isinstance(value, bool):
            raise TypeError("Could not convert %r to float" % (value,))
        if isinstance(value, (int, float, np.integer, np.floating)):
            return float(value)
        raise TypeError("Could not convert %r to float" % (value,))

    @staticmethod
    def toBoolean(value):
        if isinstance(value, (bool, np.bool_)):
            return bool(value)
        raise TypeError("Boolean Param requires value of type bool. Found %s."
                        % type(value))

    @staticmethod
    def toString(value):
        if isinstance(value, str):
            return value
        raise TypeError("Could not convert %r to string" % (value,))

    @staticmethod
    def toList(value):
        if isinstance(value, list):
            return value
        if isinstance(value, (tuple, range)):
            return list(value)
        if isinstance(value, np.ndarray):
            return value.tolist()
        raise TypeError("Could not convert %r to list" % (value,))

    @staticmethod
    def toListInt(value):
        return [TypeConverters.toInt(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListFloat(value):
        return [TypeConverters.toFloat(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListString(value):
        return [TypeConverters.toString(v) for v in TypeConverters.toList(value)]


class Params:
    """Base class for components carrying typed params.

    Pyspark-compatible subset: ``params``, ``getParam``, ``isSet``,
    ``isDefined``, ``hasDefault``, ``getOrDefault``, ``extractParamMap``,
    ``copy(extra)``, ``explainParam(s)``, ``set``/``_set``/``_setDefault``,
    ``_copyValues``, ``_resolveParam``, ``clear``.
    """

    def __init__(self):
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self._params: Optional[List[Param]] = None
        self.uid = self._random_uid()
        self._copy_params()

    @classmethod
    def _random_uid(cls) -> str:
        return f"{cls.__name__}_{uuid.uuid4().hex[:12]}"

    # -- declaration ------------------------------------------------------
    @property
    def params(self) -> List[Param]:
        """All class-level declared params, re-parented to this instance."""
        if self._params is None:
            self._copy_params()
        return self._params  # type: ignore[return-value]

    def _copy_params(self):
        """Re-parent class-attribute ``Param``s onto this instance."""
        cls = type(self)
        src_names = [
            name
            for name in dir(cls)
            if isinstance(getattr(cls, name, None), Param)
        ]
        self._params = []
        for name in sorted(src_names):
            param = getattr(cls, name)._copy_new_parent(self)
            setattr(self, name, param)
            self._params.append(param)

    # -- lookup -----------------------------------------------------------
    def getParam(self, paramName: str) -> Param:
        param = getattr(self, paramName, None)
        if isinstance(param, Param):
            return param
        raise ValueError(f"Cannot find param with name {paramName!r}.")

    def hasParam(self, paramName: str) -> bool:
        return isinstance(getattr(self, paramName, None), Param)

    def _resolveParam(self, param: "Param | str") -> Param:
        if isinstance(param, Param):
            self._shouldOwn(param)
            return getattr(self, param.name)
        if isinstance(param, str):
            return self.getParam(param)
        raise TypeError(f"Cannot resolve {param!r} as a param.")

    def _shouldOwn(self, param: Param):
        if not (param.parent == self.uid and self.hasParam(param.name)):
            raise ValueError(f"Param {param} does not belong to {self.uid}.")

    # -- state ------------------------------------------------------------
    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param):
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(f"Param {param} is not set and has no default.")

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None):
        paramMap = dict(self._defaultParamMap)
        paramMap.update(self._paramMap)
        if extra:
            paramMap.update(extra)
        return paramMap

    # -- mutation ---------------------------------------------------------
    def set(self, param: Param, value: Any) -> "Params":
        param = self._resolveParam(param)
        self._paramMap[param] = param.typeConverter(value)
        return self

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if value is None:
                continue
            param = self.getParam(name)
            try:
                value = param.typeConverter(value)
            except (TypeError, ValueError) as e:
                raise TypeError(
                    f'Invalid param value given for param "{name}". {e}'
                ) from e
            self._paramMap[param] = value
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            param = self.getParam(name)
            if value is not None:
                try:
                    value = param.typeConverter(value)
                except Exception as e:
                    raise ValueError(
                        f'Invalid default param value for "{name}". {e}'
                    ) from e
            self._defaultParamMap[param] = value
        return self

    def clear(self, param: Param) -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    # -- copy -------------------------------------------------------------
    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        that = _copy.copy(self)
        that._paramMap = {}
        that._defaultParamMap = {}
        that._params = None
        that.uid = self.uid  # pyspark keeps the uid on copy
        # re-parent params to the copy before value transfer
        cls = type(self)
        for name in dir(cls):
            if isinstance(getattr(cls, name, None), Param):
                setattr(that, name, getattr(cls, name))
        that._copy_params()
        return self._copyValues(that, extra)

    def _copyValues(self, to: "Params", extra=None) -> "Params":
        paramMap = dict(self._paramMap)
        if extra:
            paramMap.update(extra)
        for p in self.params:
            if p in self._defaultParamMap and to.hasParam(p.name):
                to._defaultParamMap[to.getParam(p.name)] = self._defaultParamMap[p]
            if p in paramMap and to.hasParam(p.name):
                to._paramMap[to.getParam(p.name)] = paramMap[p]
        return to

    # -- docs -------------------------------------------------------------
    def explainParam(self, param) -> str:
        param = self._resolveParam(param)
        values = []
        if self.isDefined(param):
            if param in self._defaultParamMap:
                values.append(f"default: {self._defaultParamMap[param]}")
            if param in self._paramMap:
                values.append(f"current: {self._paramMap[param]}")
        else:
            values.append("undefined")
        return f"{param.name}: {param.doc} ({', '.join(values)})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)
