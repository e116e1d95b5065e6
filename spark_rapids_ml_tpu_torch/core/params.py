"""Spark-ML-compatible parameter system.

The reference's estimator params live in the ``RapidsPCAParams`` trait
(reference src/main/scala/org/apache/spark/ml/feature/RapidsPCA.scala:30-75),
built on Spark ML's ``Params``/``Param``/``BooleanParam``/``IntParam`` with
``setDefault`` + getters + chainable setters, serialized with model metadata.

This module re-implements that surface natively (no pyspark dependency):
``Param`` descriptors owned by a ``Params`` mixin with a user map overriding a
default map, validated by type converters, and JSON-serializable for the
DefaultParamsWriter-style persistence in
:mod:`spark_rapids_ml_tpu_torch.core.persistence`.

Port of the reference's ``core/params.py``; the uid lock is made by the
lock sanitizer's factory (``params.uid``, :mod:`..utils.lockcheck`).
"""

from __future__ import annotations

import numbers
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional

from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock


class Param:
    """A typed parameter with self-contained documentation.

    Mirrors ``org.apache.spark.ml.param.Param`` semantics: identified by
    (parent uid, name); equality/hashing by that identity so param maps keyed
    by Param behave like Spark's.
    """

    def __init__(
        self,
        parent: str,
        name: str,
        doc: str,
        type_converter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.type_converter = type_converter or (lambda x: x)

    def __repr__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __hash__(self) -> int:
        return hash(repr(self))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Param) and repr(self) == repr(other)


# --- type converters (mirror org.apache.spark.ml.param.ParamValidators) ---


def toInt(value: Any) -> int:
    """Accepts any Integral (incl. numpy ints) and integral floats, like
    pyspark's TypeConverters.toInt."""
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise TypeError(f"Could not convert {value!r} to int")
    if not isinstance(value, numbers.Integral) and not float(value).is_integer():
        raise TypeError(f"Could not convert non-integral {value!r} to int")
    return int(value)


def toFloat(value: Any) -> float:
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise TypeError(f"Could not convert {value!r} to float")
    return float(value)


def toBoolean(value: Any) -> bool:
    if not isinstance(value, bool):
        raise TypeError(f"Could not convert {value!r} to bool")
    return value


def toString(value: Any) -> str:
    if not isinstance(value, str):
        raise TypeError(f"Could not convert {value!r} to str")
    return value


def gt(bound: float) -> Callable[[Any], Any]:
    def check(value):
        if not value > bound:
            raise ValueError(f"value {value!r} must be > {bound}")
        return value

    return check


_uid_lock = make_lock("params.uid")


def _random_uid(prefix: str) -> str:
    """Spark-style uid: ``<prefix>_<12 hex chars>`` (Identifiable.randomUID)."""
    with _uid_lock:
        return f"{prefix}_{uuid.uuid4().hex[:12]}"


class Params:
    """Mixin holding a default param map and a user-set param map.

    Subclasses declare params as class-level ``Param`` placeholders which are
    re-bound per-instance in ``__init__`` (so ``parent`` is the instance uid,
    matching Spark's per-instance Param identity).
    """

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or _random_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self._bind_params()

    def _bind_params(self) -> None:
        """Re-bind the class-level Param declarations to this instance."""
        self._params: Dict[str, Param] = {}
        for klass in reversed(type(self).__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    bound = Param(self.uid, attr.name, attr.doc, attr.type_converter)
                    setattr(self, name, bound)
                    self._params[attr.name] = bound

    # --- pickling (by value: no Param object, so no type converter, is pickled) ---

    def __getstate__(self):
        """The instance state with the param maps keyed by name and the
        per-instance ``Param`` objects left out: their type converters may
        be lambdas, which plain ``pickle`` refuses. ``__setstate__`` binds
        them again from the class declarations, as ``__init__`` does."""
        state = super().__getstate__()
        state = dict(state) if state else {}
        for name in [n for n, v in state.items() if isinstance(v, Param)]:
            del state[name]
        state.pop("_params", None)
        state["_paramMap"] = {p.name: v for p, v in self._paramMap.items()}
        state["_defaultParamMap"] = {p.name: v for p, v in self._defaultParamMap.items()}
        return state

    def __setstate__(self, state):
        state = dict(state)
        user = state.pop("_paramMap")
        defaults = state.pop("_defaultParamMap")
        parent = getattr(super(), "__setstate__", None)
        if parent is not None:
            parent(state)
        else:
            self.__dict__.update(state)
        self._bind_params()
        self._paramMap = {self._params[name]: v for name, v in user.items()}
        self._defaultParamMap = {self._params[name]: v for name, v in defaults.items()}

    # --- introspection ---

    @property
    def params(self) -> List[Param]:
        return sorted(self._params.values(), key=lambda p: p.name)

    def hasParam(self, name: str) -> bool:
        return name in self._params

    def getParam(self, name: str) -> Param:
        if not self.hasParam(name):
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return self._params[name]

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def explainParam(self, param) -> str:
        param = self._resolveParam(param)
        value = self._paramMap.get(param)
        default = self._defaultParamMap.get(param)
        parts = [f"default: {default}"] if param in self._defaultParamMap else ["undefined"]
        if param in self._paramMap:
            parts.append(f"current: {value}")
        return f"{param.name}: {param.doc} ({', '.join(parts)})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    # --- get/set ---

    def getOrDefault(self, param):
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(f"Param {param.name} is not set and has no default")

    def set(self, param, value) -> "Params":
        param = self._resolveParam(param)
        self._paramMap[param] = param.type_converter(value)
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            param = self.getParam(name)
            self._defaultParamMap[param] = param.type_converter(value)
        return self

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            self.set(self.getParam(name), value)
        return self

    def clear(self, param) -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def extractParamMap(self) -> Dict[Param, Any]:
        merged = dict(self._defaultParamMap)
        merged.update(self._paramMap)
        return merged

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            return self._params[param.name]
        return self.getParam(param)

    # --- copy (Spark Params.copy contract: deep param maps, shared values) ---

    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        that = type(self)()
        self._copyValues(that, extra)
        # Estimators may carry a non-Param mesh argument; a copy keeps it
        # so the copy runs (or refuses) the same route.
        if hasattr(self, "mesh") and hasattr(that, "mesh"):
            that.mesh = self.mesh
        # Non-Param state a subclass names in _copy_attrs (a KMeans warm
        # start) survives copies too.
        for attr in getattr(self, "_copy_attrs", ()):
            if getattr(self, attr, None) is not None:
                setattr(that, attr, getattr(self, attr))
        return that

    def _copyValues(self, to: "Params", extra: Optional[Dict[Param, Any]] = None) -> "Params":
        # Spark's copyValues contract: only params the TARGET defines are
        # copied (an estimator-only param like deployMode does not belong
        # on the fitted model). Explicit `extra` entries still raise on an
        # unknown name — those are caller-specified, not inherited.
        for param, value in self._defaultParamMap.items():
            if param.name in to._params:
                to._defaultParamMap[to.getParam(param.name)] = value
        for param, value in self._paramMap.items():
            if param.name in to._params:
                to._paramMap[to.getParam(param.name)] = value
        if extra:
            for param, value in extra.items():
                to._paramMap[to.getParam(param.name)] = value
        return to

    # --- iteration sugar ---

    def __iter__(self) -> Iterator[Param]:
        return iter(self.params)
