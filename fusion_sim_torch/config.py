"""Spec validation (port of ``fusion_sim_tpu/config.py``).

The semantics of the reference's recursive schema validator
(`utilities.js:11-127`): required and optional properties, union types,
nested object schemas, and error messages that carry the property path
(``"parent.prop"``).

Schema grammar:

* ``'number' | 'string' | 'boolean' | 'function' | 'object' | 'array'`` —
  a required property of that type.
* ``[Optional(spec)]`` or ``Optional(spec)`` — an optional property,
  validated against ``spec`` when present.
* ``[spec_a, spec_b, ...]`` — a union: the value must satisfy one.
* ``{...}`` — a nested object schema, validated recursively.
* a Python ``type`` or tuple of types — an isinstance check.
* a callable predicate ``f(value) -> bool`` — a custom check.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np


class SpecError(ValueError):
    """A config object failed schema validation; the message carries the
    property path."""


class Optional:  # noqa: A001 - mirrors the reference's optional holes
    """Marks a schema entry as optional."""

    def __init__(self, spec: Any):
        self.spec = spec

    def __repr__(self) -> str:  # pragma: no cover
        return f"Optional({self.spec!r})"


_TYPE_NAMES = {
    "number": (int, float, np.integer, np.floating),
    "string": (str,),
    "boolean": (bool, np.bool_),
    "object": (Mapping,),
    "array": (list, tuple, np.ndarray),
}


def _check(value: Any, spec: Any, path: str) -> None:
    if isinstance(spec, str):
        if spec == "function":
            if not callable(value):
                raise SpecError(f"{path}: expected a function, got "
                                f"{type(value).__name__}")
            return
        expected = _TYPE_NAMES.get(spec)
        if expected is None:
            raise SpecError(f"{path}: unknown type name {spec!r} in schema")
        # bool is an int subclass in Python; 'number' must not accept it
        if spec == "number" and isinstance(value, (bool, np.bool_)):
            raise SpecError(f"{path}: expected a number, got boolean")
        if not isinstance(value, expected):
            raise SpecError(f"{path}: expected {spec}, got "
                            f"{type(value).__name__}")
        return
    if isinstance(spec, Optional):
        _check(value, spec.spec, path)
        return
    if isinstance(spec, list):
        if len(spec) == 1 and isinstance(spec[0], Optional):
            _check(value, spec[0].spec, path)
            return
        errors = []
        for alternative in spec:
            try:
                _check(value, alternative, path)
                return
            except SpecError as e:  # noqa: PERF203 - small unions
                errors.append(str(e))
        raise SpecError(f"{path}: no union alternative matched: "
                        + " | ".join(errors))
    if isinstance(spec, Mapping):
        if not isinstance(value, Mapping):
            raise SpecError(f"{path}: expected an object, got "
                            f"{type(value).__name__}")
        validate_object(value, spec, path)
        return
    if isinstance(spec, type) or (isinstance(spec, tuple)
                                  and all(isinstance(s, type) for s in spec)):
        if not isinstance(value, spec):
            raise SpecError(f"{path}: expected {spec}, got "
                            f"{type(value).__name__}")
        return
    if callable(spec):
        if not spec(value):
            raise SpecError(f"{path}: predicate "
                            f"{getattr(spec, '__name__', spec)!r} failed")
        return
    raise SpecError(f"{path}: invalid schema entry {spec!r}")


def validate_object(obj: Mapping[str, Any], schema: Mapping[str, Any],
                    _path: str = "") -> None:
    """Validate a config mapping against ``schema``: required properties
    must be present, optional ones may be absent, errors carry the path
    (utilities.js:106-127)."""
    if not isinstance(obj, Mapping):
        raise SpecError(f"{_path or '<root>'}: expected an object, got "
                        f"{type(obj).__name__}")
    for name, spec in schema.items():
        path = f"{_path}.{name}" if _path else name
        optional = isinstance(spec, Optional) or (
            isinstance(spec, list) and len(spec) == 1
            and isinstance(spec[0], Optional))
        if name not in obj:
            if optional:
                continue
            raise SpecError(f"{path}: required property is missing")
        _check(obj[name], spec, path)


def validate_dataclass(instance: Any) -> None:
    """Validate a ``@dataclass`` config whose fields carry
    ``metadata={'spec': ...}``; a field without a spec is not checked, and
    ``None`` passes an ``Optional`` spec."""
    for field in dataclasses.fields(instance):
        spec = field.metadata.get("spec")
        if spec is None:
            continue
        value = getattr(instance, field.name)
        if value is None and isinstance(spec, Optional):
            continue
        _check(value, spec, field.name)
