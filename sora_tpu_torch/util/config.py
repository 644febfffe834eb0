"""Layered configuration for framework dataclasses.
(The port's own copy of ``sora_tpu.util.config``.)

The reference configures each app through a shared typed option-table
parser (kernel/util/args/args.c + per-app tables, demod11/main.cpp:26-57)
plus an .ini for UMXDot11 and interactive keys; there is no framework
level config.  Here any config dataclass (NodeConfig, future radio/run
configs) resolves through four layers, later wins:

    dataclass defaults < JSON file < environment (PREFIX_FIELD) < overrides

so a deployment can pin a node profile in a file, ops can tweak one knob
via env, and the CLI passes explicit flags as overrides.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a string/JSON value to a dataclass field type."""
    origin = getattr(typ, "__origin__", None)
    if origin is not None:                 # Optional[int] etc: try args
        for a in typ.__args__:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                pass
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ is bytes:
        if isinstance(value, str):
            return value.encode("latin-1")
        return bytes(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def load_config(cls: Type[T], path: str | None = None,
                env_prefix: str = "SORA_",
                overrides: dict | None = None) -> T:
    """Resolve a config dataclass through the four layers."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    values: dict[str, Any] = {}

    if path:
        raw = json.loads(open(path).read())
        for k, v in raw.items():
            if k not in fields:
                raise KeyError(f"{path}: unknown config key {k!r} "
                               f"for {cls.__name__}")
            values[k] = _coerce(v, _resolve(cls, k))
    for name in fields:
        env = env_prefix + name.upper()
        if env in os.environ:
            values[name] = _coerce(os.environ[env], _resolve(cls, name))
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        values[k] = _coerce(v, _resolve(cls, k))
    return cls(**values)


def _resolve(cls, name: str):
    import typing
    hints = typing.get_type_hints(cls)
    return hints.get(name, str)


def dump_config(cfg) -> str:
    """JSON form of a config dataclass (bytes rendered latin-1)."""
    def default(o):
        if isinstance(o, bytes):
            return o.decode("latin-1")
        raise TypeError(o)

    return json.dumps(dataclasses.asdict(cfg), indent=2, default=default)
