"""Typed configuration system (port of ``flink_tpu/config/config_option.py``).

TPU-native analog of the reference's config layer
(``flink-core/src/main/java/org/apache/flink/configuration/ConfigOption.java``
and ``Configuration.java``): every option is a typed ``ConfigOption`` with a
default, description and optional deprecated/fallback keys; a ``Configuration``
is a string-keyed map read/written through options.  Option groups live in
``config/options.py`` (the analog of the ~45 ``XxxOptions`` classes).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generic, Iterator, List, Mapping, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


_DURATION_SUFFIXES = {
    "ms": 1,
    "s": 1000,
    "sec": 1000,
    "min": 60_000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
}

_MEMORY_SUFFIXES = {
    "b": 1,
    "kb": 1 << 10,
    "k": 1 << 10,
    "mb": 1 << 20,
    "m": 1 << 20,
    "gb": 1 << 30,
    "g": 1 << 30,
    "tb": 1 << 40,
    "t": 1 << 40,
}


def parse_duration_ms(v: Any) -> int:
    """Parse ``"500 ms"``, ``"5 s"``, ``"1 min"``, or a bare number (ms)."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix in sorted(_DURATION_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            num = s[: -len(suffix)].strip()
            if num:
                return int(float(num) * _DURATION_SUFFIXES[suffix])
    return int(float(s))


def parse_memory_bytes(v: Any) -> int:
    """Parse ``"64 mb"``, ``"1g"``, or a bare number (bytes)."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix in sorted(_MEMORY_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            num = s[: -len(suffix)].strip()
            if num:
                return int(float(num) * _MEMORY_SUFFIXES[suffix])
    return int(float(s))


_PARSERS: Dict[type, Callable[[Any], Any]] = {
    bool: _parse_bool,
    int: lambda v: int(v),
    float: lambda v: float(v),
    str: lambda v: str(v),
    list: lambda v: list(v) if not isinstance(v, str) else [x.strip() for x in v.split(";") if x.strip()],
}


@dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed config key (analog of ``ConfigOption.java``)."""

    key: str
    type: type
    default: Any = None
    description: str = ""
    deprecated_keys: tuple = ()
    fallback_keys: tuple = ()
    parser: Optional[Callable[[Any], Any]] = None

    def with_deprecated_keys(self, *keys: str) -> "ConfigOption[T]":
        return ConfigOption(self.key, self.type, self.default, self.description,
                            self.deprecated_keys + tuple(keys), self.fallback_keys, self.parser)

    def with_fallback_keys(self, *keys: str) -> "ConfigOption[T]":
        return ConfigOption(self.key, self.type, self.default, self.description,
                            self.deprecated_keys, self.fallback_keys + tuple(keys), self.parser)

    def parse(self, raw: Any) -> T:
        if raw is None:
            return raw
        if self.parser is not None:
            return self.parser(raw)
        if self.type in _PARSERS:
            return _PARSERS[self.type](raw)
        if isinstance(raw, self.type):
            return raw
        return self.type(raw)

    def all_keys(self) -> Iterator[str]:
        yield self.key
        yield from self.fallback_keys
        yield from self.deprecated_keys


class _OptionBuilder:
    def __init__(self, key: str):
        self._key = key

    def bool_type(self):
        return _TypedBuilder(self._key, bool)

    def int_type(self):
        return _TypedBuilder(self._key, int)

    def float_type(self):
        return _TypedBuilder(self._key, float)

    def string_type(self):
        return _TypedBuilder(self._key, str)

    def list_type(self):
        return _TypedBuilder(self._key, list)

    def duration_type(self):
        # stored as int milliseconds
        return _TypedBuilder(self._key, int, parser=parse_duration_ms)

    def memory_type(self):
        return _TypedBuilder(self._key, int, parser=parse_memory_bytes)


class _TypedBuilder(Generic[T]):
    def __init__(self, key: str, typ: type, parser: Optional[Callable[[Any], Any]] = None):
        self._key = key
        self._type = typ
        self._parser = parser

    def default_value(self, default: T, description: str = "") -> ConfigOption[T]:
        return ConfigOption(self._key, self._type, default, description, parser=self._parser)

    def no_default_value(self, description: str = "") -> ConfigOption[T]:
        return self.default_value(None, description)


def key(name: str) -> _OptionBuilder:
    """Entry point mirroring ``ConfigOptions.key(...)``."""
    return _OptionBuilder(name)


class Configuration:
    """String-keyed config map with typed access through ``ConfigOption``.

    Analog of ``Configuration.java``.  Values are stored raw (as given) and
    parsed on read, so YAML/env/CLI sources can all feed it.
    """

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        self._data: Dict[str, Any] = dict(data) if data else {}

    # -- raw access ---------------------------------------------------------
    def set(self, option, value: Any) -> "Configuration":
        k = option.key if isinstance(option, ConfigOption) else str(option)
        self._data[k] = value
        return self

    def get(self, option, default: Any = _SENTINEL) -> Any:
        if isinstance(option, ConfigOption):
            for k in option.all_keys():
                if k in self._data:
                    return option.parse(self._data[k])
            if default is not _SENTINEL:
                return default
            # Copy mutable defaults so callers can't corrupt the shared
            # class-level ConfigOption object across Configuration instances.
            if isinstance(option.default, (list, dict, set)):
                return copy.copy(option.default)
            return option.default
        if option in self._data:
            return self._data[option]
        return None if default is _SENTINEL else default

    def contains(self, option) -> bool:
        if isinstance(option, ConfigOption):
            return any(k in self._data for k in option.all_keys())
        return option in self._data

    def remove(self, option) -> None:
        if isinstance(option, ConfigOption):
            for k in option.all_keys():
                self._data.pop(k, None)
        else:
            self._data.pop(str(option), None)

    # -- merging / views ----------------------------------------------------
    def add_all(self, other: "Configuration", prefix: str = "") -> "Configuration":
        for k, v in other._data.items():
            self._data[prefix + k] = v
        return self

    def clone(self) -> "Configuration":
        return Configuration(copy.deepcopy(self._data))

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def keys(self):
        return self._data.keys()

    def __contains__(self, k) -> bool:
        return self.contains(k)

    def __eq__(self, other) -> bool:
        return isinstance(other, Configuration) and self._data == other._data

    def __repr__(self) -> str:
        return f"Configuration({self._data!r})"

    # -- loading ------------------------------------------------------------
    @staticmethod
    def from_yaml_file(path: str) -> "Configuration":
        """Load a flat ``key: value`` YAML-ish file (flink-conf.yaml analog,
        ``GlobalConfiguration.java``). Only the flat subset is supported —
        which is all the reference's loader supports too."""
        conf = Configuration()
        if not os.path.exists(path):
            return conf
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if ":" not in line:
                    continue
                k, _, v = line.partition(":")
                conf._data[k.strip()] = v.strip().strip("'\"")
        return conf

    @staticmethod
    def from_env(prefix: str = "FLINK_TPU_") -> "Configuration":
        """Env var naming: single ``_`` -> ``.``, double ``__`` -> ``-``
        (option keys use both separators, e.g. FLINK_TPU_PIPELINE_MAX__PARALLELISM
        -> pipeline.max-parallelism)."""
        conf = Configuration()
        for k, v in os.environ.items():
            if k.startswith(prefix):
                name = k[len(prefix):].lower()
                name = name.replace("__", "\x00").replace("_", ".").replace("\x00", "-")
                conf._data[name] = v
        return conf
