"""Self-registering configuration system (incfg equivalent).

The reference declares options in-place with ``INCFG_REQUIRE(type, NAME,
default, desc)`` statics and reads them with ``INCFG_GET(NAME)``
(cf. src/CMakeLists.txt:104-111 and usage in e.g.
src/wass_stereo/wass_stereo.cpp:52-84).  The on-disk
format is ``key=value`` lines with ``#`` comment lines carrying each
option's description (documented in
doc/src/render/documentation/matcher.html.md:36-96).

Here each module declares its options at import time via
:func:`register`; :func:`get` reads the effective value; config files in
the same ``key=value`` format round-trip via :func:`load_file` /
:func:`to_config_string` (the ``--genconfig`` flow).

The port's own copy of the JAX package's wass_tpu/config.py, with the same
behaviour (the port imports nothing of the JAX package); file
references are to the WASS reference sources.
"""

from __future__ import annotations

import dataclasses
import io
import threading
from typing import Any, Callable, Dict, Iterable, Optional


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"invalid boolean literal: {s!r}")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s.strip()),
    float: lambda s: float(s.strip()),
    str: lambda s: s.strip(),
}


@dataclasses.dataclass
class _Option:
    name: str
    type: type
    default: Any
    description: str
    value: Any


class ConfigRegistry:
    """A named registry of typed options.

    The reference uses one global singleton; we allow independent
    registries (one per pipeline stage family) so that e.g. matcher and
    stereo configs can be generated/loaded separately, matching the
    separate ``matcher_config.txt`` / ``stereo_config.txt`` files.
    """

    def __init__(self, name: str):
        self.name = name
        self._options: Dict[str, _Option] = {}
        self._lock = threading.Lock()

    def register(self, type_: type, name: str, default: Any, description: str) -> None:
        with self._lock:
            if name in self._options:
                # Same semantics as a duplicated INCFG_REQUIRE: keep first.
                return
            self._options[name] = _Option(name, type_, default, description, default)

    def get(self, name: str) -> Any:
        return self._options[name].value

    def set(self, name: str, value: Any) -> None:
        opt = self._options[name]
        if isinstance(value, str) and opt.type is not str:
            value = _PARSERS[opt.type](value)
        opt.value = opt.type(value)

    def reset(self) -> None:
        for opt in self._options.values():
            opt.value = opt.default

    def names(self) -> Iterable[str]:
        return self._options.keys()

    def as_dict(self) -> Dict[str, Any]:
        return {k: v.value for k, v in self._options.items()}

    def load_string(self, text: str) -> None:
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"{self.name}:{lineno}: expected key=value, got {raw!r}")
            key, _, val = line.partition("=")
            key = key.strip()
            if key in self._options:
                try:
                    self.set(key, val)
                except ValueError as e:
                    raise ValueError(
                        f"{self.name} config line {lineno}: bad value for "
                        f"{key} ({self._options[key].type.__name__}): {val.strip()!r}"
                    ) from e
            # Unknown keys are ignored (the reference's incfg warns only).

    def load_file(self, path) -> None:
        with open(path, "r") as f:
            self.load_string(f.read())

    def to_config_string(self) -> str:
        """Commented key=value dump, the ``--genconfig`` output format."""
        out = io.StringIO()
        for opt in self._options.values():
            out.write(f"# {opt.description}\n")
            v = opt.value
            if isinstance(v, bool):
                v = "true" if v else "false"
            out.write(f"{opt.name}={v}\n\n")
        return out.getvalue()


_REGISTRIES: Dict[str, ConfigRegistry] = {}


def registry(name: str) -> ConfigRegistry:
    if name not in _REGISTRIES:
        _REGISTRIES[name] = ConfigRegistry(name)
    return _REGISTRIES[name]


# The three config families of the reference pipeline.
prepare_cfg = registry("prepare")
matcher_cfg = registry("matcher")
stereo_cfg = registry("stereo")


def reset_all() -> None:
    for reg in _REGISTRIES.values():
        reg.reset()
