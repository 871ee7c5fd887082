"""Typed, validated component configs, the part of
``nos_tpu/api/config.py`` that the port's train main needs: ``ConfigError``,
the ``ManagerConfig`` fields and checks that ``TrainConfig`` inherits, and
``load_config`` (YAML when pyyaml is installed, JSON otherwise; an
``apiVersion`` key is checked and dropped).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
from typing import Any, TypeVar

logger = logging.getLogger(__name__)

CONFIG_V1BETA1 = "nos.tpu/v1beta1"
CONFIG_V1BETA2 = "nos.tpu/v1beta2"
SUPPORTED_CONFIG_VERSIONS = (CONFIG_V1BETA1, CONFIG_V1BETA2)

T = TypeVar("T")


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class ManagerConfig:
    """Shared manager knobs: health probe and metrics bind addresses,
    leader election, a kubeconfig and the SLO tick (the JAX package's
    ``ManagerConfig``; the port's train main serves the health address
    and gives the kubeconfig to its pod hooks, ``cmd/train.py``)."""

    health_probe_addr: str = ""   # "host:port", "" = disabled
    metrics_addr: str = ""        # "host:port", "" = disabled
    leader_election: bool = False
    kubeconfig: str = ""
    slo_interval_s: float = 1.0

    def validate(self) -> None:
        for field in ("health_probe_addr", "metrics_addr"):
            addr = getattr(self, field)
            if addr and ":" not in addr:
                raise ConfigError(f"{field} must be host:port, got {addr!r}")
        if self.kubeconfig and not pathlib.Path(self.kubeconfig).is_file():
            raise ConfigError(
                f"kubeconfig {self.kubeconfig!r} does not exist")
        if self.slo_interval_s < 0:
            raise ConfigError("slo_interval_s must be >= 0")


_FIELD_TYPES = {
    "float": float, float: float,
    "int": int, int: int,
    "str": str, str: str,
    "bool": bool, bool: bool,
}


def _coerce(cls: type, raw: dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields)
    if unknown:
        raise ConfigError(
            f"unknown config key(s) for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in raw.items():
        if value is None:
            # YAML bare key ("metrics_addr:") = unset → dataclass default.
            continue
        want = _FIELD_TYPES.get(fields[name].type)
        # YAML gives ints where floats are declared; that's fine.
        if want is float and isinstance(value, int) \
                and not isinstance(value, bool):
            value = float(value)
        if want is not None and not isinstance(value, want) or \
                want in (int, float) and isinstance(value, bool):
            raise ConfigError(
                f"{cls.__name__}.{name} must be {want.__name__}, "
                f"got {type(value).__name__} ({value!r})")
        kwargs[name] = value
    return cls(**kwargs)


def load_config(path: str | pathlib.Path | None, cls: type[T], *,
                validate: bool = True) -> T:
    """Decode + validate a config file into `cls`; defaults when path is
    None.  YAML when pyyaml is available, JSON otherwise."""
    if path is None:
        cfg = cls()
    else:
        text = pathlib.Path(path).read_text()
        try:
            import yaml

            raw = yaml.safe_load(text)
        except ImportError:
            raw = json.loads(text)
        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise ConfigError(f"config root must be a mapping, "
                              f"got {type(raw).__name__}")
        version = raw.pop("apiVersion", None)
        if version is None:
            logger.warning(
                "config %s has no apiVersion; interpreting as %s "
                "(write 'apiVersion: %s' to pin the schema)",
                path, CONFIG_V1BETA1, CONFIG_V1BETA2)
        elif version not in SUPPORTED_CONFIG_VERSIONS:
            raise ConfigError(
                f"unsupported config apiVersion {version!r} for "
                f"{cls.__name__}; supported: "
                f"{', '.join(SUPPORTED_CONFIG_VERSIONS)}")
        cfg = _coerce(cls, raw)
    if validate:
        cfg.validate()
    return cfg
