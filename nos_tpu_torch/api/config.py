"""Typed, validated component configs, ``nos_tpu/api/config.py`` for the
port (reference pkg/api/nos.nebuly.com/config/v1alpha1/
gpu_partitioner_config.go:28-55 and siblings): one dataclass per main,
loaded from the YAML or JSON file a main takes as ``--config``.

Every file may carry ``apiVersion``.  ``nos.tpu/v1beta2`` is canonical;
``nos.tpu/v1beta1`` (and a file without ``apiVersion``, with a warning)
is the flat wire format, converted with a log line: the scheduler's
flat ``drain_preempt_*`` keys move into a nested ``drain_preemption:``
block.  An unknown version is an error.

The JAX package's TPU names take the port's: ``gpu_memory_gb_per_gpu``
(80, an H100's memory) for ``tpu_memory_gb_per_chip``, an agent's
``model`` (``auto`` or a registry name such as
``nvidia-h100-80gb-hbm3``) for its ``generation``, and the partitioning
kinds ``mig``, ``mps`` and ``hybrid`` for ``slice``, ``timeshare`` and
``hybrid``.

Knobs of planes the port does not have yet are parsed and checked as
the JAX package checks them.  At the JAX package's default a knob is
accepted, and ``missing_planes`` names the ROADMAP item that brings its
plane, for the main to log once; any other value raises ``ConfigError``
naming that item.  So no knob is ignored quietly.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
from typing import Any, ClassVar, TypeVar

logger = logging.getLogger(__name__)

MIG_KIND = "mig"
MPS_KIND = "mps"
HYBRID_KIND = "hybrid"

CONFIG_V1BETA1 = "nos.tpu/v1beta1"
CONFIG_V1BETA2 = "nos.tpu/v1beta2"
SUPPORTED_CONFIG_VERSIONS = (CONFIG_V1BETA1, CONFIG_V1BETA2)

T = TypeVar("T")


class ConfigError(ValueError):
    pass


# (fields, the JAX package's default of each, the plane, its ROADMAP item)
_DEFRAG = (("defrag_enabled", False), ("defrag_payback_min", 1.5),
           ("defrag_interval_s", 0.0), ("defrag_drain_timeout_s", 120.0))
_DRAIN = (("drain_preempt_after_cycles", 0),
          ("drain_preempt_max_busy_fraction", 0.25),
          ("drain_preempt_spare_progress", 0.75))
_SHARD = (("shard_chips_per_host", 0),)
_ELASTIC = (("elastic_grow_budget_per_cycle", 1),)
_SLO = (("slo_interval_s", 1.0),)
_PLANES = {
    "defrag": (_DEFRAG, "the defragmentation plane", "ROADMAP item 6"),
    "drain": (_DRAIN, "drain preemption", "ROADMAP item 7.2"),
    "shard": (_SHARD, "host-shard quota accounting", "ROADMAP item 7.2"),
    "elastic": (_ELASTIC, "elastic gang growth", "ROADMAP item 4"),
    "slo": (_SLO, "the SLO engine", "ROADMAP item 9 part 1"),
}


@dataclasses.dataclass
class ManagerConfig:
    """Shared manager knobs: health probe and metrics bind addresses,
    leader election (a ConfigMap lease, ``kube/leaderelection.py``), a
    kubeconfig (``kube/rest.py``; "" is the in-memory API) and the SLO
    tick."""

    health_probe_addr: str = ""   # "host:port", "" = disabled
    metrics_addr: str = ""        # "host:port", "" = disabled
    leader_election: bool = False
    kubeconfig: str = ""
    slo_interval_s: float = 1.0

    # the planes whose knobs this config carries and the port lacks
    _missing: ClassVar[tuple[str, ...]] = ()

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

    def _refuse_missing(self) -> None:
        """After the JAX package's checks: a knob of a plane the port
        lacks, away from the JAX default, is an error."""
        for plane in self._missing:
            knobs, what, item = _PLANES[plane]
            for name, default in knobs:
                value = getattr(self, name)
                if value != default and not (plane == "slo" and value == 0):
                    raise ConfigError(
                        f"{type(self).__name__}.{name} = {value!r}: "
                        f"{what} is not in the port yet ({item}); only "
                        f"{default!r} is accepted")


def missing_planes(cfg: ManagerConfig) -> list[str]:
    """One line per plane this config's knobs belong to and the port
    lacks, for a main to log once at start."""
    out = []
    for plane in cfg._missing:
        knobs, what, item = _PLANES[plane]
        if plane == "slo" and cfg.slo_interval_s == 0:
            continue
        out.append(f"{', '.join(n for n, _ in knobs)} at the JAX "
                   f"package's defaults: {what} comes with {item}")
    return out


@dataclasses.dataclass
class PartitionerConfig(ManagerConfig):
    """The partitioner main's config (GpuPartitionerConfig analog)."""

    kind: str = MIG_KIND          # mig | mps | hybrid
    batch_timeout_s: float = 2.0
    batch_idle_s: float = 0.5
    poll_interval_s: float = 0.05
    # the plan handshake's deadline before a silent node is quarantined;
    # 0 = 3 x batch_timeout_s
    plan_deadline_s: float = 0.0
    # plan cycles run at most once per epoch; 0 = the batch idle window
    replan_epoch_s: float = 0.0
    # sharded parallel planning from this many nodes over 2+ plan pools
    plan_shard_min_hosts: int = 128
    plan_workers: int = 0         # 0 = auto
    defrag_enabled: bool = False
    defrag_payback_min: float = 1.5
    defrag_interval_s: float = 0.0
    defrag_drain_timeout_s: float = 120.0
    # the recovery plane (partitioning/core/failure.py): off unless one
    # of the first two is set
    spare_hosts_per_pool: int = 0
    node_suspect_after_s: float = 0.0
    migrate_grace_s: float = 5.0
    # MIG table overrides (GpuModelRegistry.load_overrides)
    known_geometries_file: str = ""
    # the MPS plugin's ConfigMap (partitioning/timeshare/partitioner.py's
    # names, which the chip agent reads)
    device_plugin_cm_name: str = "nos-device-plugin-configs"
    device_plugin_cm_namespace: str = "nebuly-nos"

    _missing: ClassVar[tuple[str, ...]] = ("defrag", "slo")

    def validate(self) -> None:
        super().validate()
        if self.kind not in (MIG_KIND, MPS_KIND, HYBRID_KIND):
            raise ConfigError(f"kind must be mig|mps|hybrid, "
                              f"got {self.kind!r}")
        if self.batch_timeout_s <= 0 or self.batch_idle_s <= 0:
            raise ConfigError("batch windows must be positive")
        if self.batch_idle_s > self.batch_timeout_s:
            raise ConfigError("batch_idle_s must not exceed batch_timeout_s")
        if self.poll_interval_s <= 0:
            raise ConfigError("poll_interval_s must be positive")
        if self.plan_deadline_s < 0:
            raise ConfigError("plan_deadline_s must be >= 0")
        if self.plan_deadline_s and self.plan_deadline_s < self.batch_timeout_s:
            raise ConfigError(
                "plan_deadline_s below batch_timeout_s would quarantine "
                "nodes still inside a normal batch window")
        if self.replan_epoch_s < 0:
            raise ConfigError("replan_epoch_s must be >= 0")
        if self.plan_shard_min_hosts < 0:
            raise ConfigError("plan_shard_min_hosts must be >= 0")
        if self.plan_workers < 0:
            raise ConfigError("plan_workers must be >= 0")
        if self.spare_hosts_per_pool < 0:
            raise ConfigError("spare_hosts_per_pool must be >= 0")
        if self.node_suspect_after_s < 0:
            raise ConfigError("node_suspect_after_s must be >= 0")
        if self.migrate_grace_s < 0:
            raise ConfigError("migrate_grace_s must be >= 0")
        if self.defrag_payback_min <= 0:
            raise ConfigError("defrag_payback_min must be positive")
        if self.defrag_interval_s < 0:
            raise ConfigError("defrag_interval_s must be >= 0")
        if self.defrag_drain_timeout_s <= 0:
            raise ConfigError("defrag_drain_timeout_s must be positive")
        if self.known_geometries_file and \
                not pathlib.Path(self.known_geometries_file).is_file():
            raise ConfigError(
                f"known_geometries_file {self.known_geometries_file!r} "
                f"does not exist")
        self._refuse_missing()


@dataclasses.dataclass
class SchedulerConfig(ManagerConfig):
    """The scheduler main's config (CapacitySchedulingArgs analog: the
    quota currency, reference pkg/api/scheduler/types.go:23-27).  Quotas
    count ``nos.nebuly.com/gpu-memory`` GB, a whole GPU
    ``gpu_memory_gb_per_gpu``; the operator's value must match."""

    gpu_memory_gb_per_gpu: int = 80
    shard_chips_per_host: int = 0
    cycle_interval_s: float = 0.05
    drain_preempt_after_cycles: int = 0
    drain_preempt_max_busy_fraction: float = 0.25
    drain_preempt_spare_progress: float = 0.75
    # PostFilter searches per cycle; the rest retry next cycle
    preempt_budget_per_cycle: int = 2
    elastic_grow_budget_per_cycle: int = 1
    # a displaced pod ranks above batch until its stamp is this old;
    # 0 = no expiry
    displaced_age_cap_s: float = 300.0

    _missing: ClassVar[tuple[str, ...]] = ("drain", "shard", "elastic",
                                           "slo")

    def validate(self) -> None:
        super().validate()
        if self.displaced_age_cap_s < 0:
            raise ConfigError("displaced_age_cap_s must be >= 0")
        if self.gpu_memory_gb_per_gpu <= 0:
            raise ConfigError("gpu_memory_gb_per_gpu must be positive")
        if self.cycle_interval_s <= 0:
            raise ConfigError("cycle_interval_s must be positive")
        if self.drain_preempt_after_cycles < 0:
            raise ConfigError("drain_preempt_after_cycles must be >= 0")
        if not 0 < self.drain_preempt_max_busy_fraction <= 1:
            raise ConfigError(
                "drain_preempt_max_busy_fraction must be in (0, 1]")
        if not 0 < self.drain_preempt_spare_progress <= 1:
            raise ConfigError(
                "drain_preempt_spare_progress must be in (0, 1]")
        if self.shard_chips_per_host < 0:
            raise ConfigError("shard_chips_per_host must be >= 0")
        if self.preempt_budget_per_cycle < 1:
            raise ConfigError("preempt_budget_per_cycle must be >= 1")
        if self.elastic_grow_budget_per_cycle < 0:
            raise ConfigError(
                "elastic_grow_budget_per_cycle must be >= 0")
        self._refuse_missing()


@dataclasses.dataclass
class OperatorConfig(ManagerConfig):
    """The operator main's config (OperatorConfig analog)."""

    gpu_memory_gb_per_gpu: int = 80
    shard_chips_per_host: int = 0
    resync_interval_s: float = 5.0
    # the HTTPS AdmissionReview endpoint (kube/webhook.py): 0 disables;
    # tls.crt and tls.key are read from webhook_cert_dir
    webhook_port: int = 0
    webhook_cert_dir: str = ""

    _missing: ClassVar[tuple[str, ...]] = ("shard",)

    def validate(self) -> None:
        super().validate()
        if self.gpu_memory_gb_per_gpu <= 0:
            raise ConfigError("gpu_memory_gb_per_gpu must be positive")
        if self.resync_interval_s <= 0:
            raise ConfigError("resync_interval_s must be positive")
        if self.webhook_port < 0 or self.webhook_port > 65535:
            raise ConfigError("webhook_port must be in [0, 65535]")
        if self.webhook_port > 0 and not self.webhook_cert_dir:
            # the kube-apiserver talks TLS only: no cert dir would serve
            # admission in cleartext
            raise ConfigError(
                "webhook_port > 0 requires webhook_cert_dir (the chart "
                "mounts tls.crt/tls.key there)")
        if self.shard_chips_per_host < 0:
            raise ConfigError("shard_chips_per_host must be >= 0")
        self._refuse_missing()


@dataclasses.dataclass
class AgentConfig(ManagerConfig):
    """The node agents' config (MigAgentConfig/GpuAgentConfig analog);
    the node's name comes from a flag or the file."""

    node_name: str = ""
    report_interval_s: float = 10.0
    model: str = "nvidia-h100-80gb-hbm3"   # or "auto": discovery decides
    # stamp the liveness heartbeat with each report: the partitioner's
    # suspicion (node_suspect_after_s) has no signal without it
    heartbeat: bool = False

    def validate(self) -> None:
        super().validate()
        if not self.node_name:
            raise ConfigError("node_name is required")
        if self.report_interval_s <= 0:
            raise ConfigError("report_interval_s must be positive")


# -- version conversion and the canonical decode ---------------------------

_DRAIN_FLAT_TO_NESTED = (
    ("drain_preempt_after_cycles", "after_cycles"),
    ("drain_preempt_max_busy_fraction", "max_busy_fraction"),
    ("drain_preempt_spare_progress", "spare_progress"),
)


def _scheduler_from_v1beta1(raw: dict) -> dict:
    """v1beta1 SchedulerConfig (flat drain_preempt_* keys) -> v1beta2 (a
    nested drain_preemption block).  Both forms at once are an error: a
    half-migrated file."""
    out = dict(raw)
    nested: dict = {}
    for flat, key in _DRAIN_FLAT_TO_NESTED:
        if flat in out:
            nested[key] = out.pop(flat)
    if nested and "drain_preemption" in out:
        raise ConfigError(
            "both flat drain_preempt_* keys (v1beta1) and a "
            "drain_preemption block (v1beta2) present — migrate fully")
    if nested:
        out["drain_preemption"] = nested
    return out


def _scheduler_decode(raw: dict) -> dict:
    """Canonical (v1beta2) SchedulerConfig raw -> dataclass kwargs: the
    drain_preemption block flattens onto the fields.  Legacy flat keys
    beside the block are rejected, as the converter rejects them."""
    out = dict(raw)
    block = out.pop("drain_preemption", None)
    if block is None:
        return out
    stale = [flat for flat, _ in _DRAIN_FLAT_TO_NESTED if flat in out]
    if stale:
        raise ConfigError(
            f"both a drain_preemption block and legacy flat key(s) "
            f"{stale} present — migrate fully")
    if not isinstance(block, dict):
        raise ConfigError("drain_preemption must be a mapping")
    keys = {k: flat for flat, k in _DRAIN_FLAT_TO_NESTED}
    unknown = set(block) - set(keys)
    if unknown:
        raise ConfigError(
            f"unknown drain_preemption key(s): {sorted(unknown)}")
    for k, v in block.items():
        out[keys[k]] = v
    return out


_V1BETA1_CONVERTERS: dict[type, Any] = {
    SchedulerConfig: _scheduler_from_v1beta1,
}
_CANONICAL_DECODERS: dict[type, Any] = {
    SchedulerConfig: _scheduler_decode,
}


def _convert_config(cls: type, version: str, raw: dict,
                    source: str) -> dict:
    """Old version -> canonical raw -> dataclass kwargs, the conversion
    logged."""
    if version not in SUPPORTED_CONFIG_VERSIONS:
        raise ConfigError(
            f"unsupported config apiVersion {version!r} for "
            f"{cls.__name__}; supported: "
            f"{', '.join(SUPPORTED_CONFIG_VERSIONS)}")
    if version == CONFIG_V1BETA1:
        converter = _V1BETA1_CONVERTERS.get(cls)
        if converter is not None:
            raw = converter(raw)
        logger.info("config %s: converted %s from %s to %s",
                    source, cls.__name__, version, CONFIG_V1BETA2)
    decoder = _CANONICAL_DECODERS.get(cls)
    return decoder(raw) if decoder is not None else raw


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


def load_agent_config(path: str | pathlib.Path | None,
                      node: str | None) -> AgentConfig:
    """AgentConfig with the ``--node`` override applied before the
    checks, so a shared file without node_name and a per-node flag
    load."""
    cfg = load_config(path, AgentConfig, validate=False)
    if node:
        cfg.node_name = node
    cfg.validate()
    return cfg


def load_config(path: str | pathlib.Path | None, cls: type[T], *,
                validate: bool = True) -> T:
    """Decode and check a config file into ``cls``; the defaults when
    ``path`` is None.  YAML when pyyaml is installed, JSON otherwise.
    ``validate=False`` leaves the checks to a caller that applies flags
    first."""
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
        # only apiVersion is schema metadata: PartitionerConfig has a real
        # ``kind`` field
        version = raw.pop("apiVersion", None)
        if version is None:
            version = CONFIG_V1BETA1
            logger.warning(
                "config %s has no apiVersion; interpreting as %s "
                "(write 'apiVersion: %s' to pin the schema)",
                path, CONFIG_V1BETA1, CONFIG_V1BETA2)
        elif not isinstance(version, str):
            raise ConfigError("apiVersion must be a string")
        raw = _convert_config(cls, version, raw, str(path))
        cfg = _coerce(cls, raw)
    if validate:
        cfg.validate()
    return cfg
