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

Every knob of the JAX package's configs is one the port acts on, under
the JAX key name and at its default: the scheduler's drain preemption
(``drain_preempt_*``, off at 0) and host-shard quota accounting
(``shard_chips_per_host``, a block unit charged one node's GPUs; off at
0) included.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
from typing import Any, TypeVar

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


@dataclasses.dataclass
class SchedulerConfig(ManagerConfig):
    """The scheduler main's config (CapacitySchedulingArgs analog: the
    quota currency, reference pkg/api/scheduler/types.go:23-27).  Quotas
    count ``nos.nebuly.com/gpu-memory`` GB, a whole GPU
    ``gpu_memory_gb_per_gpu``; the operator's value must match."""

    gpu_memory_gb_per_gpu: int = 80
    # host-shard quota accounting: one unit of an NVLink block is charged
    # this many GPUs (the nodes' GPU count), not the block's (0 = off);
    # must match the operator's
    shard_chips_per_host: int = 0
    cycle_interval_s: float = 0.05
    # drain preemption (0 = off): after a gang has held its window lease
    # this many cycles, evict the stragglers off the window when they
    # hold at most max_busy_fraction of its GPUs, sparing those past
    # spare_progress
    drain_preempt_after_cycles: int = 0
    drain_preempt_max_busy_fraction: float = 0.25
    drain_preempt_spare_progress: float = 0.75
    # PostFilter searches per cycle; the rest retry next cycle
    preempt_budget_per_cycle: int = 2
    elastic_grow_budget_per_cycle: int = 1
    # a displaced pod ranks above batch until its stamp is this old;
    # 0 = no expiry
    displaced_age_cap_s: float = 300.0

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


@dataclasses.dataclass
class OperatorConfig(ManagerConfig):
    """The operator main's config (OperatorConfig analog)."""

    gpu_memory_gb_per_gpu: int = 80
    # host-shard quota accounting; must match the scheduler's
    shard_chips_per_host: int = 0
    resync_interval_s: float = 5.0
    # the HTTPS AdmissionReview endpoint (kube/webhook.py): 0 disables;
    # tls.crt and tls.key are read from webhook_cert_dir
    webhook_port: int = 0
    webhook_cert_dir: str = ""

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



def _check_services(services, build) -> None:
    """Each service mapping through the class that runs it, so a chart
    and the code cannot drift: a typo or a value with no meaning on the
    card fails the load."""
    if not isinstance(services, list):
        raise ConfigError("services must be a list of mappings")
    for i, raw in enumerate(services):
        if not isinstance(raw, dict):
            raise ConfigError(f"services[{i}] must be a mapping")
        try:
            build(raw)
        except (TypeError, ValueError) as e:
            raise ConfigError(f"services[{i}]: {e}") from e


@dataclasses.dataclass
class AutoscalerConfig(ManagerConfig):
    """The serving replica autoscaler main's config (``serving/``).
    ``services`` holds one mapping per autoscaled service (the
    ``ServingService`` fields: name, namespace, slice_shape (a MIG
    profile) or timeshare_gb, min/max_replicas, target_load_per_replica,
    the cooldowns, down_hysteresis, priority, scheduler_name), each
    validated through ``ServingService`` itself."""

    reconcile_interval_s: float = 0.5
    status_configmap: str = "nos-tpu-autoscaler-status"
    status_namespace: str = "nos-tpu-system"
    services: list = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        super().validate()
        if self.reconcile_interval_s <= 0:
            raise ConfigError("reconcile_interval_s must be positive")
        if not self.status_configmap:
            raise ConfigError("status_configmap is required")
        from nos_tpu_torch.serving.autoscaler import ServingService

        _check_services(self.services, ServingService.from_mapping)


@dataclasses.dataclass
class RouterConfig(ManagerConfig):
    """The request router's config (``requests/``).  ``services`` holds
    one mapping per routed service (the ``RouterService`` fields with
    nested ``model:``, ``prefill:`` and ``decode:`` cost blocks), each
    validated through ``RouterService`` itself.  Off by default: with
    ``enabled`` false no router is built and replicas' loads are
    whatever the workloads self-report.  As in the JAX package no main
    runs it; the router is built in-process (``requests/router.py``)."""

    enabled: bool = False
    tick_interval_s: float = 0.05
    publish_every_ticks: int = 5
    # replica-stepping worker threads, 0 or 1 in line: the journal is
    # byte-identical at any count
    workers: int = 0
    services: list = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        super().validate()
        if self.tick_interval_s <= 0:
            raise ConfigError("tick_interval_s must be positive")
        if self.publish_every_ticks < 1:
            raise ConfigError("publish_every_ticks must be >= 1")
        if self.workers < 0:
            raise ConfigError("workers must be >= 0")
        from nos_tpu_torch.requests.router import RouterService

        _check_services(self.services, RouterService.from_mapping)

@dataclasses.dataclass
class ProvisionerConfig(ManagerConfig):
    """The capacity provisioner main's config (``capacity/``).  Off by
    default: with ``enabled`` false the main exits without constructing
    the plane, and the decision journal is byte-identical to a build
    without it.  The JAX package's knob names are kept, so each
    ``*_chips`` knob counts GPUs (``capacity/provisioner.py``), and the
    defaults are an H100 node's: 80 GB a GPU, 8 GPUs a node, and a
    scale-up deficit of one whole node."""

    enabled: bool = False
    poll_interval_s: float = 2.0
    # scale-up: a GPU deficit (pending demand less free less arriving
    # capacity) sustained this long before a pool grows
    scale_up_deficit_chips: float = 8.0
    scale_up_after_s: float = 6.0
    scale_up_cooldown_s: float = 15.0
    max_pending_creates: int = 4
    # scale-down: the highest-index node only, after the surplus lasted
    # this long; a busy candidate is cordoned (a capacity-owned
    # migration drain) and released once its residents finish
    scale_down_idle_s: float = 120.0
    scale_down_cooldown_s: float = 60.0
    min_hosts_per_pool: int = 1
    # a create not landed and joined by the deadline is reaped (zombie or
    # stuck pending); join_grace_s covers agentless nodes
    provision_deadline_s: float = 120.0
    join_grace_s: float = 10.0
    vacancy_grace_s: float = 4.0
    # the stockout breaker, per (machine class, zone)
    breaker_threshold: int = 3
    breaker_open_s: float = 60.0
    spare_target_per_pool: int = 0
    inventory_configmap: str = "nos-tpu-capacity-inventory"
    inventory_namespace: str = "nos-tpu-system"
    chips_per_host_cap: float = 8.0
    hbm_gb_per_chip: float = 80.0
    cloud_attempts: int = 4
    # the stand-in provider's knobs (the in-memory CloudGPUAPI the main
    # builds when no provider endpoint is configured)
    provision_delay_s: float = 30.0
    quota_nodes: int = 0

    def validate(self) -> None:
        super().validate()
        if self.poll_interval_s <= 0:
            raise ConfigError("poll_interval_s must be positive")
        if self.scale_up_deficit_chips <= 0:
            raise ConfigError("scale_up_deficit_chips must be positive")
        for name in ("scale_up_after_s", "scale_up_cooldown_s",
                     "scale_down_idle_s", "scale_down_cooldown_s",
                     "join_grace_s", "vacancy_grace_s", "breaker_open_s",
                     "provision_delay_s"):
            if getattr(self, name) < 0:
                raise ConfigError(f"{name} must be non-negative")
        if self.max_pending_creates < 1:
            raise ConfigError("max_pending_creates must be >= 1")
        if self.min_hosts_per_pool < 0:
            raise ConfigError("min_hosts_per_pool must be non-negative")
        if self.provision_deadline_s <= 0:
            raise ConfigError("provision_deadline_s must be positive")
        if self.breaker_threshold < 1:
            raise ConfigError("breaker_threshold must be >= 1")
        if self.spare_target_per_pool < 0:
            raise ConfigError("spare_target_per_pool must be "
                              "non-negative")
        if not self.inventory_configmap:
            raise ConfigError("inventory_configmap is required")
        if self.chips_per_host_cap <= 0:
            raise ConfigError("chips_per_host_cap must be positive")
        if self.hbm_gb_per_chip <= 0:
            raise ConfigError("hbm_gb_per_chip must be positive")
        if self.cloud_attempts < 1:
            raise ConfigError("cloud_attempts must be >= 1")
        if self.quota_nodes < 0:
            raise ConfigError("quota_nodes must be non-negative")


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
