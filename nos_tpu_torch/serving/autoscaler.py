"""Replica autoscaler for the serving tier, ``nos_tpu/serving/autoscaler.py``
for the port.

A ``ServingService`` names one inference service: the unit each
replica consumes (a MIG instance, ``slice_shape``, or an MPS share in
GB, ``timeshare_gb``), a min/max replica band, and the load each
replica is sized for (``target_load_per_replica``).  The
``ReplicaAutoscaler`` reconciles every service against its live load
signal:

- **signal**: each replica's ANNOT_SERVING_LOAD (the request router's
  published KV occupancy, or a self-reported requests-in-flight), summed
  over the service's live replicas, so the total does not depend on the
  replica count;
- **target**: ``ceil(load / target_load_per_replica)`` clamped to
  ``[min_replicas, max_replicas]``;
- **hysteresis**: scale-down also needs the SHRUNK fleet to keep
  ``down_hysteresis`` headroom (load <= desired * target * (1 - h)), or
  a load sitting at a replica boundary flaps one replica every
  reconcile;
- **cooldown**: each direction has its own cooldown clock per service,
  a short one up (bursts must land capacity fast) and a long one down.
  The ``min_replicas`` floor holds regardless of cooldown.

On an H100 ``slice_shape`` names a MIG profile of the card's table
(``1g.10gb`` ... ``7g.80gb``, ``topology/known.py``) and a replica asks
for ``nvidia.com/mig-<profile>``; a TPU shape such as ``"1x1"`` is
refused.  ``timeshare_gb`` asks for ``nvidia.com/gpu-<N>gb``.

Replica pods carry the tier label ``serving`` (the scheduler takes them
first each cycle, never picks one as an in-quota victim and exempts
them from the quota head-of-line rule: ``scheduler/``) and
LABEL_SERVICE, and are deleted least-useful-first: pending replicas,
then drained ones (zero router-published sessions), then the least
loaded.  The per-service decision is published to a status ConfigMap
through ``retry_on_conflict``, so a conflicting writer degrades to a
retried patch.

Thread-safety: the reconcile state (cooldown clocks, name sequence) is
``@guarded_by`` the instance lock.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import threading
import time
from typing import Any, Callable, Mapping

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import (
    APIServer, Conflict, KIND_CONFIGMAP, KIND_POD, NotFound,
)
from nos_tpu_torch.kube.objects import (
    ConfigMap, Container, ObjectMeta, PENDING, Pod, PodSpec, PodStatus,
    RUNNING,
)
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.utils.guards import guarded_by
from nos_tpu_torch.utils.retry import RETRYABLE, retry_on_conflict

from nos_tpu_torch.topology.known import MODELS
from nos_tpu_torch.topology.profile import (
    slice_resource_name, timeshare_resource_name,
)

logger = logging.getLogger(__name__)


def _mig_profiles() -> list[str]:
    """Every MIG profile of the known cards' tables, sorted."""
    return sorted({p.name for m in MODELS.values() for p in m.mig_profiles})


def _is_mig_profile(shape: str) -> bool:
    return shape in _mig_profiles()


def _max_share_gb() -> int:
    """The largest card's memory: no MPS share is larger."""
    return max(m.memory_gb for m in MODELS.values())

REGISTRY.describe("nos_tpu_autoscaler_load",
                  "Summed requests-in-flight signal per serving service")
REGISTRY.describe("nos_tpu_autoscaler_replicas",
                  "Live (pending+running) replicas per serving service")
REGISTRY.describe("nos_tpu_autoscaler_desired_replicas",
                  "Clamped replica target per serving service")
REGISTRY.describe("nos_tpu_autoscaler_scale_events_total",
                  "Executed scale decisions per service and direction")


@dataclasses.dataclass(frozen=True)
class ServingService:
    """One autoscaled inference service (module docstring)."""

    name: str
    namespace: str = "serving"
    # Replica size: exactly one of a MIG profile ("1g.20gb") or an MPS
    # share in GB; bursty traffic maps to SMALL units so the band has
    # fine-grained steps.
    slice_shape: str = ""
    timeshare_gb: int = 0
    min_replicas: int = 1
    max_replicas: int = 8
    target_load_per_replica: float = 8.0
    scale_up_cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 30.0
    down_hysteresis: float = 0.15
    priority: int = 0
    scheduler_name: str = "nos-tpu-scheduler"

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("serving service needs a name")
        if bool(self.slice_shape) == bool(self.timeshare_gb):
            raise ValueError(
                f"service {self.name}: exactly one of slice_shape / "
                f"timeshare_gb must be set")
        if self.timeshare_gb < 0:
            raise ValueError(f"service {self.name}: timeshare_gb < 0")
        if self.slice_shape and not _is_mig_profile(self.slice_shape):
            raise ValueError(
                f"service {self.name}: slice_shape {self.slice_shape!r} "
                f"is not a MIG profile of {', '.join(_mig_profiles())}")
        if self.timeshare_gb > _max_share_gb():
            raise ValueError(
                f"service {self.name}: timeshare_gb {self.timeshare_gb} "
                f"is over a card's {_max_share_gb()} GB")
        if not 0 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"service {self.name}: need 0 <= min_replicas <= "
                f"max_replicas, got [{self.min_replicas}, "
                f"{self.max_replicas}]")
        if self.target_load_per_replica <= 0:
            raise ValueError(
                f"service {self.name}: target_load_per_replica must be "
                f"> 0")
        if self.scale_up_cooldown_s < 0 or self.scale_down_cooldown_s < 0:
            raise ValueError(
                f"service {self.name}: cooldowns must be >= 0")
        if not 0 <= self.down_hysteresis < 1:
            raise ValueError(
                f"service {self.name}: down_hysteresis must be in "
                f"[0, 1)")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @classmethod
    def from_mapping(cls, raw: Mapping[str, Any]) -> "ServingService":
        """Build from a config-file mapping (api/config.py
        AutoscalerConfig.services); unknown keys are an error so a
        typoed knob fails the config load, not the 3 a.m. burst."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(
                f"unknown serving service key(s): {sorted(unknown)}")
        return cls(**dict(raw))

    def replica_resources(self) -> dict[str, float]:
        """A replica pod's request: its MIG instance or MPS share and
        one CPU."""
        if self.slice_shape:
            return {slice_resource_name(self.slice_shape): 1.0,
                    "cpu": 1.0}
        return {timeshare_resource_name(self.timeshare_gb): 1.0,
                "cpu": 1.0}


def replica_load(pod: Pod) -> float:
    """The pod's self-reported requests-in-flight
    (ANNOT_SERVING_LOAD); absent/garbage/non-finite = 0."""
    raw = pod.metadata.annotations.get(C.ANNOT_SERVING_LOAD, "")
    try:
        value = float(raw)
    except ValueError:
        return 0.0
    if not math.isfinite(value) or value < 0.0:
        return 0.0
    return value


def replica_sessions(pod: Pod) -> int:
    """The replica's router-published active-session count
    (ANNOT_SERVING_SESSIONS); absent, garbage (non-finite too) or
    negative = 0, so a
    routerless deployment reads every replica as drained and keeps the
    historical least-loaded victim order."""
    raw = pod.metadata.annotations.get(C.ANNOT_SERVING_SESSIONS, "")
    try:
        value = int(float(raw))
    except (ValueError, OverflowError):
        # "nan" and "inf" parse as floats and fail as ints (the JAX
        # package's reader raises on them)
        return 0
    return max(0, value)


@guarded_by("_lock", "_services", "_last_scale", "_seq")
class ReplicaAutoscaler:
    """Reconcile serving services toward their load signal (module
    docstring).  ``reconcile()`` is the run-loop entry point; the
    injectable clock must share a time domain with pod
    creation_timestamps (wall in production, the virtual trace clock in
    the fleets) because replica pods are stamped with it at creation and
    the scheduler measures queue latency against that stamp."""

    def __init__(self, api: APIServer,
                 services: tuple[ServingService, ...] | list[
                     ServingService] = (),
                 status_configmap: str = "nos-tpu-autoscaler-status",
                 status_namespace: str = "nos-tpu-system",
                 clock: Callable[[], float] = time.time) -> None:
        self._api = api
        self._clock = clock
        self._status_cm = status_configmap
        self._status_ns = status_namespace
        self._lock = threading.Lock()
        self._services: dict[str, ServingService] = {}
        # (service key, direction) -> last executed scale time
        self._last_scale: dict[tuple[str, str], float] = {}
        # per-service replica name sequence (names must not recycle
        # within a process: a delete can race its own watch event)
        self._seq: dict[str, int] = {}
        for svc in services:
            self.add_service(svc)

    # -- service registry ---------------------------------------------------
    def add_service(self, svc: ServingService) -> None:
        with self._lock:
            self._services[svc.key] = svc

    def remove_service(self, key: str) -> None:
        with self._lock:
            self._services.pop(key, None)

    def services(self) -> list[ServingService]:
        with self._lock:
            return list(self._services.values())

    # -- reconcile ----------------------------------------------------------
    def reconcile(self) -> dict[str, dict[str, float]]:
        """One pass over every service; returns the per-service summary
        ({key: {load, replicas, desired, scaled}}) that also lands in
        the status ConfigMap."""
        summary: dict[str, dict[str, float]] = {}
        for svc in self.services():
            summary[svc.key] = self._reconcile_service(svc)
        if summary:
            self._publish_status(summary)
        return summary

    def _live_replicas(self, svc: ServingService) -> list[Pod]:
        return self._api.list(
            KIND_POD, namespace=svc.namespace,
            label_selector={C.LABEL_SERVICE: svc.name},
            filter_fn=lambda p: p.status.phase in (PENDING, RUNNING))

    def _reconcile_service(self, svc: ServingService
                           ) -> dict[str, float]:
        now = self._clock()
        pods = self._live_replicas(svc)
        replicas = len(pods)
        load = sum(replica_load(p) for p in pods)
        raw = math.ceil(load / svc.target_load_per_replica)
        desired = min(svc.max_replicas, max(svc.min_replicas, raw))
        scaled = 0
        if desired > replicas:
            if self._may_scale(svc, "up", now) \
                    or replicas < svc.min_replicas:
                scaled = self._scale_up(svc, desired - replicas, now)
        elif desired < replicas:
            # hysteresis: the shrunk fleet must keep headroom, or the
            # boundary load re-adds the replica next reconcile (flap)
            fits_with_headroom = load <= (
                desired * svc.target_load_per_replica
                * (1.0 - svc.down_hysteresis))
            over_band = replicas > svc.max_replicas
            if over_band or (fits_with_headroom
                             and self._may_scale(svc, "down", now)):
                scaled = -self._scale_down(svc, pods,
                                           replicas - desired, now)
        labels = {"service": svc.key}
        REGISTRY.set("nos_tpu_autoscaler_load", load, labels=labels)
        REGISTRY.set("nos_tpu_autoscaler_replicas",
                     float(replicas + scaled), labels=labels)
        REGISTRY.set("nos_tpu_autoscaler_desired_replicas",
                     float(desired), labels=labels)
        return {"load": round(load, 3), "replicas": float(replicas),
                "desired": float(desired), "scaled": float(scaled)}

    def _may_scale(self, svc: ServingService, direction: str,
                   now: float) -> bool:
        cooldown = (svc.scale_up_cooldown_s if direction == "up"
                    else svc.scale_down_cooldown_s)
        with self._lock:
            last = self._last_scale.get((svc.key, direction))
        return last is None or now - last >= cooldown

    def _note_scaled(self, svc: ServingService, direction: str,
                     now: float, count: int) -> None:
        with self._lock:
            self._last_scale[(svc.key, direction)] = now
        REGISTRY.inc("nos_tpu_autoscaler_scale_events_total",
                     labels={"service": svc.key,
                             "direction": direction})
        journal_record(J.AUTOSCALE, svc.key, direction=direction,
                       count=count)

    def _next_name(self, svc: ServingService) -> str:
        with self._lock:
            n = self._seq.get(svc.key, 0)
            self._seq[svc.key] = n + 1
        return f"{svc.name}-r{n}"

    def _scale_up(self, svc: ServingService, count: int,
                  now: float) -> int:
        created = 0
        for _ in range(count):
            pod = Pod(
                metadata=ObjectMeta(
                    name=self._next_name(svc),
                    namespace=svc.namespace,
                    labels={C.LABEL_SERVICE: svc.name,
                            C.LABEL_TIER: C.TIER_SERVING},
                    annotations={C.ANNOT_SERVING_LOAD: "0"},
                    creation_timestamp=now),
                spec=PodSpec(
                    containers=[
                        Container(resources=svc.replica_resources())],
                    priority=svc.priority,
                    scheduler_name=svc.scheduler_name),
                status=PodStatus(phase=PENDING))
            try:
                self._api.create(KIND_POD, pod)
            except Conflict:
                # a stale name survived a restart's sequence reset; the
                # next reconcile retries with a fresh sequence slot
                continue
            created += 1
        if created:
            self._note_scaled(svc, "up", now, created)
        return created

    def _scale_down(self, svc: ServingService, pods: list[Pod],
                    count: int, now: float) -> int:
        # cheapest victims first: replicas that never bound, then
        # DRAINED running ones (zero router-published sessions — killing
        # them cuts no live stream), then the least-loaded (their
        # in-flight work is smallest)
        doomed = sorted(
            pods, key=lambda p: (p.status.phase == RUNNING,
                                 replica_sessions(p) > 0,
                                 replica_load(p), p.metadata.name))
        deleted = 0
        for pod in doomed[:count]:
            try:
                self._api.delete(KIND_POD, pod.metadata.name,
                                 pod.metadata.namespace)
            except NotFound:
                continue        # already gone: counts as shrunk
            deleted += 1
        if deleted:
            self._note_scaled(svc, "down", now, deleted)
        return deleted

    # -- status -------------------------------------------------------------
    def _publish_status(self, summary: dict[str, dict[str, float]]
                        ) -> None:
        """Per-service decision record on a status ConfigMap via the
        retry-wrapped API: the autoscaler's only read-modify-write, and
        the surface `kubectl get cm` answers "what did it just do?"
        from."""
        def mutate(cm: ConfigMap) -> None:
            for key, row in summary.items():
                cm.data[key] = json.dumps(row, sort_keys=True)

        try:
            retry_on_conflict(self._api, KIND_CONFIGMAP, self._status_cm,
                              mutate, self._status_ns,
                              component="autoscaler-status")
        except NotFound:
            cm = ConfigMap(
                metadata=ObjectMeta(name=self._status_cm,
                                    namespace=self._status_ns),
                data={k: json.dumps(v, sort_keys=True)
                      for k, v in summary.items()})
            try:
                self._api.create(KIND_CONFIGMAP, cm)
            except Conflict:
                pass    # a racing replica created it; next tick patches
        except RETRYABLE:
            # the status record is advisory: an apiserver having a bad
            # moment (retries exhausted) must not fail the reconcile
            # whose scale decisions already executed; the exhausted
            # counter (nos_tpu_retry_exhausted_total) carries the alarm
            logger.warning("autoscaler: status publish to %s/%s failed "
                           "after retries; next reconcile re-publishes",
                           self._status_ns, self._status_cm)
