"""SliceActuator: the MIG agent's actuation half,
``nos_tpu/controllers/sliceagent/actuator.py`` for the port (reference
internal/controllers/migagent/actuator.go:71-292).

On each pass it diffs the node's spec against the devices into a
``ConfigPlan``, deletes then creates through the device client, keeps
a status per operation (a partial failure leaves the rest applied) and
has the device plugin re-advertise when anything changed.  Guards: at
least one report since the last apply (:74-78); no-op and duplicate
plans are skipped (:109-116); a plan whose creates cannot be placed
around the used instances is remembered and skipped until the planner
sends a new plan id.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.device.gpuclient import SliceDeviceClient
from nos_tpu_torch.device.plugin import DevicePluginClient
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.topology.annotations import (
    parse_spec_annotations, profile_family, spec_matches_status, spec_plan_id,
)
from nos_tpu_torch.topology.errors import PlacementInfeasibleError

from .plan import ConfigPlan, SliceState, new_config_plan
from .shared import SharedState

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_placement_infeasible_total",
                  "Plans skipped: their creates cannot be placed around "
                  "the used instances (awaiting a re-plan)")


@dataclass
class OperationStatus:
    """One operation's outcome (reference plan/operation.go:25-54)."""

    op: object
    error: Exception | None = None
    plugin_refresh_required: bool = False

    @property
    def placement_infeasible(self) -> bool:
        return isinstance(self.error, PlacementInfeasibleError)


@dataclass
class ApplyResult:
    statuses: list[OperationStatus] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(s.error is None for s in self.statuses)

    @property
    def changed(self) -> bool:
        return any(s.plugin_refresh_required for s in self.statuses)

    @property
    def placement_infeasible(self) -> bool:
        return any(s.placement_infeasible for s in self.statuses)


class SliceActuator:
    def __init__(self, api: APIServer, node_name: str,
                 client: SliceDeviceClient, shared: SharedState,
                 plugin: DevicePluginClient) -> None:
        self._api = api
        self._node_name = node_name
        self._client = client
        self._shared = shared
        self._plugin = plugin

    def reconcile(self) -> bool:
        """True if devices changed (and the plugin re-advertised)."""
        if not self._shared.at_least_one_report_since_last_apply:
            logger.debug("sliceagent actuator: waiting for a fresh report")
            return False
        annots = self._api.get(KIND_NODE, self._node_name).metadata.annotations
        plan_id = spec_plan_id(annots, family=C.MIG_KIND)
        if plan_id != self._shared.last_parsed_plan_id:
            # a new plan supersedes the remembered infeasible verdicts
            self._shared.clear_infeasible()
        self._shared.last_parsed_plan_id = plan_id
        if spec_matches_status(annots, family=C.MIG_KIND):
            return False

        spec: dict[int, dict[str, int]] = {}
        for a in parse_spec_annotations(annots):
            if profile_family(a.profile) == C.MIG_KIND:
                spec.setdefault(a.index, {})[a.profile] = a.quantity
        plan = new_config_plan(
            SliceState.from_devices(self._client.get_devices()), spec)
        if plan.empty:
            return False
        if self._shared.is_duplicate(plan.signature()):
            logger.debug("sliceagent actuator: duplicate plan, skipping")
            return False
        if self._shared.is_infeasible(plan.signature()):
            logger.debug("sliceagent actuator: plan known impossible to "
                         "place, awaiting a re-plan")
            return False

        result = self._apply(plan)
        if result.ok:
            # a failed plan is not recorded: the duplicate skip would
            # block its retry for good
            self._shared.record_applied(plan.signature())
        elif result.placement_infeasible:
            REGISTRY.inc("nos_tpu_placement_infeasible_total",
                         labels={"node": self._node_name})
            if all(s.error is None for s in result.statuses
                   if not s.placement_infeasible):
                # sound only when every delete succeeded: a surviving
                # device may be what blocks the creates, and its delete
                # deserves the retry.  The creates-only rest (what the
                # next pass computes once the deletes are gone) is
                # remembered too, so one attempt suffices.
                self._shared.record_infeasible(plan.signature())
                self._shared.record_infeasible(
                    ConfigPlan(creates=plan.creates).signature())
        self._shared.on_apply_done()
        if result.changed:
            self._plugin.refresh()
        if not result.ok:
            errs = "; ".join(str(s.error) for s in result.statuses if s.error)
            if result.placement_infeasible:
                logger.info("sliceagent actuator: plan impossible to place "
                            "on %s (re-plan required): %s",
                            self._node_name, errs)
            else:
                logger.warning("sliceagent actuator: partial failure on "
                               "%s: %s", self._node_name, errs)
        return result.changed

    def _apply(self, plan: ConfigPlan) -> ApplyResult:
        """Deletes first, then creates (reference actuator.go:152-201).
        A GPU's creates go in ONE call, so the packer places the whole
        set jointly: per-profile calls would let small instances
        fragment the card before the large ones are placed (what NVML's
        permutation search is for, pkg/gpu/nvml/client.go:286-340)."""
        result = ApplyResult()
        for op in plan.deletes:
            for did in op.device_ids:
                st = OperationStatus(op=op)
                try:
                    self._client.delete_slice(did)
                    st.plugin_refresh_required = True
                except Exception as e:  # noqa: BLE001 — per operation
                    st.error = e
                result.statuses.append(st)
        by_unit: dict[int, list] = {}
        for op in plan.creates:
            by_unit.setdefault(op.unit_index, []).append(op)
        for unit_index, ops in sorted(by_unit.items()):
            profiles = [op.profile for op in ops for _ in range(op.quantity)]
            st = OperationStatus(op=tuple(ops))
            try:
                self._client.create_slices(unit_index, profiles)
                st.plugin_refresh_required = True
            except Exception as e:  # noqa: BLE001 — per operation
                st.error = e
            result.statuses.append(st)
        return result

    def startup_cleanup(self) -> list[str]:
        """Delete carved devices no pod holds (reference
        cmd/migagent/migagent.go:190-199)."""
        used = self._client.pod_resources.used_device_ids()
        doomed = self._client.delete_all_except(used)
        if doomed:
            self._plugin.refresh()
        return doomed
