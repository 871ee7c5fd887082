"""The MIG agent's plan: observed devices against the spec, as deletes
and creates, ``nos_tpu/controllers/sliceagent/plan.py`` for the port
(reference internal/controllers/migagent/plan/{mig_state.go:29-87,
plan.go:31-92, operation.go:25-54}).

- Free devices of a profile the spec wants fewer of are deleted; used
  devices never are.
- Per GPU and profile, the shortfall is created.
- On a GPU that gets creates, the surviving free devices are deleted
  and created again too, so the placement search may move them
  (plan.go:63-92).

Deletes come first, then creates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nos_tpu_torch.topology import USED, DeviceList
from nos_tpu_torch.topology.profile import profile_from_resource


@dataclass
class ProfileDevices:
    used: list[str] = field(default_factory=list)
    free: list[str] = field(default_factory=list)

    @property
    def total(self) -> int:
        return len(self.used) + len(self.free)


class SliceState(dict):
    """GPU index -> profile -> ProfileDevices (mig_state.go)."""

    @staticmethod
    def from_devices(devices: DeviceList) -> "SliceState":
        state = SliceState()
        for d in devices:
            profile = profile_from_resource(d.resource_name)
            if profile is None:
                continue
            pd = state.setdefault(d.unit_index, {}).setdefault(
                profile, ProfileDevices())
            (pd.used if d.status == USED else pd.free).append(d.device_id)
        return state


@dataclass(frozen=True)
class CreateOperation:
    unit_index: int
    profile: str
    quantity: int


@dataclass(frozen=True)
class DeleteOperation:
    unit_index: int
    device_ids: tuple[str, ...]


@dataclass
class ConfigPlan:
    deletes: list[DeleteOperation] = field(default_factory=list)
    creates: list[CreateOperation] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.deletes and not self.creates

    def signature(self) -> tuple:
        """The plan's identity, for the duplicate skip (reference
        actuator.go:109-116)."""
        return (
            tuple(sorted((d.unit_index, d.device_ids) for d in self.deletes)),
            tuple(sorted((c.unit_index, c.profile, c.quantity)
                         for c in self.creates)),
        )


def new_config_plan(state: SliceState,
                    spec: dict[int, dict[str, int]]) -> ConfigPlan:
    """The delete-free-then-create plan (plan.go:31-92)."""
    plan = ConfigPlan()
    for unit in sorted(set(state) | set(spec)):
        current = state.get(unit, {})
        desired = {p: q for p, q in spec.get(unit, {}).items() if q > 0}
        doomed: list[str] = []
        creates: dict[str, int] = {}
        survivors_free: dict[str, list[str]] = {}
        # sorted: the plan must not depend on hash order
        for profile in sorted(set(current) | set(desired)):
            pd = current.get(profile, ProfileDevices())
            want = desired.get(profile, 0)
            if pd.total > want:
                excess = min(pd.total - want, len(pd.free))
                doomed.extend(pd.free[:excess])
                survivors_free[profile] = pd.free[excess:]
            else:
                survivors_free[profile] = list(pd.free)
                if want > pd.total:
                    creates[profile] = want - pd.total
        if creates:
            # re-create the surviving free devices, so the placement
            # search may move them (plan.go:63-92)
            for profile, ids in survivors_free.items():
                if ids:
                    doomed.extend(ids)
                    creates[profile] = creates.get(profile, 0) + len(ids)
        if doomed:
            plan.deletes.append(DeleteOperation(unit, tuple(sorted(doomed))))
        for profile, qty in sorted(creates.items()):
            plan.creates.append(CreateOperation(unit, profile, qty))
    return plan
