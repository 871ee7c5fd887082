"""The MIG agent's reporter/actuator handshake state,
``nos_tpu/controllers/sliceagent/shared.py`` for the port (reference
internal/controllers/migagent/shared.go:24-57).

The actuator acts only after the reporter has observed the node once
since the last apply, so every plan is computed against fresh state;
the reporter stamps the last plan id the actuator parsed.  The state
also remembers the last applied plan (a duplicate is skipped) and the
plans found impossible to place around the used instances, which wait
for a new plan id.
"""

from __future__ import annotations

import threading

from nos_tpu_torch.utils.guards import guarded_by


@guarded_by("_lock", "_report_since_apply", "_last_parsed_plan_id",
            "_last_applied_signature", "_infeasible_signatures")
class SharedState:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._report_since_apply = False
        self._last_parsed_plan_id = ""
        self._last_applied_signature: tuple | None = None
        self._infeasible_signatures: set[tuple] = set()

    def on_report_done(self) -> None:
        with self._lock:
            self._report_since_apply = True

    def on_apply_done(self) -> None:
        with self._lock:
            self._report_since_apply = False

    @property
    def at_least_one_report_since_last_apply(self) -> bool:
        with self._lock:
            return self._report_since_apply

    @property
    def last_parsed_plan_id(self) -> str:
        with self._lock:
            return self._last_parsed_plan_id

    @last_parsed_plan_id.setter
    def last_parsed_plan_id(self, value: str) -> None:
        with self._lock:
            self._last_parsed_plan_id = value

    def is_duplicate(self, signature: tuple) -> bool:
        with self._lock:
            return self._last_applied_signature == signature

    def record_applied(self, signature: tuple) -> None:
        with self._lock:
            self._last_applied_signature = signature
            self._infeasible_signatures.clear()

    # A plan whose creates cannot be placed around the used instances
    # can never succeed as it is: it is skipped until a new plan id.
    def is_infeasible(self, signature: tuple) -> bool:
        with self._lock:
            return signature in self._infeasible_signatures

    def record_infeasible(self, signature: tuple) -> None:
        with self._lock:
            self._infeasible_signatures.add(signature)

    def clear_infeasible(self) -> None:
        with self._lock:
            self._infeasible_signatures.clear()
