"""Leader election over the API substrate, ``nos_tpu/kube/leaderelection.py``
for the port: a ConfigMap lease (the pre-Lease-API pattern), so the same
code runs on the in-memory ``APIServer`` and on ``kube/rest.py``'s
``KubeClient`` (every reference main runs controller-runtime leader
election, helm values.yaml:57,121,285).

The lease ConfigMap's annotations carry the holder's identity and its
renew deadline (wall clock seconds).  A candidate takes the lease when
it is absent, expired or already its own; the holder renews every
``renew_s``; the others look again every ``retry_s``.  Taking and
renewing go through create and update: the update carries the
resourceVersion read, so a lost race is a Conflict (409) on both
substrates.  A merge patch has no such guard over REST and would allow
two leaders.

As in controller-runtime, ``on_started_leading`` fires on gaining the
lease (bind the controllers then); an ERROR step (an API blip, a lost
write race) keeps a leader whose own deadline has not passed; losing an
acquired lease is fatal (``on_stopped_leading``, and the loop ends: a
half-demoted process would go on writing through its watches); and the
lease is released, its deadline set to 0, when the loop ends.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid

from nos_tpu_torch.api.constants import GROUP
from nos_tpu_torch.kube.client import Conflict, KIND_CONFIGMAP, NotFound
from nos_tpu_torch.kube.objects import ConfigMap, ObjectMeta

logger = logging.getLogger(__name__)

ANN_HOLDER = f"{GROUP}/leader"
ANN_DEADLINE = f"{GROUP}/lease-renew-deadline"


class LeaderElector:
    """Take and renew a named lease; ``is_leader`` is set while held.
    ``run(stop)`` is the take/renew loop (``cmd/_runtime.Main`` starts it
    on a thread and gates its run loops on ``is_leader``)."""

    # one election step's outcome
    LEADING = "leading"   # we hold the lease (deadline refreshed)
    BLOCKED = "blocked"   # another identity holds a live lease
    ERROR = "error"       # could not tell (an API blip, a lost race)

    def __init__(self, api, name: str, namespace: str = "nos-tpu-system",
                 identity: str | None = None,
                 lease_duration_s: float = 15.0,
                 renew_s: float = 5.0,
                 retry_s: float = 2.0,
                 clock=time.time,  # wall clock: deadlines cross processes
                 on_started_leading=None,
                 on_stopped_leading=None) -> None:
        self._api = api
        self._name = name
        self._ns = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self._duration = lease_duration_s
        self._renew = renew_s
        self._retry = retry_s
        self._clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.is_leader = threading.Event()
        self._held_until = 0.0   # the deadline of the last lease we wrote

    def try_acquire_or_renew(self) -> str:
        """One election step.  BLOCKED is definitive (someone else's live
        lease was read); ERROR is not."""
        now = self._clock()
        deadline = now + self._duration
        try:
            cm = self._api.try_get(KIND_CONFIGMAP, self._name, self._ns)
            if cm is None:
                cm = ConfigMap(metadata=ObjectMeta(
                    name=self._name, namespace=self._ns,
                    annotations={ANN_HOLDER: self.identity,
                                 ANN_DEADLINE: str(deadline)}))
                try:
                    self._api.create(KIND_CONFIGMAP, cm)
                except NotFound:
                    # the lease's namespace is missing: a misconfiguration,
                    # not someone else leading
                    logger.error(
                        "leader election %s: cannot create lease in "
                        "namespace %r (does it exist?)",
                        self._name, self._ns)
                    return self.ERROR
                logger.info("leader election %s: %s acquired",
                            self._name, self.identity)
                self._held_until = deadline
                return self.LEADING
            anns = cm.metadata.annotations
            holder = anns.get(ANN_HOLDER, "")
            try:
                held_until = float(anns.get(ANN_DEADLINE, "0"))
            except ValueError:
                held_until = 0.0
            if holder != self.identity and held_until > now:
                return self.BLOCKED
            anns[ANN_HOLDER] = self.identity
            anns[ANN_DEADLINE] = str(deadline)
            # the update carries the version read: a Conflict means
            # another candidate won, and is not retried
            # noslint: N001 — retrying the lost CAS would steal the winner's lease
            self._api.update(KIND_CONFIGMAP, cm)
            if holder != self.identity:
                logger.info("leader election %s: %s took over from %s",
                            self._name, self.identity, holder or "<none>")
            self._held_until = deadline
            return self.LEADING
        except (Conflict, NotFound):
            return self.ERROR   # lost a write race: read again next step
        except Exception as e:  # noqa: BLE001 — a blip must not end election
            logger.warning("leader election %s: step failed (%s); retrying",
                           self._name, e)
            return self.ERROR

    def run(self, stop: threading.Event) -> None:
        """The take/renew loop until ``stop``; releases the lease on
        exit.  Losing an acquired lease calls ``on_stopped_leading`` and
        ends the loop."""
        led = False
        try:
            while not stop.is_set():
                outcome = self.try_acquire_or_renew()
                if outcome == self.LEADING:
                    if not led:
                        led = True
                        if self.on_started_leading is not None:
                            self.on_started_leading()
                    self.is_leader.set()
                    stop.wait(self._renew)
                    continue
                if led and outcome == self.ERROR \
                        and self._clock() < self._held_until:
                    # our lease is still valid: retry until its deadline
                    stop.wait(self._retry)
                    continue
                if led:
                    logger.error(
                        "leader election %s: %s LOST the lease — "
                        "stopping (restart to rejoin as candidate)",
                        self._name, self.identity)
                    self.is_leader.clear()
                    if self.on_stopped_leading is not None:
                        self.on_stopped_leading()
                    return
                self.is_leader.clear()
                stop.wait(self._retry)
        finally:
            self.is_leader.clear()
            self._release()

    def _release(self) -> None:
        """Set our lease's deadline to 0, so a successor takes over at
        its next step."""
        try:
            def mutate(cm: ConfigMap) -> None:
                anns = cm.metadata.annotations
                if anns.get(ANN_HOLDER) == self.identity:
                    anns[ANN_DEADLINE] = "0"

            # noslint: N001 — best-effort lease drop on exit; must not retry against a successor
            self._api.patch(KIND_CONFIGMAP, self._name, self._ns,
                            mutate=mutate)
        except (Conflict, NotFound, OSError):
            pass
