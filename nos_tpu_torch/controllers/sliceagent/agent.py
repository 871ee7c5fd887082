"""SliceAgent: the MIG node agent, reporter, actuator and their shared
state, ``nos_tpu/controllers/sliceagent/agent.py`` for the port
(reference cmd/migagent/migagent.go:56-199).

``start`` deletes the carved devices no pod holds, binds the kubelet
simulator and reports once; ``tick`` is one pass of the run loop (the
reference's 10 s report interval): the kubelet sweep, a report, the
actuation, and a second report when devices changed, so the decision
plane sees status = spec without waiting another interval.
"""

from __future__ import annotations

from nos_tpu_torch.controllers.kubelet import KubeletSim
from nos_tpu_torch.device.gpuclient import (
    GpuRuntimeClient, PodResourcesClient, SliceDeviceClient,
)
from nos_tpu_torch.device.plugin import DevicePluginClient
from nos_tpu_torch.kube.client import APIServer

from .actuator import SliceActuator
from .reporter import SliceReporter
from .shared import SharedState


class SliceAgent:
    def __init__(self, api: APIServer, node_name: str,
                 runtime: GpuRuntimeClient,
                 pod_resources: PodResourcesClient) -> None:
        self.api = api
        self.node_name = node_name
        self.runtime = runtime
        self.client = SliceDeviceClient(runtime, pod_resources)
        self.shared = SharedState()
        self.plugin = DevicePluginClient(api, node_name, runtime)
        self.reporter = SliceReporter(api, node_name, self.client,
                                      self.shared)
        self.actuator = SliceActuator(api, node_name, self.client,
                                      self.shared, self.plugin)
        # admission backed by the devices, so a bound pod's instances
        # read as used when the actuator plans
        self.kubelet = KubeletSim(api, node_name, self.client, pod_resources)

    def start(self) -> None:
        self.actuator.startup_cleanup()
        self.kubelet.bind()
        self.reporter.reconcile()

    def stop(self) -> None:
        """Detach from the API's watch: a replaced in-process agent's
        kubelet simulator would otherwise go on admitting pods against
        abandoned devices."""
        self.kubelet.unbind()

    def tick(self) -> bool:
        """One pass; True if devices changed."""
        self.kubelet.sweep()
        self.reporter.reconcile()
        changed = self.actuator.reconcile()
        if changed:
            self.reporter.reconcile()
        return changed
