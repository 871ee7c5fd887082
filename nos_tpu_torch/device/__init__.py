"""Device layer: the native boundary (NVML) and its fakes, the port of
``nos_tpu/device``.

Reference analogs: pkg/gpu/nvml (CGo boundary), pkg/gpu/mig/client.go,
pkg/resource (kubelet pod-resources).
"""

from .gpuclient import GpuRuntimeClient, PodResourcesClient, SliceDeviceClient


def default_gpu_runtime(model=None, device="cuda") -> GpuRuntimeClient:
    """The host's GPU runtime: NVML on the card (``NvmlGpuRuntime``), the
    stateful fake only when ``device="cpu"`` is passed.

    This departs on purpose from the JAX package's ``default_tpu_runtime``,
    which falls back quietly from its native shim to the fake: the port
    runs on the card unless asked for the CPU, and a fallback would hide
    a missing driver behind fake devices.  So without NVML this raises
    (``nvml.NvmlUnavailable``).  ``model=None`` discovers the model: from
    NVML's product name on the card, from ``discovery`` (NVML, else the
    configured H100) for the fake."""
    import torch

    if torch.device(device).type == "cpu":
        from .fake import FakeGpuRuntime

        if model is None:
            from . import discovery

            model = discovery.discover(allow_cuda=False).model
        return FakeGpuRuntime(model)
    from .nvml import NvmlGpuRuntime

    return NvmlGpuRuntime(model)


__all__ = [
    "GpuRuntimeClient", "PodResourcesClient", "SliceDeviceClient",
    "default_gpu_runtime",
]
