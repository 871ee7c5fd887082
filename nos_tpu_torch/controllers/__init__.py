"""The control plane's controllers, ``nos_tpu/controllers`` for the port:
the node and pod controllers that feed ``ClusterState``, the partitioner
controller, the MPS node agent and the kubelet's admission."""
