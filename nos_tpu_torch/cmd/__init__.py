"""The port's mains, ``nos_tpu/cmd`` for the port: the reference's six
control-plane binaries and the training main.

Each control-plane main loads a typed, checked config (``--config``, a
YAML or JSON file of ``api/config.py``'s classes), assembles its
component against the API its config names (a cluster's kube-apiserver
through ``kubeconfig``, else an in-memory ``APIServer``) and runs named
reconcile loops with graceful SIGTERM shutdown, serving ``/healthz``,
``/readyz`` and ``/metrics`` on ``health_probe_addr``
(``cmd/_runtime.py``).  With ``leader_election`` a replica runs its
loops only while it holds a ConfigMap lease (``kube/leaderelection.py``):

- ``python -m nos_tpu_torch.cmd.partitioner --config p.json`` (the
  gpupartitioner; ``--sim N`` runs an in-memory demo cluster)
- ``python -m nos_tpu_torch.cmd.scheduler --config s.json``
- ``python -m nos_tpu_torch.cmd.operator --config o.json`` (the quota
  reconcilers and their admission webhook)
- ``python -m nos_tpu_torch.cmd.chipagent --config a.json --node N`` (the
  MPS node agent, gpuagent)
- ``python -m nos_tpu_torch.cmd.sliceagent --config a.json --node N
  [--device cpu]`` (the MIG node agent, migagent)
- ``python -m nos_tpu_torch.cmd.metricsexporter --source state.json
  --out m.json`` (one shot)
- ``python -m nos_tpu_torch.cmd.train --config t.json`` (the training
  main)
- ``python -m nos_tpu_torch.cmd.autoscaler --config a.json`` (the serving
  replica autoscaler)
- ``python -m nos_tpu_torch.cmd.provisioner --config c.json`` (the capacity
  provisioner; with ``enabled: false``, the default, it exits 0 and
  constructs nothing)
"""
