"""The Kubernetes object model and the in-memory API server the port's
control plane writes to, ``nos_tpu/kube`` for the port."""
