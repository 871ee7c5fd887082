#!/usr/bin/env bash
# Dev-cluster on-ramp for the PyTorch port (nos_tpu_torch/, chart
# deploy/helm/nos-tpu-torch/).  Three modes:
#
#   ./hack/dev-cluster-torch.sh render   render and validate only: the
#                                        manifests `up` applies, every
#                                        ConfigMap loaded through the
#                                        port's typed config loaders.
#                                        Needs python3 and pyyaml only.
#   ./hack/dev-cluster-torch.sh up       build the image
#                                        (deploy/image/Dockerfile), create
#                                        a 3-node kind cluster
#                                        (hack/kind/cluster-torch.yaml),
#                                        load the image, install the CRDs
#                                        and the rendered chart, wait for
#                                        the mains.  Needs kind, kubectl
#                                        and docker.
#   ./hack/dev-cluster-torch.sh down     delete the kind cluster.
#
# The kind workers have no GPU: `up` renders the MIG agent on the fake
# runtime (sliceagent.device=cpu) and names the H100 model to both node
# agents, and the mains reach the apiserver through the cluster's
# internal kubeconfig, mounted from a Secret.  `render` is the half that
# runs anywhere; tests/test_torch_deploy.py runs it.
set -euo pipefail
cd "$(dirname "$0")/.."

CLUSTER=nos-tpu-torch-dev
NAMESPACE=nos-tpu-torch-system
KUBE_SECRET=nos-tpu-torch-kube
MODEL=nvidia-h100-80gb-hbm3
OUT="${OUT:-${TMPDIR:-/tmp}/nos-tpu-torch-rendered}"
IMAGE=ghcr.io/nos-tpu/nos-tpu-torch
TAG=0.1.0

render() {
    python3 hack/render-chart-torch.py --out "$OUT" "$@"
}

case "${1:-render}" in
  render)
    render
    ;;
  up)
    for tool in kind kubectl docker; do
        command -v "$tool" >/dev/null || {
            echo "$tool not found; './hack/dev-cluster-torch.sh render'" \
                "needs only python3" >&2; exit 1; }
    done
    render --set kubeconfig.secret="$KUBE_SECRET" \
        --set sliceagent.device=cpu --set sliceagent.model="$MODEL" \
        --set chipagent.model="$MODEL"
    # The chart's image under its default name and tag, side-loaded into
    # kind (nothing is published there; imagePullPolicy IfNotPresent
    # takes the loaded copy).  SKIP_BUILD=1 reuses an earlier build.
    if [ -z "${SKIP_BUILD:-}" ]; then
        docker build -f deploy/image/Dockerfile -t "$IMAGE:$TAG" .
        docker build -f deploy/image/Dockerfile --target workload \
            -t "$IMAGE-train:$TAG" .
    fi
    kind create cluster --name "$CLUSTER" --config hack/kind/cluster-torch.yaml
    kind load docker-image --name "$CLUSTER" "$IMAGE:$TAG" "$IMAGE-train:$TAG"
    kubectl apply -k deploy/config-torch
    kubectl create namespace "$NAMESPACE" --dry-run=client -o yaml \
        | kubectl apply -f -
    kubeconfig="$(mktemp)"
    trap 'rm -f "$kubeconfig"' EXIT
    kind get kubeconfig --internal --name "$CLUSTER" > "$kubeconfig"
    kubectl -n "$NAMESPACE" create secret generic "$KUBE_SECRET" \
        --from-file=config="$kubeconfig" --dry-run=client -o yaml \
        | kubectl apply -f -
    kubectl apply -f "$OUT/nos-tpu-torch.yaml"
    kubectl -n "$NAMESPACE" wait --for=condition=Available deployment \
        --all --timeout=300s
    echo "nos-tpu-torch dev cluster '$CLUSTER' is up; try:"
    echo "  kubectl -n $NAMESPACE get pods"
    echo "  kubectl apply -f deploy/config-torch/serving-pod-example.yaml"
    ;;
  down)
    kind delete cluster --name "$CLUSTER"
    ;;
  *)
    echo "usage: $0 {render|up|down}" >&2
    exit 2
    ;;
esac
