#!/usr/bin/env python3
"""Render the PyTorch port's helm chart WITHOUT helm and validate the
output: every manifest parses, every rendered ConfigMap loads through
the port's typed config loaders (a config a main would refuse fails
the render; a kubeconfig Secret is mounted only when a pod starts, so
its file is the one thing not checked), and the chart's CRDs parse.

    python3 hack/render-chart-torch.py             # validate, print summary
    python3 hack/render-chart-torch.py --out DIR   # also write manifests
    python3 hack/render-chart-torch.py --set sliceagent.device=cpu

It renders through nos_tpu_torch/testing/helm.py, the renderer
tests/test_torch_deploy.py uses, so this script and the tests cannot
disagree about what the chart renders to.  It needs python3 and pyyaml
only: the control plane imports no torch.  Exit 1, with the reason on
stderr, when a template, a value or a config is refused.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHART = ROOT / "deploy/helm/nos-tpu-torch"


def _set(ctx: dict, assignment: str) -> None:
    """``a.b=value`` over the chart's values; the key must exist, and the
    value is read as YAML (``true``, ``0.5``, ``cpu``)."""
    import yaml

    path, sep, raw = assignment.partition("=")
    if not sep:
        raise ValueError(f"--set {assignment!r}: not KEY=VALUE")
    cur = ctx["Values"]
    *head, last = path.split(".")
    for part in head:
        cur = cur.get(part) if isinstance(cur, dict) else None
    if not isinstance(cur, dict) or last not in cur:
        raise ValueError(f"--set {path}: the chart has no such value")
    cur[last] = yaml.safe_load(raw)


def render(chart: pathlib.Path, sets: list[str]) -> tuple[list, list, int]:
    """The rendered manifests, the parsed CRDs and the number of
    ConfigMaps validated."""
    import yaml

    from nos_tpu_torch.testing.helm import (
        default_context, render_chart, validate_configmaps)

    ctx = default_context(chart)
    for assignment in sets:
        _set(ctx, assignment)
    docs = render_chart(chart, ctx)
    crds = [yaml.safe_load(p.read_text())
            for p in sorted((chart / "crds").glob("*.yaml"))]
    for crd in crds:
        if crd.get("kind") != "CustomResourceDefinition":
            raise ValueError(f"{crd.get('metadata', {}).get('name')!r} in "
                             f"crds/ is not a CustomResourceDefinition")
    kube = ctx["Values"]["kubeconfig"]
    mounted = f"{kube['mountPath']}/config" if kube["secret"] else ""
    return docs, crds, validate_configmaps(docs, mounted)


def main(argv: list[str] | None = None) -> int:
    import yaml

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory to write the rendered manifests into")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override a value of values.yaml (repeatable)")
    args = ap.parse_args(argv)

    try:
        docs, crds, configs_checked = render(CHART, args.sets)
    except Exception as e:   # any refusal is the render's verdict
        print(f"render-chart-torch: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "nos-tpu-torch.yaml", "w") as f:
            yaml.safe_dump_all(docs, f, sort_keys=False)
        with open(out / "crds.yaml", "w") as f:
            yaml.safe_dump_all(crds, f, sort_keys=False)
        print(f"wrote {out}/nos-tpu-torch.yaml + {out}/crds.yaml")

    kinds: dict[str, int] = {}
    for doc in docs:
        kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
    print(f"rendered {len(docs)} manifests from {CHART.name}: "
          + ", ".join(f"{k} x{v}" for k, v in sorted(kinds.items())))
    print(f"validated {configs_checked} ConfigMaps through the typed "
          f"loaders; {len(crds)} CRDs parsed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
