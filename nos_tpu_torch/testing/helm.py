"""A minimal helm-template renderer, ``nos_tpu/testing/helm.py`` for the
port.

It implements exactly the template subset the port's chart keeps to
(``deploy/helm/nos-tpu-torch/templates/_helpers.tpl`` states it):
``.Values/.Release/.Chart`` lookups, ``| default X``, ``{{- if <path> }}
... {{- end }}`` (nested too), and the named helpers.  Anything outside
the subset raises, so the chart stays renderable without helm:
``tests/test_torch_deploy.py`` renders it and loads every rendered
config through ``api/config.py``.
"""

from __future__ import annotations

import pathlib
import re


def _lookup(ctx: dict, path: str):
    cur: object = ctx
    for part in path.split("."):
        if not part:
            continue
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(f"template references unknown value .{path}")
        cur = cur[part]
    return cur


def _render_expr(expr: str, ctx: dict) -> str:
    expr = expr.strip()
    if expr.startswith("include "):
        name = expr.split('"')[1]
        return ctx["__helpers__"][name]
    parts = [p.strip() for p in expr.split("|")]
    val = _lookup(ctx, parts[0].lstrip("."))
    for f in parts[1:]:
        if f.startswith("default "):
            arg = f[len("default "):].strip()
            if val in ("", None):
                val = _lookup(ctx, arg.lstrip("."))
        else:
            raise AssertionError(f"unsupported template function: {f}")
    if isinstance(val, bool):
        return "true" if val else "false"
    return str(val)


def render(text: str, ctx: dict) -> str:
    """Render one template file against the context."""
    # strip comment blocks
    text = re.sub(r"\{\{-?\s*/\*.*?\*/\s*-?\}\}", "", text, flags=re.S)

    # if/end blocks, innermost-first so nesting works (the webhook bits
    # sit inside the operator.enabled guard)
    def do_if(m):
        cond = _lookup(ctx, m.group(1).lstrip("."))
        return m.group(2) if cond else ""
    innermost = re.compile(
        r"\{\{-?\s*if\s+([.\w]+)\s*-?\}\}\n?"
        r"((?:(?!\{\{-?\s*(?:if|end)\b).)*?)"
        r"\{\{-?\s*end\s*-?\}\}\n?",
        flags=re.S)
    while True:
        text, n = innermost.subn(do_if, text)
        if not n:
            break
    # expressions
    text = re.sub(r"\{\{-?\s*([^{}]+?)\s*-?\}\}",
                  lambda m: _render_expr(m.group(1), ctx), text)
    return text


def default_context(chart_dir: pathlib.Path,
                    app_version: str = "0.1.0") -> dict:
    """The context `helm template` would build from values.yaml, with the
    port chart's names and helpers."""
    import yaml

    values = yaml.safe_load((chart_dir / "values.yaml").read_text())
    return {
        "Values": values,
        "Chart": {"AppVersion": app_version, "Name": "nos-tpu-torch"},
        "Release": {"Name": "nos-tpu-torch",
                    "Namespace": values["namespace"]},
        "__helpers__": {
            "nos-tpu-torch.tag": app_version,
            "nos-tpu-torch.labels": (
                "app.kubernetes.io/part-of: nos-tpu-torch\n"
                "app.kubernetes.io/managed-by: Helm"),
        },
    }


# Rendered ConfigMap name -> the name of its config class in
# api/config.py.  A rendered ConfigMap with a config.yaml key that is not
# here is an error at render time, never skipped, so a new main's config
# cannot be half wired.
CONFIG_KINDS = {
    "nos-tpu-torch-scheduler-config": "SchedulerConfig",
    "nos-tpu-torch-operator-config": "OperatorConfig",
    "nos-tpu-torch-partitioner-config": "PartitionerConfig",
    "nos-tpu-torch-sliceagent-config": "AgentConfig",
    "nos-tpu-torch-chipagent-config": "AgentConfig",
    "nos-tpu-torch-autoscaler-config": "AutoscalerConfig",
    "nos-tpu-torch-provisioner-config": "ProvisionerConfig",
}


def validate_configmaps(docs: list[dict],
                        mounted_kubeconfig: str = "") -> int:
    """Round-trip every rendered config.yaml ConfigMap through its typed
    loader; returns the number validated.  Unknown config ConfigMaps and
    loader rejections raise.  ``mounted_kubeconfig`` is the path where
    the cluster mounts the kubeconfig Secret when a pod starts: a config
    naming it is checked in everything but that file's presence."""
    import tempfile

    from nos_tpu_torch.api import config as cfg_mod
    from nos_tpu_torch.api.config import load_config

    checked = 0
    for doc in docs:
        if doc.get("kind") != "ConfigMap" \
                or "config.yaml" not in doc.get("data", {}):
            continue
        name = doc["metadata"]["name"]
        cls_name = CONFIG_KINDS.get(name)
        if cls_name is None:
            raise AssertionError(
                f"rendered ConfigMap {name!r} carries a config.yaml but "
                f"is not in testing.helm.CONFIG_KINDS: wire its typed "
                f"loader so the render stays validated")
        cls = getattr(cfg_mod, cls_name)
        with tempfile.NamedTemporaryFile("w", suffix=".yaml") as f:
            f.write(doc["data"]["config.yaml"])
            f.flush()
            cfg = load_config(f.name, cls, validate=False)
        # agent configs validate node_name at runtime (--node)
        if cls_name != "AgentConfig":
            if mounted_kubeconfig and cfg.kubeconfig == mounted_kubeconfig:
                cfg.kubeconfig = ""
            cfg.validate()
        checked += 1
    return checked


def render_chart(chart_dir: pathlib.Path,
                 ctx: dict | None = None) -> list[dict]:
    """Every template in the chart rendered to parsed manifests."""
    import yaml

    ctx = ctx or default_context(chart_dir)
    docs: list[dict] = []
    for path in sorted(chart_dir.glob("templates/**/*.yaml")):
        out = render(path.read_text(), ctx)
        for doc in yaml.safe_load_all(out):
            if doc is not None:
                docs.append(doc)
    return docs
