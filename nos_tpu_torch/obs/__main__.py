"""``python -m nos_tpu_torch.obs``, ``nos_tpu/obs/__main__.py`` for the
port: explain pods and plans, report SLO verdicts, render the fleet
scoreboard or the chip-second waste waterfall (a chip is one GPU), dump
the recorder, or self-test the subsystem.

    python -m nos_tpu_torch.obs explain pod <ns>/<name> --snapshot flight.json
    python -m nos_tpu_torch.obs explain plan [--kind mps] --url http://host:8080
    python -m nos_tpu_torch.obs slo --url http://host:8080
    python -m nos_tpu_torch.obs top --url http://host:8080 [--watch 5]
    python -m nos_tpu_torch.obs waste --url http://host:8080
    python -m nos_tpu_torch.obs dump --url http://host:8080
    python -m nos_tpu_torch.obs --selftest

A snapshot comes from ``--snapshot FILE`` (a saved
/debug/flightrecorder, /snapshot or /debug/slo payload; ``-`` is stdin)
or ``--url ADDR``, a main's health server: /snapshot for ``top``,
/debug/flightrecorder for the rest.  ``capacity`` renders the provisioner
main's ``capacity`` block (``capacity/provisioner.py``) and ``top``'s
request rows a ``requests`` block; each answers as the JAX CLI does when
its block is absent.
``--selftest`` checks spans, the journal, explain, the sampler, the SLO
engine and the ledger in process, with no cluster.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import explain_plan, explain_pod
from . import journal as J


def _load_snapshot(args: argparse.Namespace,
                   endpoint: str = "/debug/flightrecorder") -> dict:
    snapshot: dict
    if args.url:
        from urllib.request import urlopen

        url = args.url.rstrip("/") + endpoint
        with urlopen(url, timeout=10.0) as resp:   # noqa: S310 — operator URL
            snapshot = json.load(resp)
            return snapshot
    if args.snapshot == "-":
        snapshot = json.load(sys.stdin)
        return snapshot
    if args.snapshot:
        with open(args.snapshot, encoding="utf-8") as fh:
            snapshot = json.load(fh)
            return snapshot
    raise SystemExit(
        "no snapshot source: pass --snapshot FILE (or '-') or --url ADDR "
        f"(the health server serves {endpoint})")


def _find_slo_block(payload: dict) -> dict | None:
    """The SLO report inside any payload shape we serve: a /debug/slo
    body (verdicts at top level), a flight/state snapshot or bench
    output carrying an "slo" block, or bench.py's single JSON nesting
    the utilization block."""
    if "verdicts" in payload and "objectives" in payload:
        return payload
    for holder in (payload, payload.get("utilization", {})):
        block = holder.get("slo") if isinstance(holder, dict) else None
        if isinstance(block, dict) and "verdicts" in block:
            return block
    return None


def _fmt(v: object, digits: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def _find_waste_block(payload: dict) -> dict | None:
    """The chip-second waterfall inside any payload shape we serve: a
    flight/state snapshot carrying "waste", a bench_utilization result
    (top level), or bench.py's single JSON nesting the utilization
    block."""
    for holder in (payload, payload.get("utilization", {})):
        block = holder.get("waste") if isinstance(holder, dict) else None
        if isinstance(block, dict) and "pools" in block:
            return block
    return None


def _find_requests_block(payload: dict) -> dict | None:
    """The per-service request-path stats inside any payload shape we
    serve: a bench_requests report carrying "requests" (rows keyed by
    service, written by its Sim._request_stats) at top level or nested
    under the utilization block."""
    for holder in (payload, payload.get("utilization", {})):
        block = holder.get("requests") if isinstance(holder, dict) \
            else None
        if isinstance(block, dict) and block and \
                all(isinstance(row, dict) for row in block.values()):
            return block
    return None


def _rejecting_plugin(journal: list[dict], slo_class: str) -> str:
    """Newest pod-rejected record of this workload class → its plugin
    (or the dominant per-node reason): the one-command join from an SLO
    breach to the decision that causes it."""
    for rec in reversed(journal):
        if rec.get("category") != "pod-rejected":
            continue
        attrs = rec.get("attrs", {})
        if attrs.get("class") != slo_class:
            continue
        if attrs.get("plugin"):
            return str(attrs["plugin"])
        counts = attrs.get("reason_counts") or {}
        if counts:
            top = max(counts.items(), key=lambda kv: kv[1])[0]
            return str(top).split(":")[0]
        return attrs.get("reason") or "unknown"
    return ""


def _request_breach_cause(journal: list[dict], service: str
                          ) -> list[str]:
    """Join a request-latency breach to its cause, mirroring the
    breach→rejecting-plugin join: a REQUEST_SHED record for the service
    means the router is saturating (admission queues still full after
    the retry ladder); an autoscaler scale-up for one of the service's
    pools means KV pressure with capacity already on the way; neither
    on record points at the scheduler path instead (new replicas
    pending placement)."""
    def _mine(rec: dict) -> bool:
        subj = str(rec.get("subject", ""))
        return subj.split("/")[-1] == service or service in subj

    shed: dict | None = None
    scale: dict | None = None
    for rec in reversed(journal):
        cat = rec.get("category")
        if shed is None and cat == J.REQUEST_SHED and _mine(rec):
            shed = rec
        elif scale is None and cat == J.AUTOSCALE and _mine(rec) \
                and rec.get("attrs", {}).get("direction") == "up":
            scale = rec
        if shed is not None and scale is not None:
            break
    lines: list[str] = []
    if shed is not None:
        a = shed.get("attrs", {})
        lines.append(
            f"router saturation: {shed.get('subject')} shed "
            f"rid={a.get('rid')} phase={a.get('phase')} after "
            f"{a.get('retries')} retries — replicas full past the "
            "retry ladder")
    if scale is not None:
        a = scale.get("attrs", {})
        lines.append(
            f"scale-up in flight: {scale.get('subject')} "
            f"+{a.get('count')} replica(s) — KV pressure, capacity "
            "catching up")
    if not lines:
        lines.append(
            "no shed or scale-up on record — suspect the scheduler "
            "path: check the serving tier's schedule-latency verdict "
            "and `explain pod` a pending replica")
    return lines


def cmd_slo(payload: dict) -> int:
    """Render the SLO report: per objective/class — value vs target,
    burn rates, budget remaining, breach verdict (journal-joined to the
    rejecting plugin when the payload carries a journal)."""
    block = _find_slo_block(payload)
    if block is None:
        print("payload carries no SLO report — is an engine installed "
              "(Main.attach_slo)?",
              file=sys.stderr)
        return 1
    journal = payload.get("journal", [])
    verdicts = block.get("verdicts", [])
    print(f"SLO report (fast window {block.get('fast_window_s')}s, "
          f"slow {block.get('slow_window_s')}s, burn threshold "
          f"{block.get('burn_threshold')}):")
    if not verdicts:
        print("  no verdicts yet (engine has not evaluated a window)")
        return 0
    breached = 0
    for v in verdicts:
        state = "BREACH" if v.get("breached") else "ok"
        cls = v.get("class") or "-"
        line = (f"  [{state}] {v.get('objective')} class={cls}: "
                f"value={_fmt(v.get('value'), 3)} "
                f"target={_fmt(v.get('target'), 3)} "
                f"burn fast/slow={_fmt(v.get('burn_fast'))}"
                f"/{_fmt(v.get('burn_slow'))} "
                f"budget remaining={_fmt(v.get('budget_remaining'))}")
        print(line)
        if v.get("breached"):
            breached += 1
            if v.get("metric") == "nos_tpu_request_latency_seconds":
                for cause in _request_breach_cause(journal, cls):
                    print(f"         {cause}")
                continue
            plugin = _rejecting_plugin(journal, cls)
            if plugin:
                print(f"         rejecting plugin for class {cls}: "
                      f"{plugin} — `explain pod` a pending pod of this "
                      "class for the per-node chain")
    print(f"{breached} breached / {len(verdicts)} verdict(s)")
    return 0


def _print_tier_rows(pending: dict, block: dict | None) -> None:
    """Per-tier scoreboard rows (serving / batch / best-effort):
    pending pods, worst schedule-latency p99 and the smallest SLO
    budget remaining among the tier's classes — the one-shot view that
    answers "is the protected tier healthy and who is waiting behind
    it"."""
    from nos_tpu_torch.utils.pod_util import class_tier

    pend_by_tier: dict[str, int] = {}
    for cls, n in pending.items():
        tier = class_tier(cls)
        pend_by_tier[tier] = pend_by_tier.get(tier, 0) + n
    p99: dict[str, float | None] = {}
    budget: dict[str, float | None] = {}
    breached: dict[str, bool] = {}
    for v in (block or {}).get("verdicts", []):
        if v.get("metric") != "nos_tpu_schedule_latency_seconds":
            continue
        tier = class_tier(str(v.get("class") or ""))
        val, rem = v.get("value"), v.get("budget_remaining")
        if val is not None and (p99.get(tier) is None
                                or val > p99[tier]):
            p99[tier] = val
        if rem is not None and (budget.get(tier) is None
                                or rem < budget[tier]):
            budget[tier] = rem
        breached[tier] = breached.get(tier, False) \
            or bool(v.get("breached"))
    print("tier           pending  p99(s)  budget")
    for tier in ("serving", "batch", "best-effort"):
        state = " [BREACH]" if breached.get(tier) else ""
        print(f"  {tier:<12} {pend_by_tier.get(tier, 0):>7} "
              f"{_fmt(p99.get(tier), 3):>7} "
              f"{_fmt(budget.get(tier)):>7}{state}")


def cmd_top(payload: dict) -> int:
    """One-shot fleet scoreboard from a /snapshot payload: utilization,
    per-pool fragmentation, pending-by-class, SLO budget remaining.  A
    pool is an NVLink domain ("-" unlabelled), a node's capacity its
    ``nvidia.com/gpu.count``, and a bound pod holds its whole GPUs, MPS
    shares and MIG instances at the planner's candidate weights (a
    whole GPU or a share one GPU, a MIG instance g/7)."""
    state = payload.get("state")
    if not isinstance(state, dict):
        print("payload carries no cluster state — `obs top` wants the "
              "/snapshot endpoint (or its saved JSON), not "
              "/debug/flightrecorder", file=sys.stderr)
        return 1
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_NODE, KIND_POD
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.kube.serialize import load_state
    from nos_tpu_torch.partitioning.core.snapshot import _gpu_sevenths
    from nos_tpu_torch.utils.pod_util import workload_class

    from .ledger import stranded_fraction

    api = load_state(state)
    pools: dict[str, dict] = {}
    node_pool: dict[str, str] = {}
    cap_by_node: dict[str, float] = {}
    for node in api.list(KIND_NODE):
        pool = node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "") or "-"
        node_pool[node.metadata.name] = pool
        agg = pools.setdefault(pool, {"hosts": 0, "gpus": 0.0,
                                      "used": 0.0})
        agg["hosts"] += 1
        try:
            cap = float(
                node.metadata.labels.get(C.LABEL_GPU_COUNT, "0") or 0)
        except ValueError:
            cap = 0.0
        cap_by_node[node.metadata.name] = cap
        agg["gpus"] += cap
    pending: dict[str, int] = {}
    used_by_node: dict[str, float] = {}
    for pod in api.list(KIND_POD):
        if not pod.spec.node_name:
            cls = workload_class(pod)
            pending[cls] = pending.get(cls, 0) + 1
            continue
        used_by_node.setdefault(pod.spec.node_name, 0.0)
        used_by_node[pod.spec.node_name] += sum(
            _gpu_sevenths(r, q) for r, q in pod_request(pod).items()
            if q > 0) / 7.0
    # per pool: free GPUs by host and the offline stranded set (hosts
    # already running something); the sum is the ledger's shared
    # stranded-free helper, the live scheduler flags hosts from its
    # rejection verdicts instead
    free_by_pool: dict[str, dict[str, float]] = {}
    busy_by_pool: dict[str, set[str]] = {}
    for name, pool in node_pool.items():
        used = used_by_node.get(name, 0.0)
        pools[pool]["used"] += used
        free_by_pool.setdefault(pool, {})[name] = \
            max(0.0, cap_by_node.get(name, 0.0) - used)
        if used > 0:
            busy_by_pool.setdefault(pool, set()).add(name)

    total_gpus = sum(p["gpus"] for p in pools.values())
    total_used = sum(p["used"] for p in pools.values())
    util = total_used / total_gpus if total_gpus else 0.0
    print(f"fleet: {sum(p['hosts'] for p in pools.values())} host(s), "
          f"{total_gpus:g} GPUs, utilization {util:.3f}")
    print("pool             hosts   gpus   used   free  util  frag")
    for pool in sorted(pools):
        p = pools[pool]
        free = max(0.0, p["gpus"] - p["used"])
        putil = p["used"] / p["gpus"] if p["gpus"] else 0.0
        frag = stranded_fraction(free_by_pool.get(pool, {}),
                                 busy_by_pool.get(pool, set()))
        print(f"{pool:<16} {p['hosts']:>5} {p['gpus']:>6g} "
              f"{p['used']:>6.1f} {free:>6.1f} {putil:>5.2f} "
              f"{max(0.0, frag):>5.2f}")
    waste = _find_waste_block(payload)
    if waste is not None and waste.get("pools"):
        print("waste waterfall (GPU-seconds, share of capacity):")
        for pool in sorted(waste["pools"]):
            wp = waste["pools"][pool]
            fr = wp.get("fractions", {})
            top = sorted(((c, f) for c, f in fr.items()
                          if c != "productive" and f > 0.0),
                         key=lambda kv: -kv[1])[:3]
            steps = "  ".join(f"{c}={f * 100:.1f}%" for c, f in top) \
                or "no waste recorded"
            print(f"  {pool:<14} productive="
                  f"{fr.get('productive', 0.0) * 100:.1f}%  {steps}")
        print("  (`obs waste` ranks the sources and names culprits)")
    if pending:
        print("pending by class:")
        for cls in sorted(pending):
            print(f"  {cls:<20} {pending[cls]}")
    else:
        print("pending by class: none")
    reqs_block = _find_requests_block(payload)
    if reqs_block:
        trace_s = payload.get("trace_seconds")
        print("requests by service:")
        print("  service             req/s  ttft-p99  p99(s)  kv-occ"
              "  shed")
        for key in sorted(reqs_block):
            row = reqs_block[key]
            rate = None
            if isinstance(trace_s, (int, float)) and trace_s > 0:
                rate = float(row.get("completed", 0)) / trace_s
            print(f"  {key:<18} {_fmt(rate):>6} "
                  f"{_fmt(row.get('ttft_p99_s'), 3):>9} "
                  f"{_fmt(row.get('p99_s'), 3):>7} "
                  f"{_fmt(row.get('occupancy_mean_max')):>7} "
                  f"{row.get('shed', 0):>5}")
    block = _find_slo_block(payload)
    _print_tier_rows(pending, block)
    if block is not None and block.get("verdicts"):
        print("SLO budget remaining:")
        for v in block["verdicts"]:
            state_s = "BREACH" if v.get("breached") else "ok"
            print(f"  {v.get('objective')}/{v.get('class') or '-':<16} "
                  f"{_fmt(v.get('budget_remaining'))} [{state_s}]")
    return 0


def _newest(journal: list[dict], category: str,
            subject: str | None = None,
            attr_match: dict | None = None) -> dict | None:
    """Newest journal record of `category` matching subject/attrs."""
    for rec in reversed(journal):
        if rec.get("category") != category:
            continue
        if subject is not None and rec.get("subject") != subject:
            continue
        attrs = rec.get("attrs", {})
        if attr_match and any(attrs.get(k) != v
                              for k, v in attr_match.items()):
            continue
        return rec
    return None


def _waste_culprit(journal: list[dict], category: str,
                   evidence: dict) -> list[str]:
    """Join one waste category's culprit evidence to its journal
    record — the same flight-recorder-first workflow as `explain`/`slo`
    (each category's evidence keys are written by its owning call
    site)."""
    lines: list[str] = []
    if category == "frag_stranded" and evidence.get("class"):
        # Ranked culprits: when several classes strand the same pool the
        # evidence carries them ordered by stranded chip-seconds (the
        # scheduler's per-class integral) — the class that has waited
        # with the most blocked chips the longest leads, NOT whichever
        # rejection happens to be newest.  Old snapshots without the
        # ranking degrade to the single-class join.
        ranked = evidence.get("classes") or [
            {"class": evidence["class"],
             "rejected_nodes": evidence.get("rejected_nodes", "?")}]
        cls = str(ranked[0].get("class", evidence["class"]))
        displaced = (f" (displaced: {evidence['displaced_cause']})"
                     if evidence.get("displaced_cause") else "")
        lines.append(f"culprit class {cls}: rejected on "
                     f"{evidence.get('rejected_nodes', '?')} "
                     f"node(s){displaced}")
        for row in ranked[1:]:
            lines.append(
                f"also stranding: class {row.get('class', '?')} "
                f"({row.get('stranded_chip_seconds', '?')} stranded "
                "GPU-s)")
        rec = _newest(journal, J.POD_REJECTED, attr_match={"class": cls})
        if rec is not None:
            attrs = rec.get("attrs", {})
            counts = attrs.get("reason_counts") or {}
            why = (max(counts.items(), key=lambda kv: kv[1])[0]
                   if counts else attrs.get("message", ""))
            lines.append(f"newest rejection ({rec['subject']}): {why}")
            lines.append(f"next: `obs explain pod {rec['subject']}`")
        # Join to the defrag plane: the proposal that would (or did)
        # unlock this frag source, so the operator's next move is
        # named instead of implied.
        prop = _newest(journal, J.DEFRAG_APPLIED,
                       attr_match={"demand_class": cls}) \
            or _newest(journal, J.DEFRAG_APPLIED) \
            or _newest(journal, J.DEFRAG_PROPOSED) \
            or _newest(journal, J.DEFRAG_REJECTED)
        if prop is not None:
            attrs = prop.get("attrs", {})
            verb = {J.DEFRAG_APPLIED: "applied",
                    J.DEFRAG_PROPOSED: "proposed",
                    J.DEFRAG_REJECTED: "rejected"}[prop["category"]]
            lines.append(
                f"defrag: proposal {prop['subject']} ({verb}) — "
                f"hosts {attrs.get('hosts', '?')}, "
                f"{attrs.get('unlocked_chips', '?')} GPUs unlocked, "
                f"payback {attrs.get('payback', attrs.get('reason', '?'))}")
        else:
            lines.append("defrag: no proposal on record — enable "
                         "defrag_enabled (PartitionerConfig) to reclaim "
                         "this automatically")
    elif category in ("gang_wait", "drain") and evidence.get("gang"):
        gang = str(evidence["gang"])
        verb = ("assembly stalled" if category == "gang_wait"
                else "window bought by drain eviction")
        if evidence.get("displaced_cause"):
            # a displaced victim failing to rebind is a recovery
            # problem, not ordinary gang assembly — name the kill
            verb += f" (displaced: {evidence['displaced_cause']})"
        lines.append(f"culprit gang {gang}: {verb}")
        rec = _newest(journal, J.GANG_REJECTED, subject=gang)
        if rec is not None:
            attrs = rec.get("attrs", {})
            lines.append(
                f"newest gang verdict: {attrs.get('message', '?')} "
                f"(members: {attrs.get('members_total', '?')})")
    elif category == "actuation":
        kind = str(evidence.get("kind", "") or "?")
        lines.append(f"culprit plan: kind={kind} "
                     f"plan_id={evidence.get('plan_id', '?')} "
                     f"(node {evidence.get('node', '?')})")
        rec = _newest(journal, J.PLAN_CYCLE, subject=kind)
        if rec is not None:
            attrs = rec.get("attrs", {})
            lines.append(f"newest plan cycle: pods={attrs.get('pods')} "
                         f"actuated={attrs.get('actuated')} — "
                         "`obs explain plan` for the budget breakdown")
    elif category == "quarantine" and evidence.get("node"):
        node = str(evidence["node"])
        lines.append(f"culprit node {node}: "
                     f"{evidence.get('reason', '?')}")
        rec = _newest(journal, J.QUARANTINED, subject=node)
        if rec is not None:
            lines.append(f"quarantined (seq {rec['seq']}): "
                         f"{rec.get('attrs', {}).get('reason', '?')}")
    elif category == "provisioning":
        node = str(evidence.get("node", "") or "?")
        lines.append(f"culprit node {node}: create requested from "
                     f"{evidence.get('machine_class', '?')}/"
                     f"{evidence.get('zone', '?')}, not usable yet "
                     "(cloud is slow or stocked out — NOT idle slack)")
        stock = _newest(journal, J.PROVISION_STOCKOUT)
        if stock is not None:
            lines.append(f"newest breaker transition: {stock['subject']} "
                         f"-> {stock.get('attrs', {}).get('state', '?')}")
        rec = _newest(journal, J.PROVISION_REQUESTED, subject=node) \
            or _newest(journal, J.PROVISION_REQUESTED)
        if rec is not None:
            attrs = rec.get("attrs", {})
            lines.append(f"newest create request ({rec['subject']}): "
                         f"pool {attrs.get('pool', '?')} op "
                         f"{attrs.get('op', '?')}")
        lines.append("next: `obs capacity` for breaker states and "
                     "in-flight creates")
    elif category == "quota_stranded" and evidence.get("class"):
        cls = str(evidence["class"])
        lines.append(f"culprit class {cls}: "
                     f"{evidence.get('blocked_chips', '?')} GPU(s) of "
                     "demand blocked by borrowing limits")
        rec = _newest(journal, J.QUOTA_HOL_CLAIM) or _newest(
            journal, J.POD_REJECTED, attr_match={"class": cls})
        if rec is not None:
            lines.append(f"newest quota decision ({rec['category']}): "
                         f"{rec['subject']}")
    return lines


def cmd_waste(payload: dict) -> int:
    """Render the chip-second waste waterfall: per-pool category
    breakdown with the conservation verdict, then the fleet's top waste
    sources each joined to its journal evidence."""
    from .ledger import conservation_ok, waste_ranking

    block = _find_waste_block(payload)
    if block is None:
        print("payload carries no waste waterfall — fetch "
              "/debug/flightrecorder (or /snapshot) from a live main, "
              "or pass a saved snapshot JSON",
              file=sys.stderr)
        return 1
    journal = payload.get("journal", [])
    pools = block.get("pools", {})
    if not pools:
        print("waste waterfall: no pools observed yet (has a scheduler "
              "cycle run?)")
        return 0
    conserved = conservation_ok(block)
    print("GPU-second waste waterfall "
          f"(conservation: {'ok' if conserved else 'VIOLATED'}):")
    for pool in sorted(pools):
        p = pools[pool]
        cap_s = p.get("capacity_chip_seconds", 0.0)
        print(f"pool {pool}: {_fmt(p.get('capacity_chips'), 0)} GPUs x "
              f"{_fmt(p.get('elapsed_s'), 1)}s = {cap_s:.1f} GPU-s "
              f"(delta {p.get('conservation_delta', 0.0):+.2e})")
        rows = sorted(p.get("chip_seconds", {}).items(),
                      key=lambda kv: -kv[1])
        for cat, secs in rows:
            frac = p.get("fractions", {}).get(cat, 0.0)
            print(f"  {cat:<16} {secs:>12.1f}  {frac * 100:>5.1f}%")
    ranked = waste_ranking(block)
    if not ranked:
        print("no waste recorded — every GPU-second was productive")
        return 0
    print("top waste sources (fleet):")
    for i, row in enumerate(ranked, 1):
        cat = str(row["category"])
        print(f"  {i}. {cat:<16} {row['chip_seconds']:>12.1f} GPU-s "
              f"{row['fraction'] * 100:>5.1f}%")
        evidence: dict = {}
        for pool in pools.values():
            ev = pool.get("evidence", {}).get(cat)
            if ev:
                evidence = ev
                break
        for line in _waste_culprit(journal, cat, evidence):
            print(f"     {line}")
    flip = block.get("quota_last_flip")
    if flip:
        print(f"newest quota flip: {flip.get('pod')} "
              f"({'borrow' if flip.get('borrowed') else 'reclaim'}, "
              f"namespace {flip.get('namespace')})")
    return 0 if conserved else 1


def cmd_capacity(payload: dict) -> int:
    """Render the capacity plane's state: per-pool inventory vs the
    durable size record, stockout breaker states, in-flight creates,
    and the provisioning counters — the surface the troubleshooting
    runbook sends operators to when pending demand coexists with an
    `idle_no_demand` (or `provisioning`) deficit."""
    block = payload.get("capacity")
    if not isinstance(block, dict):
        print("payload carries no capacity block — the provisioner is "
              "disabled (off means off) or this snapshot predates it; "
              "fetch /debug/flightrecorder from the provisioner main",
              file=sys.stderr)
        return 1
    journal = payload.get("journal", [])
    pools = block.get("pools", {})
    print("capacity plane:")
    print(f"  pending demand {_fmt(block.get('pending_demand_chips'), 1)} "
          f"chips | free {_fmt(block.get('free_chips'), 1)} | arriving "
          f"{_fmt(block.get('arriving_chips'), 1)} | deficit "
          f"{_fmt(block.get('deficit_chips'), 1)}")
    for pool in sorted(pools):
        p = pools[pool]
        gap = int(p.get("recorded_size", 0)) - int(p.get("active", 0))
        note = f" ({gap} vacant)" if gap > 0 else ""
        print(f"pool {pool}: {p.get('active', 0)}/"
              f"{p.get('recorded_size', 0)} hosts{note}, "
              f"{p.get('spares', 0)} spare(s), "
              f"{_fmt(p.get('free_chips'), 1)} free chips "
              f"[{p.get('machine_class', '?')}/{p.get('zone', '?')}]")
    breakers = block.get("breakers", {})
    if breakers:
        print("stockout breakers:")
        for key in sorted(breakers):
            b = breakers[key]
            retry = (f", probe in {_fmt(b.get('retry_in_s'), 1)}s"
                     if b.get("state") == "open" else "")
            print(f"  {key}: {b.get('state', '?')} "
                  f"(streak {b.get('streak', 0)}{retry})")
    pending = block.get("pending_creates", [])
    if pending:
        print("in-flight creates:")
        for row in pending:
            print(f"  {row.get('name', '?')} -> pool "
                  f"{row.get('pool', '?')} "
                  f"[{row.get('machine_class', '?')}/"
                  f"{row.get('zone', '?')}] {row.get('status', '?')} "
                  f"for {_fmt(row.get('age_s'), 1)}s")
    counters = block.get("counters", {})
    if counters:
        print("counters: " + ", ".join(
            f"{k}={counters[k]}" for k in sorted(counters)))
    # journal joins: the newest breaker transition and failure tell the
    # operator WHY capacity is not arriving, not just that it is not
    stock = _newest(journal, J.PROVISION_STOCKOUT)
    if stock is not None:
        print(f"newest breaker transition: {stock['subject']} -> "
              f"{stock.get('attrs', {}).get('state', '?')} "
              f"(seq {stock['seq']})")
    failed = _newest(journal, J.PROVISION_FAILED)
    if failed is not None:
        print(f"newest abandoned create: {failed['subject']} "
              f"({failed.get('attrs', {}).get('reason', '?')})")
    borrow = _newest(journal, J.SPARE_BORROWED)
    if borrow is not None:
        attrs = borrow.get("attrs", {})
        print(f"newest cross-pool borrow: {borrow['subject']} -> pool "
              f"{attrs.get('pool', '?')} index "
              f"{attrs.get('host_index', '?')}")
    return 0


def selftest() -> int:
    """In-process zero-cluster check: spans nest and propagate, the
    journal stays bounded and ordered, explain reconstructs a rejection
    chain naming the plugin, the sampler stays bounded and rolls the
    max window, and an injected latency regression flips an SLO breach
    that recovers.  Prints ok/FAIL, returns rc."""
    from nos_tpu_torch.exporter.metrics import Registry
    from .journal import (
        POD_BOUND, POD_REJECTED, SLO_BREACH, SLO_RECOVERED,
        DecisionJournal,
    )
    from .slo import LATENCY, SLOEngine, SLOObjective
    from .timeseries import TimeSeriesSampler
    from .trace import RingExporter, Tracer

    failures: list[str] = []
    now = [0.0]

    def clock() -> float:
        now[0] += 0.5
        return now[0]

    tracer = Tracer(clock=clock, ring=RingExporter(maxlen=4))
    journal = DecisionJournal(maxlen=8, clock=clock)

    # span nesting + context propagation
    with tracer.span("outer", stage="selftest") as outer:
        with tracer.span("inner") as inner:
            if inner.trace_id != outer.trace_id:
                failures.append("child span did not inherit trace id")
            if inner.parent_id != outer.span_id:
                failures.append("child span did not link to parent")
            journal.record(POD_REJECTED, "default/victim",
                           reason="selftest",
                           message="no fit anywhere",
                           nodes={"host-0": "NodeResourcesFit: "
                                            "insufficient nvidia.com/mig-3g.40gb"},
                           reason_counts={})
    if journal.events()[-1].trace_id != outer.trace_id:
        failures.append("journal record did not capture trace context")

    # ring bound
    for i in range(10):
        with tracer.span(f"churn-{i}"):
            pass
    if len(tracer.ring) != 4:
        failures.append(f"ring not bounded: {len(tracer.ring)} != 4")
    if tracer.ring.dropped != 8:
        failures.append(f"ring dropped miscounted: {tracer.ring.dropped}")

    # journal bound + total order
    for i in range(20):
        journal.record(POD_BOUND, f"default/p{i}", node="host-0")
    if len(journal) != 8:
        failures.append(f"journal not bounded: {len(journal)} != 8")
    seqs = [r.seq for r in journal.events()]
    if seqs != sorted(seqs) or len(set(seqs)) != len(seqs):
        failures.append(f"journal order broken: {seqs}")

    # explain reconstructs the rejection (fresh journal: the churn above
    # evicted the rejection record — that eviction is itself the test)
    journal2 = DecisionJournal(maxlen=8, clock=clock)
    journal2.record(POD_REJECTED, "default/stuck",
                    reason="", message="no fit",
                    nodes={"host-0": "NodeResourcesFit: insufficient "
                                     "nvidia.com/mig-3g.40gb"},
                    reason_counts={})
    snapshot = {"spans": tracer.ring.dump(), "journal": journal2.dump()}
    text = "\n".join(explain_pod(snapshot, "default/stuck"))
    if "NodeResourcesFit" not in text or "host-0" not in text:
        failures.append(f"explain lost the rejecting plugin:\n{text}")

    # time-series sampler: bounded ring + windowed max reset on tick
    ts_now = [0.0]
    reg = Registry()
    sampler = TimeSeriesSampler(registry=reg, maxlen=4,
                                clock=lambda: ts_now[0])
    reg.observe("nos_tpu_selftest_seconds", 5.0)
    for i in range(6):
        ts_now[0] += 1.0
        point = sampler.tick()
    if len(sampler) != 4:
        failures.append(f"sampler not bounded: {len(sampler)} != 4")
    if point.get("nos_tpu_selftest_seconds_max") != 0.0:
        failures.append("windowed max did not reset on sampler tick")

    # SLO engine: a latency regression breaches, recovery journals
    slo_now = [0.0]
    slo_clock = lambda: slo_now[0]  # noqa: E731
    reg2 = Registry()
    journal3 = DecisionJournal(maxlen=64, clock=slo_clock)
    engine = SLOEngine(
        TimeSeriesSampler(registry=reg2, clock=slo_clock),
        [SLOObjective(name="selftest-latency", kind=LATENCY,
                      metric="nos_tpu_selftest_latency_seconds",
                      target=0.05, each_label="class")],
        fast_window_s=10.0, slow_window_s=30.0, clock=slo_clock)
    from . import scoped

    with scoped(journal=journal3):
        for phase, latency in ((40, 0.01), (40, 2.0), (80, 0.01)):
            for _ in range(phase):
                slo_now[0] += 1.0
                reg2.observe("nos_tpu_selftest_latency_seconds", latency,
                             labels={"class": "selftest"})
                engine.tick()
    cats = [r.category for r in journal3.events()
            if r.category in (SLO_BREACH, SLO_RECOVERED)]
    if cats != [SLO_BREACH, SLO_RECOVERED]:
        failures.append(
            f"SLO breach/recovery sequence wrong: {cats}")
    breach = next((r for r in journal3.events()
                   if r.category == SLO_BREACH), None)
    if breach is not None and breach.attrs.get("slo_class") != "selftest":
        failures.append("SLO breach lost the breaching class")
    # quantile estimator sanity on the registry itself
    q99 = reg2.quantile("nos_tpu_selftest_latency_seconds", 0.5,
                        labels={"class": "selftest"})
    if q99 is None:
        failures.append("registry quantile returned None with samples")

    # chip-second ledger: exact conservation under category churn, hold
    # lifecycle bounded, stranded-free helper arithmetic
    from .ledger import (
        ChipSecondLedger, conservation_ok, stranded_free, waste_ranking,
    )

    led_now = [0.0]
    ledger = ChipSecondLedger(clock=lambda: led_now[0])
    ledger.set_hold("host-0", "quarantine", owner="slice", reason="test")
    ledger.observe({"pod-0": {"capacity": 16.0,
                              "categories": {"productive": 12.0,
                                             "frag_stranded": 4.0}}})
    led_now[0] += 10.0
    ledger.observe({"pod-0": {"capacity": 16.0,
                              "categories": {"productive": 16.0}}})
    led_now[0] += 5.0
    ledger.observe({"pod-0": {"capacity": 16.0, "categories": {}}})
    ledger.clear_hold("host-0", "quarantine", owner="slice")
    report = ledger.report()
    pool = report["pools"]["pod-0"]
    if pool["chip_seconds"].get("productive") != 12.0 * 10 + 16.0 * 5:
        failures.append(f"ledger productive accrual wrong: {pool}")
    if not conservation_ok(report):
        failures.append(f"ledger conservation violated: {pool}")
    if ledger.hold_count() != 0:
        failures.append("ledger hold lifecycle leaked")
    if waste_ranking(report)[0]["category"] != "frag_stranded":
        failures.append("waste ranking did not rank the frag step first")
    if stranded_free({"a": 3.0, "b": 5.0}, {"b"}) != 5.0:
        failures.append("stranded_free arithmetic broken")

    if failures:
        print("obs selftest: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("obs selftest: ok (spans, journal, explain, timeseries, slo, "
          "ledger)")
    return 0


def _watch_top(args: argparse.Namespace, endpoint: str,
               sleep=None) -> int:
    """`obs top --watch N`: periodic scoreboard refresh from a live
    snapshot source, clearing the screen between frames (one-shot
    behavior is unchanged without --watch).  `--frames K` bounds the
    loop for tests/scripts; ^C exits cleanly either way."""
    if sleep is None:
        import time as _time

        # interactive pacing: the frames come from the live endpoint
        sleep = _time.sleep
    frame = 0
    rc = 0
    try:
        while True:
            try:
                snapshot = _load_snapshot(args, endpoint=endpoint)
            except (OSError, json.JSONDecodeError) as exc:
                print(f"cannot read snapshot: {exc}", file=sys.stderr)
                return 1
            frame += 1
            # ANSI clear + home, like watch(1); a dumb pipe just sees
            # frames separated by the escape (harmless in logs)
            print("\x1b[2J\x1b[H", end="")
            print(f"obs top --watch {args.watch:g} "
                  f"(frame {frame}{f'/{args.frames}' if args.frames else ''})")
            rc = cmd_top(snapshot)
            if args.frames and frame >= args.frames:
                return rc
            sleep(args.watch)
    except KeyboardInterrupt:
        return rc


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nos_tpu_torch.obs",
        description=__doc__.split("\n")[0])
    parser.add_argument("--selftest", action="store_true",
                        help="run the in-process subsystem check")
    sub = parser.add_subparsers(dest="command")

    p_explain = sub.add_parser("explain", help="reconstruct a causal answer")
    ex_sub = p_explain.add_subparsers(dest="what", required=True)
    p_pod = ex_sub.add_parser("pod", help="why is this pod pending?")
    p_pod.add_argument("key", help="pod as <namespace>/<name>")
    p_plan = ex_sub.add_parser("plan", help="where did the plan budget go?")
    p_plan.add_argument("--kind", default=None,
                        help="partitioning kind (mig|mps)")
    p_dump = sub.add_parser("dump", help="print the raw flight snapshot")
    p_slo = sub.add_parser(
        "slo", help="SLO verdicts: per-class p99, burn rates, budget")
    p_top = sub.add_parser(
        "top", help="one-shot fleet scoreboard (utilization, "
                    "fragmentation, waste waterfall, pending, budget)")
    p_top.add_argument(
        "--watch", type=float, default=0.0, metavar="N",
        help="refresh every N seconds from --url (clears the screen "
             "between frames; one-shot without it)")
    p_top.add_argument(
        "--frames", type=int, default=0, metavar="K",
        help="with --watch: stop after K frames (0 = until ^C; "
             "tests/scripts use it)")
    p_waste = sub.add_parser(
        "waste", help="GPU-second waste waterfall: per-pool category "
                      "breakdown, conservation verdict, ranked culprits")
    p_capacity = sub.add_parser(
        "capacity", help="capacity plane: pool inventory vs recorded "
                         "size, stockout breakers, in-flight creates")
    for p in (p_pod, p_plan, p_dump, p_slo, p_top, p_waste, p_capacity):
        p.add_argument("--snapshot", default="",
                       help="saved snapshot JSON ('-'=stdin)")
        p.add_argument("--url", default="",
                       help="live health server base URL")

    args = parser.parse_args(argv)
    if args.selftest:
        return selftest()
    if args.command is None:
        parser.print_help()
        return 2
    # `slo` and `waste` fetch the FLIGHT snapshot, not their dedicated
    # blocks: the flight payload embeds the report AND the journal, so
    # the breach→rejecting-plugin and waste→culprit joins work on the
    # live-URL path too
    endpoint = {"top": "/snapshot"}.get(
        args.command, "/debug/flightrecorder")
    if args.command == "top" and args.watch > 0.0:
        return _watch_top(args, endpoint)
    try:
        snapshot = _load_snapshot(args, endpoint=endpoint)
    except json.JSONDecodeError as exc:
        print(f"snapshot is not valid JSON: {exc}", file=sys.stderr)
        return 1
    except OSError as exc:   # unreadable file, unreachable --url
        print(f"cannot read snapshot: {exc}", file=sys.stderr)
        return 1
    if not isinstance(snapshot, dict):
        print("snapshot is not a flight-recorder payload "
              "(expected a JSON object)", file=sys.stderr)
        return 1
    if args.command == "dump":
        print(json.dumps(snapshot, indent=2))
        return 0
    if args.command == "slo":
        return cmd_slo(snapshot)
    if args.command == "top":
        return cmd_top(snapshot)
    if args.command == "waste":
        return cmd_waste(snapshot)
    if args.command == "capacity":
        return cmd_capacity(snapshot)
    if args.what == "pod":
        if "/" not in args.key:
            print("pod key must be <namespace>/<name>", file=sys.stderr)
            return 2
        lines = explain_pod(snapshot, args.key)
    else:
        lines = explain_plan(snapshot, kind=args.kind)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
