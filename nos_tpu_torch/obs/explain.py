"""``nos explain`` for the port, ``nos_tpu/obs/explain.py``: causal
answers rebuilt from a flight snapshot.

- ``explain_pod``: why is this pod still pending?  The pod's journal
  records, newest first: per-node ``plugin: reason`` verdicts, the
  quota or gang cause, head-of-line deferrals, a preemption made for
  it.
- ``explain_plan``: where did this repartition's time go?  The newest
  plan cycle's span tree with durations and counters, its shards by
  pool, and the journal's per-node decisions in that trace.

Both read a flight snapshot, the plain dict ``obs.flight_snapshot()``
returns and the health server serves at ``/debug/flightrecorder``, so
one code answers in process, from a saved file or from a live endpoint
(``obs/__main__.py``).  The lines are the JAX package's.
"""

from __future__ import annotations

from . import journal as J


def _pod_records(journal: list[dict], key: str) -> list[dict]:
    """Journal records about pod `key`, oldest first: subject match,
    membership in a gang decision's member list, or — because that list
    is capped — a gang decision whose subject the pod's OWN records name
    in their `gang` attr (member 33+ of a big gang keeps its context)."""
    out, seen, gangs = [], set(), set()
    for rec in journal:
        attrs = rec.get("attrs", {})
        # membership only against a LIST-typed members attr: a record
        # carrying a members COUNT (the members_total convention, but
        # guard against future drift) must not crash the flight
        # recorder for every pod in the journal
        members = attrs.get("members", ())
        if not isinstance(members, (list, tuple)):
            members = ()
        if rec["subject"] == key or key in members:
            out.append(rec)
            seen.add(rec["seq"])
            if attrs.get("gang"):
                gangs.add(attrs["gang"])
    if gangs:
        for rec in journal:
            if rec["seq"] not in seen and rec["subject"] in gangs \
                    and rec["category"] in (J.GANG_ADMITTED,
                                            J.GANG_REJECTED):
                out.append(rec)
        out.sort(key=lambda r: r["seq"])
    return out


def _fmt_nodes(nodes: dict, reason_counts: dict,
               total: int | None = None) -> list[str]:
    lines = []
    for node, why in sorted(nodes.items()):
        lines.append(f"    node {node}: rejected by {why}")
    listed = len(nodes)
    if total is None:   # records from before nodes_total existed
        total = sum(reason_counts.values()) if reason_counts else listed
    if total > listed:
        lines.append(f"    ... and {total - listed} more node(s); "
                     "top distinct reasons:")
        for why, count in sorted(reason_counts.items(),
                                 key=lambda kv: -kv[1]):
            lines.append(f"      {count}x {why}")
    return lines


def explain_pod(snapshot: dict, key: str) -> list[str]:
    """Human-readable causal answer for pod `key` ("ns/name").  Returns
    lines; the first states the verdict."""
    journal = snapshot.get("journal", [])
    records = _pod_records(journal, key)
    if not records:
        return [f"pod {key}: no journaled decisions — either it never "
                "reached the scheduler, or the journal has since "
                "evicted them (bounded ring)"]

    lines: list[str] = []
    last = records[-1]
    bound = [r for r in records if r["category"] == J.POD_BOUND]
    # the bind is definitive unless the pod was REJECTED again after it
    # (re-queued after eviction): gang binds journal gang-admitted after
    # every member's pod-bound, so "newest record" is the wrong test
    if bound and not any(r["category"] == J.POD_REJECTED
                         and r["seq"] > bound[-1]["seq"] for r in records):
        node = bound[-1]["attrs"].get("node", "?")
        return [f"pod {key}: BOUND to node {node} "
                f"(seq {bound[-1]['seq']}) — not pending"]

    lines.append(f"pod {key}: last decision: {last['category']} "
                 f"(seq {last['seq']})")

    rejections = [r for r in records if r["category"] == J.POD_REJECTED]
    if rejections:
        rej = rejections[-1]
        attrs = rej["attrs"]
        reason = attrs.get("reason") or "unclassified"
        lines.append(f"  latest rejection [{reason}]: "
                     f"{attrs.get('message', '')}")
        nodes = attrs.get("nodes") or {}
        if nodes:
            lines.extend(_fmt_nodes(nodes, attrs.get("reason_counts", {}),
                                    attrs.get("nodes_total")))

    # quota/preemption context is written in the present tense, so only
    # records from the LATEST scheduling attempt may produce it: anything
    # at or before the previous rejection belongs to an older attempt
    # whose cause may have since resolved (a pod that was the quota
    # head-of-line claimant cycles ago but is now pending on pure
    # capacity must not send the operator to debug quota).
    prev_rej_seq = rejections[-2]["seq"] if len(rejections) > 1 else -1
    recent = [r for r in records if r["seq"] > prev_rej_seq]

    for rec in reversed(recent):
        cat = rec["category"]
        attrs = rec["attrs"]
        if cat == J.QUOTA_HOL_CLAIM:
            lines.append(
                f"  quota: pod is the head-of-line claimant for "
                f"namespace {attrs.get('namespace', '?')} "
                f"(priority {attrs.get('priority', '?')}) — waiting for "
                "ledger headroom; lower-priority pods defer behind it")
            break
        if cat == J.POD_REJECTED and attrs.get("reason") == "quota-hol":
            lines.append(
                "  quota: deferred behind a higher-priority quota "
                "claimant in its namespace (head-of-line)")
            break

    gang = [r for r in records
            if r["category"] in (J.GANG_REJECTED, J.GANG_ADMITTED)]
    if gang:
        g = gang[-1]
        if g["category"] == J.GANG_REJECTED:
            n = g["attrs"].get("members_total",
                               len(g["attrs"].get("members", [])))
            lines.append(f"  gang {g['subject']}: "
                         f"{g['attrs'].get('message', 'did not fit')}"
                         f" (members: {n})")
        else:
            lines.append(f"  gang {g['subject']}: admitted "
                         f"({g['attrs'].get('bound', '?')} bound)")

    preempt = [r for r in recent
               if r["category"] in (J.PREEMPTION, J.PREEMPTION_NONE)]
    if preempt:
        p = preempt[-1]
        if p["category"] == J.PREEMPTION:
            n = p["attrs"].get("victim_count",
                               len(p["attrs"].get("victims", [])))
            lines.append(
                f"  preemption: evicted "
                f"{n} victim(s) on "
                f"{p['attrs'].get('node', '?')} on its behalf — retry "
                "expected next cycle")
        else:
            lines.append(f"  preemption attempted but found no victims: "
                         f"{p['attrs'].get('message', '')}")

    if len(lines) == 1:
        lines.append("  no rejection detail journaled (pod may simply "
                     "be awaiting its first scheduling cycle)")
    return lines


def _span_tree(spans: list[dict], root: dict) -> list[dict]:
    """root + descendants (by parent links), depth-first."""
    children: dict[str, list[dict]] = {}
    for s in spans:
        children.setdefault(s.get("parent_id", ""), []).append(s)
    out: list[dict] = []

    def walk(span: dict, depth: int) -> None:
        span = dict(span)
        span["_depth"] = depth
        out.append(span)
        for child in sorted(children.get(span["span_id"], []),
                            key=lambda s: s["start"]):
            walk(child, depth + 1)

    walk(root, 0)
    return out


def explain_plan(snapshot: dict, kind: str | None = None) -> list[str]:
    """Latency breakdown of the newest plan cycle (optionally of one
    partitioning kind): the span tree with durations and counters, then
    the journal's per-node commit/revert and actuation decisions."""
    spans = snapshot.get("spans", [])
    roots = [s for s in spans
             if s["name"] == "partitioner.plan_cycle"
             and (kind is None or s.get("attrs", {}).get("kind") == kind)]
    if not roots:
        return ["no completed plan cycle in the span ring"
                + (f" for kind {kind!r}" if kind else "")]
    root = max(roots, key=lambda s: s["start"])
    lines = []
    total = root.get("duration") or 0.0
    for s in _span_tree(spans, root):
        pad = "  " * s["_depth"]
        dur = s.get("duration")
        dur_s = f"{dur * 1000:.1f} ms" if dur is not None else "?"
        pct = f" ({dur / total * 100:.0f}%)" if dur and total else ""
        attrs = ", ".join(f"{k}={v}" for k, v in s.get("attrs", {}).items())
        lines.append(f"{pad}{s['name']}: {dur_s}{pct}"
                     + (f" [{attrs}]" if attrs else ""))
        for k, v in sorted(s.get("counts", {}).items()):
            lines.append(f"{pad}  · {k}: {v}")

    # sharded plans: attribute plan time per pool (the plan_shard spans
    # run on worker threads but carry the cycle's trace via context
    # propagation, so they are part of this tree)
    shards = [s for s in _span_tree(spans, root)
              if s["name"] == "plan_shard" and s.get("duration")]
    if shards:
        lines.append("shard time by pool:")
        shard_total = sum(s["duration"] for s in shards)
        for s in sorted(shards, key=lambda s: -(s["duration"] or 0.0)):
            attrs = s.get("attrs", {})
            pct = (f" ({s['duration'] / shard_total * 100:.0f}% of shard "
                   f"time)" if shard_total else "")
            lines.append(
                f"  {attrs.get('pool', '?')}: "
                f"{s['duration'] * 1000:.1f} ms{pct} "
                f"[nodes={attrs.get('nodes', '?')}, "
                f"pods={attrs.get('pods', '?')}]")

    trace_id = root["trace_id"]
    decisions = [r for r in snapshot.get("journal", [])
                 if r.get("trace_id") == trace_id
                 and r["category"] in (J.PLAN_NODE_COMMITTED,
                                       J.PLAN_NODE_REVERTED,
                                       J.NODE_ACTUATED,
                                       J.ACTUATION_FAILED,
                                       J.PLAN_SHARD_MERGED)]
    if decisions:
        lines.append("decisions in this cycle:")
        for r in decisions:
            attrs = ", ".join(f"{k}={v}" for k, v in r["attrs"].items())
            lines.append(f"  {r['category']} {r['subject']}"
                         + (f" ({attrs})" if attrs else ""))
    return lines
