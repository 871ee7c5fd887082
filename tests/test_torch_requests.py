"""The port's request data plane (``nos_tpu_torch/requests``) against the
JAX package's (``nos_tpu/requests``), each case of ``tests/test_requests.py``
run through both packages on the same inputs.

Costs are priced on the card: the port reads its peaks from
``ops/roofline.py``, and the JAX package's cost model is given the same
card's peak and bandwidth in the test only (``jax_prices_as_the_port``
monkeypatches ``nos_tpu.requests.costs.peak_for`` and
``hbm_bandwidth_for``; a JAX ``device_kind`` "<card>/<MIG profile>"
names the port's replica, whose shares the patch applies).  With that
the formulas are the same: the costs agree within 1e-12 relative (they
are equal), and every decision (admission, placement, shed, migration,
handoff, the stamps, the journal) agrees exactly.

- TestCosts: the cost split, ``hbm_bandwidth_for`` against the roofline
  table, the H100 meaning of each key (a TPU ``device_kind``, ``chips``
  other than 1 and a MIG instance's GB other than its profile's are
  refused);
- TestReplica: bounded admission, reserve-ahead KV, the prefill/decode
  split, the handoff, drain and ``admit_decode``, and a numpy-drawn
  request stream stepped on both replicas, state compared every tick;
- TestRouter: affinity, KV-aware spread, shed-with-retry, migration,
  the publish stamps and gauges, disaggregation, session expiry, over
  the in-memory API and over ``kube/rest.py``'s client on the stub;
- TestRouterConfig: ``RouterConfig`` through ``RouterService``;
- TestDeterminism: the journal byte-identical across source
  installation order and worker counts, and equal to JAX's;
- TestBurstE2E: KV pressure scaling an MPS service up through the
  autoscaler and the scheduler, with no serving victim, on both.
"""

from __future__ import annotations

import random
import types

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.requests as jax_requests
import nos_tpu.requests.costs as jax_costs_mod
from nos_tpu.api.config import ConfigError as JaxConfigError
from nos_tpu.api.config import RouterConfig as JaxRouterConfig
from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY
from nos_tpu.kube import client as jax_client
from nos_tpu.obs import journal as jax_journal
from nos_tpu.obs import scoped as jax_scoped
from nos_tpu.sim import engine as jax_engine, trace as jax_trace
from nos_tpu.testing import factory as jax_factory

import nos_tpu_torch.requests as port_requests
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.config import ConfigError, RouterConfig
from nos_tpu_torch.exporter.metrics import REGISTRY as PORT_REGISTRY
from nos_tpu_torch.kube import client as port_client
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.obs import scoped as port_scoped
from nos_tpu_torch.ops import roofline
from nos_tpu_torch.requests import costs as port_costs_mod
from nos_tpu_torch.sim import engine as port_engine, trace as port_trace
from nos_tpu_torch.testing import factory as port_factory

H100 = "NVIDIA H100 80GB HBM3"
COST_RTOL = 1e-12


def jax_prices_as_the_port(monkeypatch) -> None:
    """The JAX package's cost model priced on the port's card: its
    ``peak_for`` and ``hbm_bandwidth_for`` read a ``device_kind`` of
    "<card>/<MIG profile>" ("" for an MPS share) as the port's replica on
    that card, its peak and bandwidth times its compute and memory
    shares (``costs._shares``), from ``ops/roofline.py``'s table.  With
    ``chips`` 1 and ``hbm_gb`` the replica's GB, JAX's formulas then give
    the port's numbers.  Every test whose JAX decisions depend on costs
    uses it."""
    def split(kind: str) -> tuple[str, str]:
        card, _, mig = kind.partition("/")
        return card, mig

    def peak(kind: str) -> float:
        card, mig = split(kind)
        return roofline.peaks_for(card)[0] * port_costs_mod._shares(
            card, mig)[0]

    def bandwidth(kind: str) -> float:
        card, mig = split(kind)
        return port_costs_mod.hbm_bandwidth_for(card) * \
            port_costs_mod._shares(card, mig)[1]

    monkeypatch.setattr(jax_costs_mod, "peak_for", peak)
    monkeypatch.setattr(jax_costs_mod, "hbm_bandwidth_for", bandwidth)


@pytest.fixture(autouse=True)
def _priced(monkeypatch):
    jax_prices_as_the_port(monkeypatch)


def jax_cost_kwargs(kw: dict) -> dict:
    """A port cost model's keys as the JAX package's (the card and MIG
    profile folded into ``device_kind``)."""
    kw = dict(kw)
    kw["device_kind"] = (f"{kw.get('device_kind', H100)}/"
                         f"{kw.pop('mig_profile', '')}")
    return kw


class Pkg:
    """One package's surface, so that one story runs on both."""

    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.name = "jax" if jax else "port"
        self.R = jax_requests if jax else port_requests
        self.C = JC if jax else C
        self.client = jax_client if jax else port_client
        self.J = jax_journal if jax else port_journal
        self.scoped = jax_scoped if jax else port_scoped
        self.factory = jax_factory if jax else port_factory
        self.E = jax_engine if jax else port_engine
        self.T = jax_trace if jax else port_trace
        self.REGISTRY = JAX_REGISTRY if jax else PORT_REGISTRY

    def profile(self, **kw):
        defaults = dict(name="tiny", num_layers=16, num_heads=16,
                        num_kv_heads=16, head_dim=128,
                        intermediate_size=1024, vocab_size=1000,
                        weights_gb=3.6)
        defaults.update(kw)
        return self.R.ModelProfile(**defaults)

    def costs(self, profile=None, **kw):
        """A KV-heavy replica (128 KB a token): an MPS share of 3.7 GB
        under 3.6 GB of weights holds ~819 KV tokens, so a handful of
        requests saturates it, and its decode step on the H100 is about
        as long as JAX's 1 GB v5e replica's."""
        defaults = dict(device_kind=H100, hbm_gb=3.7)
        defaults.update(kw)
        if self.jax:
            defaults = jax_cost_kwargs(defaults)
        return self.R.RequestCostModel(profile=profile or self.profile(),
                                       **defaults)

    def request(self, rid="r0", session="s0", prompt=80, output=20,
                created=0.0):
        return self.R.Request("chat", rid, session, prompt, output, created)

    def service(self, **kw):
        costs = kw.pop("prefill_costs", None) or self.costs()
        defaults = dict(name="chat", model=costs.profile,
                        prefill_costs=costs, max_queue_per_replica=4,
                        max_retries=1, retry_backoff_s=0.1,
                        session_idle_s=10.0)
        defaults.update(kw)
        return self.R.RouterService(**defaults)

    def replica_pod(self, name: str, service: str = "chat"):
        return self.factory.make_pod(
            name=name, namespace="serve", node_name="host-0",
            phase="Running",
            labels={self.C.LABEL_SERVICE: service,
                    self.C.LABEL_TIER: self.C.TIER_SERVING})

    def rows(self, journal) -> list:
        return [(r.category, r.subject,
                 tuple(sorted((k, str(v)) for k, v in r.attrs.items())))
                for r in journal.events()]


PKGS = (Pkg(True), Pkg(False))


def both(story) -> dict:
    return {pk.name: story(pk) for pk in PKGS}


def same(story):
    out = both(story)
    assert out["port"] == out["jax"]
    return out["port"]


def close(a: float, b: float) -> bool:
    return abs(a - b) <= COST_RTOL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


class TestCosts:
    def test_kv_bytes_per_token_and_capacity(self):
        def story(pk):
            costs = pk.costs()
            return (costs.profile.kv_bytes_per_token(),
                    costs.kv_capacity_tokens(),
                    costs.profile.flops_per_token())

        kvb, cap, flops = same(story)
        assert kvb == 2 * 16 * 16 * 128 * 2
        assert cap == int((3.7 - 3.6) * 2**30 // kvb)

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("mig", ["", "1g.10gb", "1g.20gb", "2g.20gb",
                                     "3g.40gb", "4g.40gb", "7g.80gb"])
    def test_the_split_is_jax_s_formulas_on_the_card(self, seed, mig):
        """numpy-drawn model shapes and knobs, priced as an MPS share and
        as each MIG instance of the H100: prefill, decode and capacity
        equal JAX's given the card (1e-12 relative)."""
        rng = np.random.default_rng(seed)
        gb = {"": 24.0, "1g.10gb": 10.0, "1g.20gb": 20.0, "2g.20gb": 20.0,
              "3g.40gb": 40.0, "4g.40gb": 40.0, "7g.80gb": 80.0}[mig]
        prof = dict(name="m", num_layers=int(rng.integers(2, 48)),
                    num_heads=8, num_kv_heads=int(rng.choice([1, 2, 4, 8])),
                    head_dim=128, intermediate_size=int(rng.integers(256,
                                                                     20000)),
                    vocab_size=32000,
                    weights_gb=float(rng.uniform(0.5, gb * 0.8)))
        kw = dict(hbm_gb=gb, mig_profile=mig, mfu=float(rng.uniform(0.2, 1)),
                  hbm_efficiency=float(rng.uniform(0.3, 1)))
        prompts = rng.integers(1, 4096, size=8)
        resident = rng.integers(0, 200_000, size=8)

        def story(pk):
            costs = pk.costs(profile=pk.profile(**prof), **kw)
            return ([costs.prefill_seconds(int(p)) for p in prompts],
                    [costs.decode_step_seconds(int(r)) for r in resident],
                    costs.kv_capacity_tokens())

        got = both(story)
        (jp, jd, jc), (pp, pd, pc) = got["jax"], got["port"]
        assert jc == pc
        assert all(close(a, b) for a, b in zip(jp + jd, pp + pd))

    def test_a_mig_instance_has_its_shares_of_the_card(self):
        flops, bandwidth = roofline.peaks_for(H100)
        pk = Pkg(False)
        c = pk.costs(hbm_gb=20.0, mig_profile="1g.20gb")
        assert c.peak_flops() == flops * (1 / 7)
        assert c.bandwidth() == bandwidth * (2 / 8)
        whole = pk.costs(hbm_gb=24.0)
        assert (whole.peak_flops(), whole.bandwidth()) == (flops, bandwidth)
        # a 3g.40gb prefills 3x faster than a 1g.20gb
        big = pk.costs(hbm_gb=40.0, mig_profile="3g.40gb")
        assert close(c.prefill_seconds(100), 3 * big.prefill_seconds(100))

    def test_bandwidth_is_the_roofline_table_s(self):
        for needle, _, bandwidth in roofline._PEAKS:
            assert port_requests.HBM_BYTES_PER_S[needle] == bandwidth
        assert port_requests.hbm_bandwidth_for(H100) == 3.35e12
        assert port_requests.hbm_bandwidth_for("NVIDIA H100 PCIe") == 2.0e12
        for tpu in ("v5e", "tpu-v5p-podslice", "Trillium", "mystery"):
            with pytest.raises(ValueError, match="no published peaks"):
                port_requests.hbm_bandwidth_for(tpu)

    @pytest.mark.parametrize("kw,match", [
        ({"device_kind": "v5e"}, "no published peaks"),
        ({"device_kind": "tpu-v5-lite-podslice"}, "no published peaks"),
        ({"chips": 2}, "chips must be 1"),
        ({"hbm_gb": 24.0, "mig_profile": "3g.40gb"}, "is not 3g.40gb's"),
        ({"hbm_gb": 20.0, "mig_profile": "2x2"}, "not a MIG profile"),
        ({"hbm_gb": 96.0}, "at most the card's 80 GB"),
        ({"mfu": 0.0}, "mfu"),
        ({"hbm_efficiency": 1.5}, "hbm_efficiency"),
        ({"hbm_gb": 3.5}, "no KV room"),
    ])
    def test_values_without_an_h100_meaning_are_refused(self, kw, match):
        with pytest.raises(ValueError, match=match):
            Pkg(False).costs(**kw)

    def test_jax_refuses_as_the_port_where_both_check(self):
        def story(pk):
            out = []
            for kw in ({"mfu": 0.0}, {"hbm_efficiency": 1.5},
                       {"hbm_gb": 3.5}):
                with pytest.raises(ValueError):
                    pk.costs(**kw)
                out.append(True)
            with pytest.raises(ValueError):
                pk.profile(num_kv_heads=0)
            return out

        same(story)


# ---------------------------------------------------------------------------
# The replica
# ---------------------------------------------------------------------------


def replica_state(rep) -> tuple:
    return (rep.queue_depth(), rep.in_flight(), rep.kv_occupancy(),
            rep.load_signal(), rep.active_sessions(), rep.kv_capacity)


def req_state(req) -> tuple:
    return (req.rid, req.admitted, req.prefill_done, req.finished,
            req.generated, req.retries, req.needs_prefill)


class TestReplica:
    def test_admission_queue_is_bounded(self):
        def story(pk):
            rep = pk.R.ContinuousBatchingReplica("r0", pk.costs(),
                                                 max_queue=2)
            got = [rep.admit(pk.request(r), 0.0) for r in "abc"]
            return got, rep.queue_depth()

        assert same(story) == ([True, True, False], 2)

    def test_reserve_ahead_blocks_the_head_of_line(self):
        def story(pk):
            rep = pk.R.ContinuousBatchingReplica("r0", pk.costs())
            cap = rep.kv_capacity
            rep.admit(pk.request("big", prompt=cap, output=cap), 0.0)
            rep.admit(pk.request("small", prompt=10, output=2), 0.0)
            rep.step(1.0, 1.0)
            return replica_state(rep)

        state = same(story)
        assert state[0] == 2 and state[2] == 0.0

    @pytest.mark.parametrize("prompt,output,prefill_only", [
        (50, 4, False), (64, 1, False), (64, 20, True)])
    def test_decode_handoff_and_prefill_only_completion(self, prompt, output,
                                                        prefill_only):
        def story(pk):
            rep = pk.R.ContinuousBatchingReplica(
                "r0", pk.costs(), prefill_only=prefill_only)
            req = pk.request(prompt=prompt, output=output)
            rep.admit(req, 0.0)
            events = []
            for i in range(200):
                handoffs, done = rep.step(float(i), 0.05)
                if handoffs or done:
                    events.append((i, [r.rid for r in handoffs],
                                   [r.rid for r in done]))
                    break
            return events, req_state(req), replica_state(rep)

        events, req, rep = same(story)
        assert events and rep[2] == 0.0
        if prefill_only:
            assert events[0][1] == ["r0"] and req[3] is None
        else:
            assert events[0][2] == ["r0"] and req[4] == output

    def test_drain_resets_requests_for_a_fresh_start(self):
        def story(pk):
            rep = pk.R.ContinuousBatchingReplica("r0", pk.costs())
            a, b = pk.request("a", output=300), pk.request("b", output=300)
            rep.admit(a, 0.0)
            rep.admit(b, 0.0)
            for i in range(5):
                rep.step(float(i), 0.01)
            generated = (a.generated, b.generated)
            orphans = rep.drain()
            return (generated, [req_state(r) for r in orphans],
                    replica_state(rep))

        generated, orphans, rep = same(story)
        assert sum(generated) > 0 and [o[0] for o in orphans] == ["a", "b"]
        assert all(o[6] and o[4] == 0 for o in orphans) and rep[1] == 0

    def test_admit_decode_needs_kv_room_not_queue_room(self):
        def story(pk):
            rep = pk.R.ContinuousBatchingReplica("r0", pk.costs(),
                                                 max_queue=1)
            cap = rep.kv_capacity
            big = pk.request("big", prompt=cap - 10, output=5)
            big.needs_prefill = False
            small = pk.request("small", prompt=20, output=5)
            small.needs_prefill = False
            return rep.admit_decode(big, 0.0), rep.admit_decode(small, 0.0)

        assert same(story) == (True, False)

    def test_knobs_are_checked_as_jax_checks_them(self):
        def story(pk):
            for kw in ({"max_queue": 0}, {"prefill_share": 0.0},
                       {"prefill_share": 1.5}):
                with pytest.raises(ValueError):
                    pk.R.ContinuousBatchingReplica("r0", pk.costs(), **kw)
            with pytest.raises(ValueError):
                pk.request(prompt=0)
            return True

        same(story)

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("prefill_only", [False, True])
    def test_a_drawn_stream_steps_alike(self, seed, prefill_only):
        """numpy-drawn arrivals, shapes and tick lengths on one replica
        of each package: every tick's handoffs, completions and state
        equal."""
        rng = np.random.default_rng(seed)
        ticks = rng.uniform(0.0, 0.2, size=120)
        arrivals = rng.integers(0, 3, size=120)
        shapes = rng.integers(1, 160, size=(400, 2))

        def story(pk):
            rep = pk.R.ContinuousBatchingReplica(
                "r0", pk.costs(), max_queue=6, prefill_share=0.4,
                prefill_only=prefill_only)
            now, k, log = 0.0, 0, []
            for dt, n in zip(ticks, arrivals):
                for _ in range(int(n)):
                    p, o = shapes[k]
                    rep.admit(pk.request(f"r{k}", f"s{k % 5}", int(p),
                                         int(o), now), now)
                    k += 1
                now += float(dt)
                handoffs, done = rep.step(now, float(dt))
                log.append(([req_state(r) for r in handoffs],
                            [req_state(r) for r in done],
                            replica_state(rep)))
            return log

        log = same(story)
        assert any(t[0] or t[1] for t in log)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class RouterHarness:
    def __init__(self, pk: Pkg, svc=None, replicas: int = 2, api=None,
                 **router_kw) -> None:
        self.pk = pk
        self.now = [0.0]
        self.api = api if api is not None else pk.client.APIServer()
        self.svc = svc or pk.service()
        label = self.svc.prefill_label
        for i in range(replicas):
            self.api.create("Pod", pk.replica_pod(f"{label}-r{i}", label))
        self.router = pk.R.ServingRouter(
            self.api, [self.svc], clock=lambda: self.now[0],
            publish_every_ticks=1, **router_kw)
        self.journal = pk.J.DecisionJournal(clock=lambda: self.now[0])

    def run(self, ticks: int, dt: float = 0.05) -> None:
        with self.pk.scoped(journal=self.journal):
            for _ in range(ticks):
                self.now[0] += dt
                self.router.tick(dt)

    def submit(self, *reqs) -> None:
        with self.pk.scoped(journal=self.journal):
            for req in reqs:
                self.router.submit("serve/chat", req)

    def view(self) -> dict:
        pods = {}
        for p in self.api.list("Pod", namespace="serve"):
            a = p.metadata.annotations
            pods[p.metadata.name] = (
                a.get(self.pk.C.ANNOT_SERVING_LOAD),
                a.get(self.pk.C.ANNOT_SERVING_SESSIONS))
        return {"stats": self.router.stats(),
                "occ": self.router.kv_occupancies("serve/chat"),
                "pools": self.router.pool_occupancies("serve/chat"),
                "sessions": self.router.session_count("serve/chat"),
                "pods": pods, "journal": self.pk.rows(self.journal)}


class TestRouter:
    def test_session_affinity_sticks_to_the_kv_holder(self):
        def story(pk):
            h = RouterHarness(pk)
            h.submit(pk.request("a", "s1", output=400))
            h.run(3)
            first = h.view()
            h.submit(pk.request("b", "s1", output=400, created=h.now[0]))
            h.run(3)
            return first, h.view()

        first, second = same(story)
        holder = max(first["occ"], key=first["occ"].get)
        assert first["occ"][holder] > 0.0
        assert all(v == 0.0 for k, v in second["occ"].items()
                   if k != holder)
        assert second["sessions"] == 1

    def test_new_sessions_spread_by_kv_occupancy(self):
        def story(pk):
            h = RouterHarness(pk)
            h.submit(pk.request("a", "s1", output=400))
            h.run(3)
            h.submit(pk.request("b", "s2", output=400, created=h.now[0]))
            h.run(3)
            return h.view()

        assert sum(v > 0.0 for v in same(story)["occ"].values()) == 2

    def test_shed_after_max_retries_is_journaled(self):
        def story(pk):
            h = RouterHarness(pk, pk.service(max_queue_per_replica=1,
                                             max_retries=0), replicas=1)
            h.router.tick(0.0)
            h.submit(pk.request("a", "s1"), pk.request("b", "s2"))
            return h.view()

        view = same(story)
        assert view["stats"]["serve/chat"]["shed"] == 1
        assert view["journal"] == [
            ("request-shed", "serve/chat", (("phase", "prefill"),
                                            ("retries", "0"), ("rid", "b"),
                                            ("session", "s2")))]

    def test_retry_admits_once_capacity_frees(self):
        def story(pk):
            h = RouterHarness(pk, pk.service(max_queue_per_replica=1,
                                             max_retries=3,
                                             retry_backoff_s=0.05),
                              replicas=1)
            h.router.tick(0.0)
            h.submit(pk.request("a", "s1", output=2),
                     pk.request("b", "s2", output=2))
            mid = h.router.stats()
            h.run(40)
            return mid, h.view()

        mid, view = same(story)
        assert mid["serve/chat"]["retried"] == 1
        assert view["stats"]["serve/chat"]["completed"] == 2

    def test_replica_vanish_migrates_sessions_and_reroutes(self):
        def story(pk):
            h = RouterHarness(pk)
            h.submit(pk.request("a", "s1", output=400))
            h.run(3)
            occ = h.router.kv_occupancies("serve/chat")
            holder = max(occ, key=occ.get)
            h.api.delete("Pod", holder, "serve")
            h.run(3)
            return holder, h.view()

        holder, view = same(story)
        (rec,) = [r for r in view["journal"] if r[0] == "session-migrated"]
        assert dict(rec[2]) == {"from_replica": holder, "session": "s1",
                                "was_affine": "True"}
        assert holder not in view["occ"] and max(view["occ"].values()) > 0

    def test_publish_stamps_load_sessions_and_gauges(self):
        def story(pk):
            h = RouterHarness(pk)
            h.submit(pk.request("a", "s1", output=400))
            h.run(2)
            snap = pk.REGISTRY.snapshot()
            gauges = {name: snap[name] for name in (
                "nos_tpu_request_kv_occupancy", "nos_tpu_request_queue_depth",
                "nos_tpu_request_sessions")}
            return h.view(), gauges

        view, gauges = same(story)
        holder = max(view["occ"], key=view["occ"].get)
        assert view["pods"][holder] == (f"{view['occ'][holder]:.3f}", "1")
        assert gauges["nos_tpu_request_sessions"] == {"service=chat": 1.0}

    def test_disaggregated_prefill_hands_off_to_decode_pool(self):
        def story(pk):
            svc = pk.service(prefill_service="chat-prefill",
                             decode_service="chat-decode",
                             decode_costs=pk.costs())
            h = RouterHarness(pk, svc, replicas=0)
            h.api.create("Pod", pk.replica_pod("pf-0", "chat-prefill"))
            h.api.create("Pod", pk.replica_pod("dec-0", "chat-decode"))
            req = pk.request("a", "s1", prompt=64, output=8)
            h.submit(req)
            h.run(40)
            return req_state(req), h.view()

        req, view = same(story)
        assert view["stats"]["serve/chat"]["completed"] == 1
        assert req[3] >= req[2] and view["occ"]["dec-0"] == 0.0

    def test_session_expiry_forgets_idle_sessions(self):
        def story(pk):
            h = RouterHarness(pk, pk.service(session_idle_s=1.0))
            h.submit(pk.request("a", "s1", output=2))
            h.run(4)
            mid = h.router.session_count("serve/chat")
            h.run(30)
            return mid, h.router.session_count("serve/chat")

        assert same(story) == (1, 0)

    def test_duplicate_service_rejected(self):
        def story(pk):
            svc = pk.service()
            with pytest.raises(ValueError, match="duplicate"):
                pk.R.ServingRouter(pk.client.APIServer(), [svc, svc],
                                   clock=lambda: 0.0)
            with pytest.raises(ValueError, match="publish_every_ticks"):
                pk.R.ServingRouter(pk.client.APIServer(), [svc],
                                   clock=lambda: 0.0, publish_every_ticks=0)
            return True

        same(story)

    def test_a_stamp_on_a_vanished_pod_or_a_spent_retry_does_not_raise(
            self, monkeypatch):
        """NotFound at the stamp is skipped and the pod dropped at the
        next refresh; a stamp whose retries are spent is logged and made
        again at the next publish, as in JAX."""
        import nos_tpu.requests.router as jax_router_mod

        from nos_tpu_torch.requests import router as port_router_mod

        for mod in (jax_router_mod, port_router_mod):
            monkeypatch.setattr(mod, "retry_on_conflict", _flaky_patch)

        def story(pk):
            h = RouterHarness(pk)
            _FLAKY.update(kind="conflict", calls=0, pk=pk)
            h.submit(pk.request("a", "s1", output=400))
            h.run(1)
            _FLAKY.update(kind="gone")
            h.run(1)
            _FLAKY.update(kind=None)
            h.run(1)
            return h.view()

        view = same(story)
        assert all(v[0] is not None for v in view["pods"].values())


_FLAKY: dict = {}


def _flaky_patch(api, kind, name, mutate, namespace="", *, component=""):
    pk = _FLAKY["pk"]
    if _FLAKY["kind"] == "conflict":
        raise pk.client.Conflict(name)
    if _FLAKY["kind"] == "gone":
        raise pk.client.NotFound(name)
    return api.patch(kind, name, namespace, mutate=mutate)


class TestRouterOverREST:
    def test_the_router_runs_the_same_over_the_rest_client(self):
        """The router on ``KubeClient`` against the stub: the same
        decisions, stamps and journal as on the in-memory API (and as
        JAX's), a replica deleted over REST migrating its session."""
        import k8s_stub

        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

        def story(api):
            pk = Pkg(False)
            h = RouterHarness(pk, api=api)
            h.submit(pk.request("a", "s1", output=400),
                     pk.request("b", "s2", output=300))
            h.run(3)
            occ = h.router.kv_occupancies("serve/chat")
            api.delete("Pod", max(occ, key=occ.get), "serve")
            h.run(3)
            return h.view()

        mem = story(port_client.APIServer())
        with k8s_stub.StubApiServer() as stub:
            client = KubeClient(KubeConfig(server=stub.url))
            try:
                rest = story(client)
            finally:
                client.close()
        assert rest == mem
        assert any(r[0] == "session-migrated" for r in rest["journal"])


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


class TestRouterConfig:
    SERVICE = {
        "name": "chat",
        "model": {"name": "m", "num_layers": 2, "num_heads": 2,
                  "num_kv_heads": 2, "head_dim": 8,
                  "intermediate_size": 16, "weights_gb": 0.5},
        "prefill": {"device_kind": H100, "hbm_gb": 1.0},
    }

    def both_load(self, raw: dict):
        """The port's RouterConfig and JAX's on one service mapping (the
        JAX side's cost block in its own keys)."""
        jraw = dict(raw)
        for block in ("prefill", "decode"):
            if block in raw:
                jraw[block] = jax_cost_kwargs(raw[block])
        return (RouterConfig(enabled=True, services=[dict(raw)]),
                JaxRouterConfig(enabled=True, services=[jraw]))

    def test_round_trip(self):
        port, jax = self.both_load(self.SERVICE)
        port.validate()
        jax.validate()
        svc = port_requests.RouterService.from_mapping(self.SERVICE)
        assert svc.key == "serve/chat" and not svc.disaggregated
        assert not RouterConfig().enabled and RouterConfig().validate() \
            is None

    @pytest.mark.parametrize("edit,match", [
        ({"max_qeue": 3}, "max_qeue"),
        ({"decode_service": "chat-decode"}, "decode_costs"),
        ({"model": [1]}, "model"),
        ({"prefill": {"device_kind": H100, "hbm_gb": 1.0, "chipz": 1}},
         "chipz"),
    ])
    def test_a_bad_service_fails_both_loads(self, edit, match):
        bad = {**self.SERVICE, **edit}
        port, jax = self.both_load(bad)
        with pytest.raises(ConfigError, match=match):
            port.validate()
        with pytest.raises(JaxConfigError, match=match):
            jax.validate()

    @pytest.mark.parametrize("prefill,match", [
        ({"device_kind": "v5e", "hbm_gb": 1.0}, "no published peaks"),
        ({"device_kind": H100, "chips": 2, "hbm_gb": 1.0}, "chips must"),
        ({"device_kind": H100, "hbm_gb": 1.0, "mig_profile": "1x1"},
         "not a MIG profile"),
    ])
    def test_a_tpu_config_fails_the_port_s_load(self, prefill, match):
        with pytest.raises(ConfigError, match=match):
            RouterConfig(services=[{**self.SERVICE,
                                    "prefill": prefill}]).validate()

    @pytest.mark.parametrize("knob,value", [
        ("tick_interval_s", 0.0), ("publish_every_ticks", 0),
        ("workers", -1), ("services", {"a": 1})])
    def test_knobs_are_checked_as_jax_checks_them(self, knob, value):
        with pytest.raises(ConfigError):
            RouterConfig(**{knob: value}).validate()
        with pytest.raises(JaxConfigError):
            JaxRouterConfig(**{knob: value}).validate()


# ---------------------------------------------------------------------------
# Determinism
# ---------------------------------------------------------------------------


def deterministic_run(pk: Pkg, *, install_order=(0, 1), workers=0) -> list:
    """One router-only run: two seeded arrival streams over two fixed
    replicas and a replica lost at t=2; the journal rows."""
    eng = pk.E.SimEngine()
    api = pk.client.APIServer()
    for i in range(2):
        api.create("Pod", pk.replica_pod(f"chat-r{i}"))
    svc = pk.service(max_queue_per_replica=2, max_retries=1,
                     retry_backoff_s=0.05)
    router = pk.R.ServingRouter(api, [svc], clock=eng.clock,
                                workers=workers, publish_every_ticks=2)
    journal = pk.J.DecisionJournal(maxlen=50_000, clock=eng.now)

    def make_source(idx: int):
        shapes = random.Random(100 + idx)
        counter = [0]

        def fire(t: float) -> None:
            counter[0] += 1
            router.submit("serve/chat", pk.R.Request(
                "chat", f"src{idx}-{counter[0]}", f"s{shapes.randrange(6)}",
                shapes.randrange(20, 120), shapes.randrange(2, 30), t))

        return pk.T.ArrivalSource(7 + idx, lambda t: 30.0, fire,
                                  peak_rate=30.0, until=4.0,
                                  label=f"arrivals-{idx}")

    sources = [make_source(0), make_source(1)]
    with pk.scoped(journal=journal):
        for idx in install_order:
            sources[idx].install(eng)
        eng.tick_loop(0.05, lambda: router.tick(0.05), until=6.0,
                      label="router-tick")
        eng.at(2.0, lambda: api.delete("Pod", "chat-r0", "serve"),
               label="replica-loss")
        eng.run()
    return pk.rows(journal)


class TestDeterminism:
    @pytest.mark.parametrize("install_order,workers", [
        ((1, 0), 0), ((0, 1), 2), ((0, 1), 4), ((1, 0), 4)])
    def test_journal_identical_across_order_workers_and_packages(
            self, install_order, workers):
        base = deterministic_run(Pkg(True))
        assert any(r[0] == "session-migrated" for r in base)
        assert any(r[0] == "request-shed" for r in base)
        port = deterministic_run(Pkg(False), install_order=install_order,
                                 workers=workers)
        assert port == base


# ---------------------------------------------------------------------------
# The burst, end to end
# ---------------------------------------------------------------------------


def burst_run(pk: Pkg) -> dict:
    """KV pressure scaling an MPS service: a request burst raises the
    replicas' published occupancy, the autoscaler adds replicas, the
    scheduler binds them on free 8 GB shares of a carved node (JAX's:
    the 80 GB stand-in of ``tests/test_torch_timeshare.py``)."""
    from test_torch_timeshare import JAX_GEN as JAX_TS_GEN

    api = pk.client.APIServer()
    if pk.jax:
        from nos_tpu.cmd.assembly import build_scheduler
        from nos_tpu.controllers.kubelet import admit_bound_pods
        from nos_tpu.serving.autoscaler import (
            ReplicaAutoscaler, ServingService)

        api.create("Node", jax_factory.make_tpu_node(
            "host-0", generation=JAX_TS_GEN, partitioning="timeshare",
            status_geometry={"free": {"8gb": 8}}))
        sched = build_scheduler(api, 80)
    else:
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.controllers.kubelet import admit_bound_pods
        from nos_tpu_torch.serving.autoscaler import (
            ReplicaAutoscaler, ServingService)

        api.create("Node", port_factory.make_gpu_node(
            "host-0", gpus=1, status_geometry={0: {"free": {"8gb": 8}}}))
        sched = build_scheduler(api)
    now = [0.0]
    autoscaler = ReplicaAutoscaler(api, [ServingService(
        name="chat", namespace="serve", timeshare_gb=8, min_replicas=1,
        max_replicas=8, target_load_per_replica=0.55,
        scale_up_cooldown_s=0.0, scale_down_cooldown_s=60.0,
        down_hysteresis=0.2)], clock=lambda: now[0])
    router = pk.R.ServingRouter(
        api, [pk.service(max_queue_per_replica=8, max_retries=6,
                         retry_backoff_s=0.2)],
        clock=lambda: now[0], publish_every_ticks=1)
    journal = pk.J.DecisionJournal(maxlen=50_000, clock=lambda: now[0])
    rng = random.Random(3)
    rid = 0
    with pk.scoped(journal=journal):
        for step in range(400):
            now[0] = step * 0.05
            burst = 6 if 2.0 <= now[0] < 10.0 else \
                (1 if step % 4 == 0 else 0)
            for _ in range(burst):
                rid += 1
                router.submit("serve/chat", pk.R.Request(
                    "chat", f"r{rid}", f"s{rng.randrange(40)}",
                    rng.randrange(40, 120), rng.randrange(32, 96), now[0]))
            router.tick(0.05)
            autoscaler.reconcile()
            sched.run_cycle()
            admit_bound_pods(api, "host-0")
    sched.close() if hasattr(sched, "close") else None
    pods = sorted((p.metadata.name, p.spec.node_name, p.status.phase)
                  for p in api.list("Pod", namespace="serve"))
    rows = [r for r in pk.rows(journal)
            if r[0] in ("autoscale", "request-shed", "session-migrated",
                        "preemption")]
    return {"stats": router.stats(), "pods": pods, "journal": rows}


class TestBurstE2E:
    def test_kv_pressure_scales_up_with_zero_serving_preemptions(self):
        out = same(burst_run)
        stats = out["stats"]["serve/chat"]
        assert stats["completed"] > 100 and stats["shed"] == 0
        assert len(out["pods"]) > 1
        assert any(r[0] == "autoscale" for r in out["journal"])
        assert not [r for r in out["journal"] if r[0] == "preemption"]


def test_the_package_surface_is_jax_s():
    assert set(port_requests.__all__) == set(jax_requests.__all__)
    assert (port_requests.PHASE_PREFILL, port_requests.PHASE_DECODE,
            port_requests.PHASE_TOTAL) == (
        jax_requests.PHASE_PREFILL, jax_requests.PHASE_DECODE,
        jax_requests.PHASE_TOTAL)
    assert types.SimpleNamespace(**{
        k: getattr(port_journal, k) for k in ("AUTOSCALE", "REQUEST_SHED",
                                              "SESSION_MIGRATED")}) == \
        types.SimpleNamespace(**{
            k: getattr(jax_journal, k) for k in ("AUTOSCALE", "REQUEST_SHED",
                                                 "SESSION_MIGRATED")})


# ---------------------------------------------------------------------------
# The router-on serving fleet
# ---------------------------------------------------------------------------


# fleet.plan_digest of the port's router-on run's whole journal (every
# record, plan ids out), at 0 router workers
REQUEST_FLEET_JOURNAL = \
    "84d0285e5a38fa7a747556c7679267c5d49c9a148f3da5a7c31fb8db66db49da"


class TestRequestFleet:
    def test_the_jax_run_hashes_to_the_pinned_digest(self, monkeypatch):
        """bench_requests.py's run, mapped (the router on: chat
        disaggregated on 3g.40gb prefill and 1g.20gb decode replicas,
        embed aggregated on 8 GB shares), on the JAX package: its summary
        is ``REQUEST_FLEET_DIGEST`` and it meets the invariants the smoke
        holds."""
        import chip_smoke
        import serving_twin

        from nos_tpu_torch.testing import fleet

        out = serving_twin.jax_serving_run(
            monkeypatch, fleet.serving_fleet_spec(0, router=True))
        assert fleet.plan_digest(out["summary"]) == \
            chip_smoke.REQUEST_FLEET_DIGEST
        assert chip_smoke.serving_invariants(out) == \
            chip_smoke.REQUEST_FLEET_MET
        stats = out["requests"]["serve/chat"]
        assert stats["completed"] > 0 and stats["migrated"] > 0
        assert out["scale_events"]["up"] > 0 and \
            out["scale_events"]["down"] > 0

    @pytest.mark.parametrize("workers", [0, 4])
    def test_the_port_s_run_is_jax_s_at_any_worker_count(self, workers):
        """The smoke's router-on run on the port at 0 and at 4 router
        workers: each hashes to the digest, meets every held invariant
        and writes the journal ``REQUEST_FLEET_JOURNAL`` pins (the 0
        worker run's, so the two are byte-identical); the waterfall
        conserves.  (The smoke runs both in one call and compares them.)"""
        import chip_smoke

        line = chip_smoke._serving_fleet_runs(router=True, runs=1,
                                              workers=(workers,))
        assert line["digest"] == chip_smoke.REQUEST_FLEET_DIGEST
        assert line["journal_digest"] == REQUEST_FLEET_JOURNAL
        assert set(line["router_tick_ms"]) == {str(workers)}
        assert line["invariants"] == chip_smoke.REQUEST_FLEET_MET
        assert all(abs(d) <= 1e-6
                   for d in line["waste"]["conservation_delta"].values())
        if workers == 0:
            self.check_top_reads_the_rows(line)

    @staticmethod
    def check_top_reads_the_rows(line: dict) -> None:
        """``obs top``'s request rows, which no block fed before: the
        fleet's rows (bench_requests.py's keys) print the same lines on
        both packages' ``top``."""
        import contextlib
        import io

        from nos_tpu.obs.__main__ import cmd_top as jax_top

        from nos_tpu_torch.obs.__main__ import cmd_top
        from nos_tpu_torch.testing import fleet

        payload = {"state": {}, "requests": line["requests"],
                   "trace_seconds": fleet.SERVING_TRACE_S}
        outs = []
        for top in (cmd_top, jax_top):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert top(payload) == 0
            text = buf.getvalue()
            outs.append(text[text.index("requests by service:"):
                             text.index("tier ")])
        assert outs[0] == outs[1]
        assert "serve/chat" in outs[0] and "serve/embed" in outs[0]

    def test_the_spec_keeps_the_bench_s_request_mix(self):
        import bench_requests as br
        import serving_twin

        from nos_tpu_torch.testing import fleet

        spec = fleet.serving_fleet_spec(0, router=True)
        for port, jax in zip(spec["autoscaled"], br.ROUTER_AUTOSCALED):
            mapped = serving_twin.jax_service(port)
            for key, value in mapped.items():
                assert getattr(jax, key) == value, key
        for port, jax in zip(spec["routed"], br.ROUTER_SERVICES):
            for key in ("name", "namespace", "prefill_service",
                        "decode_service", "max_queue_per_replica",
                        "max_retries", "retry_backoff_s", "session_idle_s"):
                assert port.get(key, getattr(jax, key)) == getattr(jax, key)
            model = port["model"]
            for key, value in model.items():
                assert getattr(jax.model, key) == value, key
            assert port["prefill"]["mfu"] == jax.prefill_costs.mfu
        assert (fleet.REQUEST_CHAT_PROMPT, fleet.REQUEST_CHAT_OUTPUT,
                fleet.REQUEST_CHAT_SESSIONS, fleet.REQUEST_EMBED_PROMPT) == (
            br.CHAT_PROMPT, br.CHAT_OUTPUT, br.CHAT_SESSIONS,
            br.EMBED_PROMPT)
        assert fleet.REQUEST_SERVICE_TIME_S == br.SERVICE_TIME_S
        traces = br.request_traces(0)
        for key, kw in fleet.serving_traces(0, True).items():
            assert vars(traces[key]) == vars(
                jax_requests_trace(**kw))
        # the decode unit holds the chat model's weights with KV room
        decode = spec["routed"][0]["decode"]
        assert decode["hbm_gb"] > fleet.CHAT_MODEL["weights_gb"]


def jax_requests_trace(**kw):
    from nos_tpu.serving import DiurnalTrace

    return DiurnalTrace(**kw)
