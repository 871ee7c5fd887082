"""The port's leader election (``nos_tpu_torch/kube/leaderelection.py``)
held to the JAX package's: the seven stories of
``tests/test_leaderelection.py``, each on the port's elector in memory
and on ``kube/rest.py``'s ``KubeClient`` over ``tests/k8s_stub.py``,
beside JAX's elector on its own in-memory API (a story's trace of step
outcomes must be JAX's); then a two-candidate CAS race, where exactly
one candidate may win."""

from __future__ import annotations

import contextlib
import threading
import time

import pytest

from nos_tpu.kube import leaderelection as jax_le
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.kube.client import KIND_CONFIGMAP as JAX_KIND_CONFIGMAP
from nos_tpu_torch.kube import leaderelection as port_le
from nos_tpu_torch.kube.client import APIServer, KIND_CONFIGMAP
from nos_tpu_torch.kube.objects import ConfigMap, ObjectMeta

SUBSTRATES = ["memory", "rest"]


class FakeClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


@contextlib.contextmanager
def port_api(substrate: str):
    if substrate == "memory":
        yield APIServer()
        return
    from k8s_stub import StubApiServer
    from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

    with StubApiServer() as stub:
        client = KubeClient(KubeConfig(server=stub.url))
        try:
            yield client
        finally:
            client.close()


@contextlib.contextmanager
def sides(substrate: str):
    """(package, api) for the port on ``substrate`` and JAX in memory."""
    with port_api(substrate) as api:
        yield [(port_le, api, KIND_CONFIGMAP),
               (jax_le, JaxAPIServer(), JAX_KIND_CONFIGMAP)]


def both(substrate: str, story) -> None:
    """Run ``story(le, api, kind)`` for the port and for JAX; the traces
    must be equal."""
    with sides(substrate) as pair:
        traces = [story(le, api, kind) for le, api, kind in pair]
    assert traces[0] == traces[1]


@pytest.mark.parametrize("substrate", SUBSTRATES)
class TestElectorStories:
    def test_first_candidate_acquires(self, substrate):
        def story(le, api, kind):
            e = le.LeaderElector(api, "lease", identity="a")
            return [e.try_acquire_or_renew(), e.try_acquire_or_renew()]

        both(substrate, story)

    def test_second_candidate_blocked_until_expiry(self, substrate):
        def story(le, api, kind):
            clock = FakeClock()
            a = le.LeaderElector(api, "lease", identity="a", clock=clock,
                                 lease_duration_s=15.0)
            b = le.LeaderElector(api, "lease", identity="b", clock=clock,
                                 lease_duration_s=15.0)
            out = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            clock.now += 16.0  # a's lease expires un-renewed
            out += [b.try_acquire_or_renew(), a.try_acquire_or_renew()]
            assert out == ["leading", "blocked", "leading", "blocked"]
            return out

        both(substrate, story)

    def test_release_hands_over_immediately(self, substrate):
        def story(le, api, kind):
            clock = FakeClock()
            a = le.LeaderElector(api, "lease", identity="a", clock=clock)
            b = le.LeaderElector(api, "lease", identity="b", clock=clock)
            out = [a.try_acquire_or_renew()]
            a._release()
            out.append(b.try_acquire_or_renew())  # no wait for expiry
            cm = api.get(kind, "lease", "nos-tpu-system")
            holder = cm.metadata.annotations[le.ANN_HOLDER]
            assert out == ["leading", "leading"] and holder == "b"
            return out + [holder]

        both(substrate, story)

    def test_run_loop_failover(self, substrate):
        def story(le, api, kind):
            a = le.LeaderElector(api, "lease", identity="a",
                                 lease_duration_s=0.6, renew_s=0.1,
                                 retry_s=0.05)
            b = le.LeaderElector(api, "lease", identity="b",
                                 lease_duration_s=0.6, renew_s=0.1,
                                 retry_s=0.05)
            stop_a, stop_b = threading.Event(), threading.Event()
            ta = threading.Thread(target=a.run, args=(stop_a,), daemon=True)
            tb = threading.Thread(target=b.run, args=(stop_b,), daemon=True)
            ta.start()
            out = [a.is_leader.wait(2.0)]
            tb.start()
            time.sleep(0.3)
            out.append(b.is_leader.is_set())
            stop_a.set()          # the leader stops and releases
            ta.join(2.0)
            out.append(b.is_leader.wait(3.0))
            stop_b.set()
            tb.join(2.0)
            assert out == [True, False, True], "standby never took over"
            return out

        both(substrate, story)

    def test_transient_error_does_not_demote_a_valid_leader(self, substrate):
        def story(le, api, kind):
            died = threading.Event()
            a = le.LeaderElector(api, "lease", identity="a",
                                 lease_duration_s=8.0, renew_s=0.05,
                                 retry_s=0.05, on_stopped_leading=died.set)
            stop = threading.Event()
            t = threading.Thread(target=a.run, args=(stop,), daemon=True)
            t.start()
            out = [a.is_leader.wait(2.0)]
            real_update = api.update
            fails = {"n": 3}

            def flaky_update(kind, obj):
                if fails["n"] > 0:
                    fails["n"] -= 1
                    raise OSError("injected apiserver blip")
                return real_update(kind, obj)

            api.update = flaky_update
            time.sleep(0.5)  # several failed renews, the lease still valid
            out += [died.is_set(), a.is_leader.is_set(), fails["n"]]
            stop.set()
            t.join(2.0)
            assert out == [True, False, True, 0], "a blip demoted a leader"
            return out

        both(substrate, story)

    def test_losing_acquired_lease_is_fatal(self, substrate):
        def story(le, api, kind):
            died = threading.Event()
            a = le.LeaderElector(api, "lease", identity="a",
                                 lease_duration_s=5.0, renew_s=0.05,
                                 on_stopped_leading=died.set)
            stop = threading.Event()
            t = threading.Thread(target=a.run, args=(stop,), daemon=True)
            t.start()
            out = [a.is_leader.wait(2.0)]

            def steal(cm):
                cm.metadata.annotations[le.ANN_HOLDER] = "b"
                cm.metadata.annotations[le.ANN_DEADLINE] = str(
                    time.time() + 100.0)

            api.patch(kind, "lease", "nos-tpu-system", mutate=steal)
            out.append(died.wait(3.0))
            t.join(2.0)
            out += [t.is_alive(), a.is_leader.is_set()]
            stop.set()
            assert out == [True, True, False, False]
            return out

        both(substrate, story)

    def test_only_leader_ticks_and_failover_promotes_standby(self, substrate):
        from nos_tpu.cmd._runtime import Main as JaxMain
        from nos_tpu_torch.cmd._runtime import Main as PortMain

        def story(le, api, kind):
            main_cls = PortMain if le is port_le else JaxMain
            counts = {"a": 0, "b": 0}

            def build(name: str):
                m = main_cls(f"m-{name}", api=api)
                m.attach_leader_election(le.LeaderElector(
                    api, "cm-lease", identity=name,
                    lease_duration_s=0.6, renew_s=0.1, retry_s=0.05))

                def tick(name=name):
                    counts[name] += 1

                m.add_loop("tick", tick, 0.02)
                return m

            ma, mb = build("a"), build("b")
            ma.start()
            time.sleep(0.4)
            mb.start()
            time.sleep(0.4)
            out = [counts["a"] > 0, counts["b"]]
            ma.shutdown()        # releases the lease
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and counts["b"] == 0:
                time.sleep(0.05)
            out.append(counts["b"] > 0)
            mb.shutdown()
            assert out == [True, 0, True], "standby ticked or never rose"
            return out

        both(substrate, story)


class _RaceApi:
    """``api`` whose ``update`` waits until every candidate has read the
    lease: both PUT the version they read, and only one can land."""

    def __init__(self, api, barrier: threading.Barrier) -> None:
        self._api = api
        self._barrier = barrier

    def __getattr__(self, name):
        return getattr(self._api, name)

    def update(self, kind, obj):
        self._barrier.wait(5.0)
        return self._api.update(kind, obj)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_two_candidates_race_for_an_expired_lease_one_wins(substrate):
    """A lease expired under a third holder; two candidates read it, then
    both write: the update carries the version read, so one gets a
    Conflict (ERROR) and exactly one leads, in each of five rounds."""
    with port_api(substrate) as api:
        for round_ in range(5):
            name = f"race-{round_}"
            api.create(KIND_CONFIGMAP, ConfigMap(metadata=ObjectMeta(
                name=name, namespace="nos-tpu-system",
                annotations={port_le.ANN_HOLDER: "c",
                             port_le.ANN_DEADLINE: "1.0"})))
            barrier = threading.Barrier(2)
            electors = [port_le.LeaderElector(_RaceApi(api, barrier), name,
                                              identity=who)
                        for who in ("a", "b")]
            outcomes: dict[str, str] = {}

            def step(e):
                outcomes[e.identity] = e.try_acquire_or_renew()

            threads = [threading.Thread(target=step, args=(e,))
                       for e in electors]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10.0)
            assert sorted(outcomes.values()) == ["error", "leading"]
            (winner,) = [w for w, o in outcomes.items() if o == "leading"]
            cm = api.get(KIND_CONFIGMAP, name, "nos-tpu-system")
            assert cm.metadata.annotations[port_le.ANN_HOLDER] == winner


def test_annotations_use_the_port_group():
    from nos_tpu_torch.api.constants import GROUP

    assert port_le.ANN_HOLDER == f"{GROUP}/leader"
    assert port_le.ANN_DEADLINE == f"{GROUP}/lease-renew-deadline"
