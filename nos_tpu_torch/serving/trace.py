"""Deterministic bursty, diurnal, millions-of-users request streams,
``nos_tpu/serving/trace.py`` for the port (copied: the same seed gives
the same curve).

The serving fleets need inference traffic with the three properties
production load balancers actually see:

- **diurnal swing** — the user population follows a day curve; the
  trace compresses one "day" into ``period_s`` virtual seconds and
  maps it onto ``[base_users, peak_users]`` (millions at the peak);
- **bursts** — seeded Poisson burst windows multiply the arrival rate
  (a homepage feature, a retry storm), which is what exercises the
  autoscaler's scale-up cooldown and the scheduler's reclaim path;
- **Little's law load** — the autoscaler's signal is
  requests-IN-FLIGHT, so the trace converts arrival rate to
  concurrency: ``users(t) * requests_per_user_per_s *
  service_time_s``.

Everything is a pure function of ``t`` (the burst schedule is
pre-drawn from one ``random.Random(seed)`` at construction), so a
seed reproduces the exact load curve (no clock calls here: time is an
argument).
"""

from __future__ import annotations

import math
import random


class DiurnalTrace:
    """One service's load curve (module docstring).  ``load_at(t)``
    returns requests-in-flight at virtual time ``t``; ``users_at`` and
    ``burst_multiplier_at`` expose the components for reporting."""

    def __init__(self, *, seed: int = 0,
                 period_s: float = 120.0,
                 base_users: float = 200_000.0,
                 peak_users: float = 2_000_000.0,
                 requests_per_user_per_s: float = 2e-5,
                 service_time_s: float = 0.5,
                 burst_rate_per_s: float = 1.0 / 45.0,
                 burst_multiplier: float = 3.0,
                 burst_duration_s: float = 8.0,
                 phase_s: float = 0.0,
                 horizon_s: float = 3600.0) -> None:
        if peak_users < base_users:
            raise ValueError("peak_users must be >= base_users")
        if period_s <= 0 or service_time_s <= 0:
            raise ValueError("period_s and service_time_s must be > 0")
        if burst_multiplier < 1.0:
            raise ValueError("burst_multiplier must be >= 1")
        self._period = period_s
        self._base = base_users
        self._peak = peak_users
        self._rps_per_user = requests_per_user_per_s
        self._service_time = service_time_s
        self._phase = phase_s
        # Pre-drawn burst windows (start, end, multiplier) over the
        # horizon: Poisson starts, jittered duration and height.
        rng = random.Random(seed)
        bursts: list[tuple[float, float, float]] = []
        t = 0.0
        while burst_rate_per_s > 0.0:
            t += rng.expovariate(burst_rate_per_s)
            if t >= horizon_s:
                break
            duration = burst_duration_s * (0.5 + rng.random())
            height = 1.0 + (burst_multiplier - 1.0) \
                * (0.5 + 0.5 * rng.random())
            bursts.append((t, t + duration, height))
        self._bursts = bursts

    def users_at(self, t: float) -> float:
        """Diurnal active-user count: sinusoid over ``period_s`` mapped
        onto [base, peak]."""
        swing = 0.5 * (1.0 + math.sin(
            2.0 * math.pi * (t + self._phase) / self._period))
        return self._base + (self._peak - self._base) * swing

    def burst_multiplier_at(self, t: float) -> float:
        """Product of the burst windows covering ``t`` (1.0 outside)."""
        mult = 1.0
        for start, end, height in self._bursts:
            if start > t:
                break           # starts are sorted
            if t < end:
                mult *= height
        return mult

    def load_at(self, t: float) -> float:
        """Requests in flight at ``t`` (Little's law: arrival rate x
        service time), burst-scaled."""
        rate = self.users_at(t) * self._rps_per_user \
            * self.burst_multiplier_at(t)
        return rate * self._service_time
