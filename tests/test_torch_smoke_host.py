"""chip_smoke.py's host work: the one background process that runs the
host-only jobs (the fleets of phases 11 to 17, phases 18 to 20, the
deploy on-ramp) beside
the card phases, hands each result back, fails the smoke on a failed
check, and is stopped with every process it started."""

from __future__ import annotations

import inspect

import pytest

import chip_smoke


def test_every_job_is_a_function_of_the_smoke():
    keys = [key for key, _ in chip_smoke.HOST_JOBS]
    assert len(set(keys)) == len(keys)
    assert set(chip_smoke.HOST_LINES) <= set(keys)
    for key, fn in chip_smoke.HOST_JOBS:
        params = inspect.signature(getattr(chip_smoke, fn)).parameters
        if key in chip_smoke.HOST_LINES:
            assert list(params) == ["smi"], fn
        else:
            assert all(p.default is not p.empty for p in params.values()), fn


def test_the_phases_read_the_jobs_in_their_order():
    """The process runs the jobs in turn, so each must be queued before
    any that a later phase reads."""
    src = inspect.getsource(chip_smoke)
    at = [src.index(f'_host_result("{key}", "{fn}")')
          for key, fn in chip_smoke.HOST_JOBS
          if key not in chip_smoke.HOST_LINES]
    assert at == sorted(at)
    lines = chip_smoke.HOST_LINES
    assert [key for key, _ in chip_smoke.HOST_JOBS][-len(lines):] == \
        list(lines)


def test_a_queued_job_comes_from_the_process(monkeypatch):
    work = chip_smoke._HostWork([("quota", "_quota_fleet_runs",
                                  {"runs": 1})])
    monkeypatch.setattr(chip_smoke, "_HOST", work)
    try:
        value, seconds = chip_smoke._host_result("quota", "_quota_fleet_runs")
    finally:
        work.close()
    assert value["runs"] == 1
    assert value["digest"] == chip_smoke.QUOTA_FLEET_DIGEST
    assert seconds > 0
    assert work.proc.returncode is not None
    assert not work.dir.exists()


def test_a_failed_check_fails_the_smoke_with_its_message():
    work = chip_smoke._HostWork([("bad", "fail", {"msg": "boom"}),
                                 ("later", "_quota_fleet_runs", {})])
    try:
        with pytest.raises(SystemExit,
                           match="the host work's bad: chip_smoke FAILED: "
                                 "boom"):
            work.result("bad")
        # the process ended at the failure and ran nothing after it
        work.proc.wait(timeout=60)
        with pytest.raises(SystemExit, match="exited 1 before later"):
            work.result("later")
    finally:
        work.close()


def test_close_stops_a_running_job():
    work = chip_smoke._HostWork([("quota", "_quota_fleet_runs",
                                  {"runs": 50})])
    work.close()
    assert work.proc.returncode is not None
    assert not work.dir.exists()


def test_without_the_process_a_job_runs_here(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_HOST", None)
    monkeypatch.setattr(chip_smoke, "_probe_job", lambda: 7, raising=False)
    value, seconds = chip_smoke._host_result("probe", "_probe_job")
    assert value == 7 and seconds >= 0
