"""GPU sharing comparison: inference latency under contention.

The port of ``demos/tpu-sharing-comparison/run.py``, and the analog of
the reference's gpu-sharing-comparison demo (the source of every
published number in BASELINE.md): N concurrent clients run inference
against ONE card and we measure per-request latency as N grows.

- "timeshare" is nos-tpu's fractional sharing: co-located pods submit
  to the same card under a timeshare grant (``nvidia.com/gpu-<N>gb``),
  and the GPU time-slices their CUDA contexts.  Per-request latency
  degrades roughly linearly with the number of sharers.
- "dedicated" is the partitioner's isolation story: a workload that owns
  its device keeps the N=1 latency however many neighbours run
  elsewhere.  On a one-card host that is the N=1 row; ``run_isolated``
  measures it beside busy neighbours where the host has more cards.

Each client is a process of its own (``python run.py --worker``), not a
thread as in the JAX demo: threads of one process share one CUDA context
and one stream, which would measure stream serialization and not the
time-slicing between pods.  Every client runs under the grant the device
plugin gives a pod (``NOS_TPU_VISIBLE_CHIPS`` = the card's UUID,
``NOS_TPU_TIMESHARE_GB`` = GRANT_GB), applied by
``nos_tpu_torch.device.workload_env``.  The largest count of clients
starts once, all at the same time, builds the model from one seed and
warms it; each row then releases the first N of them at one instant on
the host's monotonic clock.  A client that fails, or peaks at its cap,
fails the demo.

    python demos/gpu-sharing-comparison/run.py [--device cuda]

Prints one JSON line per client count, a summary and the isolated row;
paste the table into README.md when re-measuring.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from nos_tpu_torch import resolve_device  # noqa: E402
from nos_tpu_torch.models.llama import (BENCH_350M, Llama,  # noqa: E402
                                        LlamaConfig, init_params)
from nos_tpu_torch.ops.roofline import card_line  # noqa: E402

REQUESTS_PER_CLIENT = 6
CLIENT_COUNTS = [1, 2, 4, 7]
BATCH, SEQ = 8, 2048
# Each client's timeshare grant: seven take 70 of an H100's 80 GB.
GRANT_GB = 10
# Seconds between a row's release and the instant its clients start:
# every client has read its release by then.
START_DELAY_S = 0.5
WORKER_TIMEOUT_S = 600.0


def demo_config(**changes) -> LlamaConfig:
    """BENCH_350M with flash attention and no remat, as the JAX demo
    builds it; ``changes`` replace other fields (the tests' widths)."""
    return dataclasses.replace(
        BENCH_350M, **({"attn_impl": "flash", "remat": False} | changes))


class Request:
    """One serving-shaped forward: the logits of the last position,
    summed and fetched to the host (``.item()``), a real round trip as
    the JAX demo's ``float(...)`` is.  ``last`` keeps the last call's
    logits [batch, vocab]."""

    def __init__(self, model: Llama, tokens: torch.Tensor) -> None:
        self.model, self.tokens = model, tokens
        self.last: torch.Tensor | None = None

    def __call__(self) -> float:
        with torch.no_grad():
            self.last = self.model(self.tokens)[:, -1, :]
        return self.last.sum().item()


def build_model(device: str | torch.device = "cuda",
                cfg: LlamaConfig | None = None, batch: int = BATCH,
                seq: int = SEQ) -> Request:
    """The demo's request on ``device``: ``demo_config()`` (or ``cfg``)
    with parameters from a generator seeded 1 and tokens [batch, seq]
    drawn on the CPU from a generator seeded 0, so every process builds
    the same request.  Warmed once, as the JAX demo compiles once."""
    dev = resolve_device(device)
    cfg = cfg or demo_config()
    model = Llama(cfg, device=dev)
    model.load_state_dict(init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev), assign=True)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0)).to(dev)
    request = Request(model, tokens)
    request()
    return request


def row(n_clients: int, latencies: list[float]) -> dict:
    return {
        "clients": n_clients,
        "mean_s": round(statistics.mean(latencies), 4),
        # with 6 requests/client the honest tail statistic is the max
        "max_s": round(max(latencies), 4),
        "requests": len(latencies),
    }


def summary(rows: list[dict], device: str) -> dict:
    base = rows[0]["mean_s"]
    return {
        "summary": "timeshare contention vs dedicated",
        "dedicated_mean_s": base,
        "degradation": {str(r["clients"]): round(r["mean_s"] / base, 2)
                        for r in rows},
        "device": device,
    }


# -- the clients --------------------------------------------------------------

def _worker(spec: dict) -> None:
    """A client process: apply the grant, build and warm the request,
    then serve the parent's commands on stdin, one JSON line each on
    stdout: ``{"go": t}`` runs one warm and REQUESTS_PER_CLIENT timed
    requests from the monotonic instant t; ``{"stop": true}`` reports
    the launches (by tile: ``attention.tile_name``), peaks and the last
    logits, and ends."""
    from nos_tpu_torch.device import workload_env
    from nos_tpu_torch.ops import attention as A

    workload_env.apply()
    dev = resolve_device(spec["device"])
    workload_env.validate_confinement(device=dev)
    cfg = demo_config(**spec.get("model", {}))
    request = build_model(dev, cfg, spec["batch"], spec["seq"])
    requests = 1
    scalars: list[float] = []
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if "go" in cmd:
            time.sleep(max(0.0, cmd["go"] - time.monotonic()))
            request()       # per-client warm dispatch
            latencies = []
            for _ in range(REQUESTS_PER_CLIENT):
                t0 = time.perf_counter()
                scalars.append(request())
                latencies.append(time.perf_counter() - t0)
            requests += 1 + REQUESTS_PER_CLIENT
            print(json.dumps({"latencies": latencies}), flush=True)
        elif cmd.get("stop"):
            out = {"requests": requests, "scalars": scalars,
                   "k1_launches": A.FLASH_FWD_LAUNCHES,
                   "tile_launches": {A.tile_name(*key): n for key, n
                                     in A.TILE_LAUNCHES.items()},
                   "logits": base64.b64encode(
                       request.last.float().cpu().numpy().tobytes()).decode(),
                   "logits_shape": list(request.last.shape)}
            fraction = workload_env.memory_fraction()
            if dev.type == "cuda" and fraction is not None:
                total = torch.cuda.get_device_properties(dev).total_memory
                out |= {
                    "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                    "cap_bytes": int(fraction * total)}
            print(json.dumps(out), flush=True)
            return


class Clients:
    """``n`` client processes, started at once; each under a timeshare
    grant of GRANT_GB on the card ``uuid`` (this process's device when
    None; on the CPU: no grant).  ``model``, ``batch`` and ``seq`` cut
    the request for tests."""

    def __init__(self, n: int, device: str | torch.device = "cuda",
                 uuid: str | None = None, model: dict | None = None,
                 batch: int = BATCH, seq: int = SEQ) -> None:
        dev = resolve_device(device)
        spec = json.dumps({"device": str(dev), "model": model or {},
                           "batch": batch, "seq": seq})
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("NOS_TPU_VISIBLE_CHIPS",
                                    "NOS_TPU_TIMESHARE_GB"))
               and k not in ("NOS_TPU_TORCH_MEM_FRACTION",
                             "CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")}
        if dev.type == "cuda":
            if uuid is None:
                from nos_tpu_torch.device.discovery import cuda_uuid

                uuid = cuda_uuid(torch.cuda.get_device_properties(dev))
            env |= {"NOS_TPU_VISIBLE_CHIPS": uuid,
                    "NOS_TPU_TIMESHARE_GB": str(GRANT_GB)}
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", spec],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for _ in range(n)]
        self._stderr: list[list[str]] = [[] for _ in self.procs]
        self._readers = [threading.Thread(
            target=lambda p=proc, out=lines: out.extend(p.stderr),
            daemon=True) for proc, lines in zip(self.procs, self._stderr)]
        for reader in self._readers:
            reader.start()
        try:
            for i in range(n):
                self._read(i)
        except BaseException:
            self.kill()
            raise

    def _failed(self, i: int) -> RuntimeError:
        self.procs[i].wait(timeout=WORKER_TIMEOUT_S)
        self._readers[i].join(timeout=10)
        return RuntimeError(f"client {i} exited {self.procs[i].returncode}:\n"
                            + "".join(self._stderr[i])[-4000:])

    def _read(self, i: int) -> dict:
        line = self.procs[i].stdout.readline()
        if not line:
            raise self._failed(i)
        return json.loads(line)

    def _send(self, i: int, cmd: dict) -> None:
        self.procs[i].stdin.write(json.dumps(cmd) + "\n")
        self.procs[i].stdin.flush()

    def run(self, n_clients: int) -> list[float]:
        """The first ``n_clients`` run one warm and REQUESTS_PER_CLIENT
        timed requests each from one instant; their latencies."""
        start = time.monotonic() + START_DELAY_S
        for i in range(n_clients):
            self._send(i, {"go": start})
        return [t for i in range(n_clients)
                for t in self._read(i)["latencies"]]

    def close(self) -> list[dict]:
        """Stop every client; their reports, in order.  Raises if a client
        exited non-zero or peaked at its cap."""
        reports = []
        for i in range(len(self.procs)):
            self._send(i, {"stop": True})
            reports.append(self._read(i))
        for i, proc in enumerate(self.procs):
            if proc.wait(timeout=WORKER_TIMEOUT_S) != 0:
                raise self._failed(i)
            r = reports[i]
            if "cap_bytes" in r and r["peak_reserved_bytes"] >= r["cap_bytes"]:
                raise RuntimeError(
                    f"client {i} peaked at {r['peak_reserved_bytes']} B "
                    f"reserved, at its cap {r['cap_bytes']} B")
        return reports

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def logits_of(report: dict) -> torch.Tensor:
    """A client's last logits [batch, vocab], fp32, from its report."""
    import numpy as np

    return torch.from_numpy(np.frombuffer(
        base64.b64decode(report["logits"]), dtype=np.float32).reshape(
            report["logits_shape"]).copy())


def run_timeshare(device: str | torch.device = "cuda",
                  uuid: str | None = None, **cut) -> tuple[list[dict],
                                                           list[dict]]:
    """Every row of CLIENT_COUNTS from one set of max(CLIENT_COUNTS)
    clients; (rows, the clients' reports)."""
    clients = Clients(max(CLIENT_COUNTS), device, uuid, **cut)
    try:
        rows = [row(n, clients.run(n)) for n in CLIENT_COUNTS]
        return rows, clients.close()
    finally:
        clients.kill()


_HAMMER = (
    "import time, torch\n"
    "from nos_tpu_torch.device import workload_env\n"
    "workload_env.apply()\n"
    "workload_env.validate_confinement()\n"
    "x = torch.ones((4096, 4096), dtype=torch.bfloat16, device='cuda')\n"
    "t0 = time.time()\n"
    "while time.time() - t0 < 60:\n"
    "    x = torch.matmul(x, x) / 4096\n"
    "    torch.cuda.synchronize()\n"
)


def _local_uuids(dev: torch.device) -> list[str]:
    """The UUIDs of this host's GPUs (none for a CPU ``dev``)."""
    from nos_tpu_torch.device.discovery import cuda_uuid

    if dev.type != "cuda":
        return []
    return [cuda_uuid(torch.cuda.get_device_properties(i))
            for i in range(torch.cuda.device_count())]


def run_isolated(device: str | torch.device = "cuda",
                 uuids: list[str] | None = None, hammer: str = _HAMMER,
                 **cut) -> dict:
    """The enforced-isolation row (the reference's flat MIG line): one
    client CONFINED to GPU 0 by its grant measures its latency while
    neighbour processes running ``hammer``, each confined to one of GPUs
    1-3, hammer theirs with matmuls.  Needs a host with two or more GPUs
    (``uuids``: this host's); on fewer it returns the skip line, as the
    JAX demo does.  ``cut`` cuts the client's request for tests."""
    dev = resolve_device(device)
    uuids = _local_uuids(dev) if uuids is None else uuids
    if len(uuids) < 2:
        return {"isolated_row": "skipped",
                "reason": f"needs >=2 local GPUs to run a confined workload "
                          f"beside hammering neighbors; host exposes "
                          f"{len(uuids)}"}
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")}
    env["PYTHONPATH"] = str(ROOT)
    hammers = [subprocess.Popen(
        [sys.executable, "-c", hammer],
        env=env | {"NOS_TPU_VISIBLE_CHIPS": u}, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for u in uuids[1:4]]
    try:
        clients = Clients(1, dev, uuids[0], **cut)
        try:
            lats = clients.run(1)
            clients.close()
        finally:
            clients.kill()
    finally:
        for h in hammers:
            h.kill()
            h.wait()
    return {"isolated_mean_s": round(statistics.mean(lats), 4),
            "isolated_max_s": round(max(lats), 4),
            "neighbours": len(hammers)}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(json.loads(args.worker))
        return
    dev = resolve_device(args.device)
    rows, _ = run_timeshare(dev)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(summary(rows, card_line(dev))), flush=True)
    print(json.dumps(run_isolated(dev)), flush=True)


if __name__ == "__main__":
    main()
