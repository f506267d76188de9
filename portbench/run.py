"""Run one cell of the benchmark of ``slideo_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
(``portbench/workloads/<cell>.json``) names a configuration, a traffic mix
and a number of clients: lecture jobs, each one process running its own
``MatchingEngine`` on ``cuda:0``. The harness builds the port's kernels
once, starts the clients, releases them into the window together once each
is warm, and measures for ``--seconds`` seconds:

- ``frames_per_s``: sampled frames decided in the window, summed over the
  clients, over its length; a batch that straddles either end counts the
  share of its frames that falls inside (``lib/window.py``);
- ``setup_s``: from this process's start until every client is warm and
  waiting at the window's start.

With ``--trace 1`` it prints the per-layer metrics instead, each read by
its module in ``portbench/metrics/``. Once the clients have ended, the
configuration's plain reference (``portbench/references/``) answers a
sample of the frames decided in the window, drawn from the seed, and
``correct`` says whether the program's answers agree within the cell's
limits. The last line of
standard output is the result.

``--clients n`` runs another number of clients than the cell's, for a
sweep of the client count; a result so made is not the cell's.
"""

from __future__ import annotations

import time

T_RUN = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import proto, spec, window  # noqa: E402
from portbench.lib.run_data import Run  # noqa: E402

WARM_BATCHES = 2        # batches each client runs before the window
PROFILE_AT = 0.2        # a traced run's profile starts this far into the window
PROFILE_S = 15.0        # and covers at least this many seconds
GO_DELAY_S = 0.2        # from the last client's ready message to the window's start
CACHE = ROOT / ".portbench_cache"


class NoCard(Exception):
    pass


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def client_env() -> dict:
    """The clients' environment: one CPU thread a pool, as an operator who
    runs jobs side by side sets it, caches inside the checkout, and no JAX
    behind any library."""
    env = dict(os.environ)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        env[var] = "1"
    env.update(USE_FLAX="0", USE_JAX="0", USE_TF="0",
               TORCH_EXTENSIONS_DIR=str(CACHE / "torch_extensions"),
               TRITON_CACHE_DIR=str(CACHE / "triton"))
    return env


class Client:
    """One client process and the messages it sent."""

    def __init__(self, spec_: dict, env: dict):
        self.proc = subprocess.Popen([sys.executable, str(ROOT / "portbench" / "client.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, cwd=ROOT)
        self.messages: list = []
        self.cond = threading.Condition()
        self.proc.stdin.write((json.dumps(spec_) + "\n").encode())
        self.proc.stdin.flush()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        while True:
            try:
                msg = proto.recv(self.proc.stdout)
            except EOFError:
                msg = None
            with self.cond:
                self.messages.append(msg if msg is not None else ("closed", None))
                self.cond.notify_all()
            if msg is None or msg[0] in ("report", "error"):
                return

    def wait(self, kind: str, deadline: float):
        with self.cond:
            while True:
                for m in self.messages:
                    if m[0] == kind:
                        return m[1]
                    if m[0] in ("error", "closed"):
                        raise RuntimeError(f"client {self.proc.pid} ended: {m[1]}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"client {self.proc.pid}: no {kind!r} message in time")
                self.cond.wait(min(left, 1.0))

    def send(self, msg: dict) -> None:
        self.proc.stdin.write((json.dumps(msg) + "\n").encode())
        self.proc.stdin.flush()

    def stop(self, timeout: float) -> None:
        """Wait for the process to end, killing it after ``timeout``."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)


def run_clients(cell: dict, seed: int, seconds: float, trace: bool, device: str,
                clients: int, fault: str | None = None, prepare=None) -> Run:
    """Start the cell's clients, release them into one window, collect
    their reports; every client process has ended on return. The clients
    import and make their traffic while ``prepare()`` (the kernels' build)
    runs here; they touch the port's kernels only after it returned."""
    env = client_env()
    procs: list[Client] = []
    done = False
    try:
        for c in range(clients):
            procs.append(Client(dict(cell=cell, seed=seed, client=c, seconds=seconds, trace=trace,
                                     device=device, warm_batches=WARM_BATCHES, profile_at=PROFILE_AT,
                                     profile_s=PROFILE_S, fault=fault), env))
        if prepare is not None:
            prepare()
        for p in procs:
            p.send({"kernels": "ready"})
        deadline = time.monotonic() + 900
        ready = [p.wait("ready", deadline) for p in procs]
        t_start = time.monotonic() + GO_DELAY_S
        for p in procs:
            p.send({"t_start": t_start})
        deadline = t_start + seconds + 600
        reports = [p.wait("report", deadline) for p in procs]
        done = True
    finally:
        for p in procs:
            p.stop(timeout=120 if done else 0)
    return Run(cell=cell, seed=seed, seconds=seconds, t_start=t_start, t_run=T_RUN,
               ready=ready, reports=reports)


def end_to_end(run: Run) -> dict:
    decided = sum(window.decided_in(r["points"], run.t_start, run.t_end) for r in run.reports)
    return {
        "frames_per_s": {"value": decided / run.seconds, "unit": "frames/s"},
        "setup_s": {"value": run.t_start - run.t_run, "unit": "s"},
    }


def per_layer(run: Run) -> dict:
    out = {}
    for name in spec.metric_names():
        mod = spec.metric_module(name)
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def result(run: Run, verdict: dict, trace: bool, chips: int) -> dict:
    device = {"platform": "gpu" if run.ready[0]["device"] != "cpu" else "cpu",
              "kind": run.ready[0]["device"], "count": chips,
              "memory_peak_bytes": max(r["mem_used"] for r in run.reports)}
    res = {"correct": verdict["correct"],
           "attempted": sum(len(r["rows"]) for r in run.reports),
           "failed": verdict["failed"],
           "metrics": per_layer(run) if trace else end_to_end(run),
           "device": device}
    if trace:
        busy = run.device_busy()
        if busy is not None:
            device.update(busy_s=busy[0], window_s=busy[1])
        res["breakdown"] = run.breakdown()
    res["checks"] = verdict["checks"]
    return res


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda:0",
             clients: int | None = None, fault: str | None = None, prepare=None) -> dict:
    """One run of ``cell`` (a dict from ``spec.cell``): the result line's
    object, with the comparison's numbers under ``checks``."""
    run = run_clients(cell, seed, seconds, trace, device, clients or cell["clients"], fault, prepare)
    for c, (r, rep) in enumerate(zip(run.ready, run.reports)):
        log(f"client {c}: started {r['t_process'] - T_RUN:.3f} s into the run, imports "
            f"{r['imported_s']:.3f} s; traffic made in {r['traffic_s']:.3f} s (deck {r['deck_s']:.3f}, "
            f"pool {r['pool_s']:.3f}); waited {r['kernels_wait_s']:.3f} s for the kernels; "
            f"index {r['index_s']:.3f} s (extract_s {r['extract_s']:.4f}), "
            f"warm batches {r['warm_s']:.3f} s; decided {len(rep['rows'])} frames")
    from portbench.lib import check     # imports torch: after the clients started

    found = sorted({m for rep in run.reports for m in rep["forbidden"]} | set(check.forbidden_modules()))
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    verdict = check.compare(run, device)
    found = check.forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    e2e = end_to_end(run)
    log(f"frames_per_s {e2e['frames_per_s']['value']:.4f}, setup_s {e2e['setup_s']['value']:.4f}, "
        f"clients {len(run.reports)}")
    return result(run, verdict, trace, 1 if device.startswith("cuda") else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--clients", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    chips = cell["chips"]

    def prepare():
        """Refuse without the cell's cards; build the kernels, once."""
        t0 = time.monotonic()
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"no CUDA card to run on (cell {args.workload} needs {chips})")
        import slideo_tpu_torch._kernels as kernels

        t1 = time.monotonic()
        kernels.library()
        log(f"torch imported in {t1 - t0:.3f} s, kernels ready in {time.monotonic() - t1:.3f} s")

    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), clients=args.clients,
                       prepare=prepare)
    except NoCard as e:
        log(f"{e}; no result")
        return 2
    except (RuntimeError, TimeoutError) as e:
        log(f"run failed: {e}")
        return 1
    res["device"]["count"] = chips
    for name, c in res.get("checks", {}).items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
