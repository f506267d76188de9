"""One client of a cell: one lecture job, as ``python -m slideo_tpu_torch``
runs it after decoding, in a process of its own.

Started by ``run.py`` with its spec as one JSON line on stdin. It makes the
deck and its own pool of sampled frames on the device from the seed, builds
the engine's index (``MatchingEngine(page_grays=...)``), runs warm batches,
reports ready, waits for the window's start time, then hands its samples to
``MatchingEngine.match_samples`` as fast as the engine takes them, until
the first batch decided after the window's end. It reports the engine's
checkpoint times, the decided frames, and in a traced run the engine's
stage spans and the device trace of part of the window.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Keys of a configuration file that describe it and set nothing of the engine.
DESCRIPTIVE = ("name", "source", "deployment", "deck", "assumed", "reduced", "reference")


def build_config(conf: dict):
    """The port's ``SlideoConfig`` from a configuration file: each section
    (``orb``, ``sift``, ``match``, ``video``) builds the field of that name
    (a list becomes a tuple), ``engine`` names the engine; a field the file
    leaves out keeps its default. A top-level key that is neither such a
    field nor one of ``DESCRIPTIVE``, or a key that its section lacks,
    raises ValueError: the engine would run without it."""
    import dataclasses

    from slideo_tpu_torch.config import SlideoConfig

    default = SlideoConfig()
    fields = {f.name for f in dataclasses.fields(SlideoConfig)}
    kwargs = {}
    for key, value in conf.items():
        if key in DESCRIPTIVE:
            continue
        if key not in fields:
            raise ValueError(f"configuration {conf.get('name')!r}: unknown key {key!r}")
        section = getattr(default, key)
        if dataclasses.is_dataclass(section):
            known = {f.name for f in dataclasses.fields(section)}
            for k in value:
                if k not in known:
                    raise ValueError(f"configuration {conf.get('name')!r}: section {key!r} has no key {k!r}")
            value = type(section)(**{k: tuple(v) if isinstance(v, list) else v for k, v in value.items()})
        kwargs[key] = value
    return SlideoConfig(**kwargs)


class _Tracer:
    """The engine's ``StageTracer`` that also keeps each span (name, start,
    end) on the monotonic clock, which every process shares."""

    def __init__(self):
        import contextlib

        from slideo_tpu_torch.utils.trace import StageTracer

        self.inner = StageTracer()
        self.spans: list[tuple[str, float, float]] = []
        self._contextlib = contextlib

    def stage(self, name: str):
        @self._contextlib.contextmanager
        def span():
            t0 = time.monotonic()
            with self.inner.stage(name):
                yield
            self.spans.append((name, t0, time.monotonic()))
        return span()


def _call_logger(log: list, active):
    """Wrap each function that the per-layer metrics of ``portbench/metrics/``
    declare in their ``LOGS`` so that, while ``active()``, each call appends
    to ``log`` what each of the function's ``describe`` returns for the
    call's arguments, unless None; returns a function that unwraps them."""
    import importlib

    from portbench.lib import spec

    targets: dict[tuple[str, str], list] = {}
    for name in spec.metric_names():
        for module, func, describe in getattr(spec.metric_module(name), "LOGS", ()):
            describers = targets.setdefault((module, func), [])
            if describe not in describers:
                describers.append(describe)

    def logged(fn, describers):
        def call(*args, **kwargs):
            if active():
                for describe in describers:
                    entry = describe(*args, **kwargs)
                    if entry is not None:
                        log.append(entry)
            return fn(*args, **kwargs)
        return call

    wrapped = []
    for (module, func), describers in targets.items():
        mod = importlib.import_module(module)
        wrapped.append((mod, func, getattr(mod, func)))
        setattr(mod, func, logged(getattr(mod, func), describers))

    def unwrap():
        for mod, func, fn in reversed(wrapped):
            setattr(mod, func, fn)
    return unwrap


def _device_events(prof, mark: float) -> dict:
    """The device operations of a profile as (names, name index, start,
    end) on the monotonic clock, placed by the spin kernel launched right
    after ``mark`` (the monotonic time just before its launch)."""
    import numpy as np
    from torch.autograd import DeviceType

    raw = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() * 1e-9 if hasattr(e, "start_ns") else e.start_us() * 1e-6
            dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6
            raw.append((e.name(), start, start + dur))
    except AttributeError:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                raw.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    spins = [s for n, s, _ in raw if "spin_kernel" in n]
    if not spins:
        return {}
    offset = mark - min(spins)
    names = sorted({n for n, _, _ in raw})
    index = {n: i for i, n in enumerate(names)}
    return dict(
        names=names,
        name_idx=np.array([index[n] for n, _, _ in raw], np.int32),
        start=np.array([s for _, s, _ in raw], np.float64) + offset,
        end=np.array([e for _, _, e in raw], np.float64) + offset,
    )


def run(spec: dict, out) -> None:
    from portbench.lib import check, pages, proto
    from portbench.lib.traffic import FilmedStream

    import torch

    torch.set_num_threads(1)
    from slideo_tpu_torch.app import pipeline

    cell, seed, client = spec["cell"], spec["seed"], spec["client"]
    conf, mix = cell["config"], cell["traffic"]
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    cfg = build_config(conf)
    t_imported = time.monotonic()

    deck = pages.make_deck(conf["deck"], seed, dev)
    t_deck = time.monotonic()
    stream = FilmedStream(mix, cell["dwell"], conf["deck"], seed, client)
    pool, pool_sums = stream.make_pool(deck)
    t_pool = time.monotonic()
    deck_sums = pages.checksums(deck)
    deck_np = deck.cpu().numpy()
    del deck
    t_traffic = time.monotonic()
    json.loads(sys.stdin.readline())      # the harness has built the kernels
    t_kernels = time.monotonic()

    page_objs = [pipeline.PdfPage(Path("deck.pdf"), "deck", Path(f"p-{i + 1}.png"), i + 1)
                 for i in range(len(deck_np))]
    engine = pipeline.MatchingEngine(cfg, page_objs, device=dev, page_grays=deck_np)
    extract_s = pipeline.LAST_BUILD_BREAKDOWN["extract_s"]
    del deck_np
    t_index = time.monotonic()
    # The engine's batch call, wrapped to keep its answers (and, in the harness's tests, to
    # break it underneath); wrapped before the warm batches, so a fault is in place from
    # the window's first batch.
    fault = spec.get("fault")
    captured: list = []
    orig = engine.match_batch
    last = {}

    def match_batch(frames, frame_seeds):
        if fault == "half_batch":
            half = max(1, len(frame_seeds) // 2)
            res = orig(frames[:half], frame_seeds[:half])
            res = type(res)(*(torch.cat([f, f])[:len(frame_seeds)] for f in res))
        else:
            res = orig(frames, frame_seeds)
        if fault == "alter_answer":
            res = res._replace(slide=torch.where(res.slide >= 0, (res.slide + 1) % len(page_objs), 0))
        if fault == "stale" and last:
            res = last["res"]
        last["res"] = res
        captured.append((list(frame_seeds), res))
        return res

    engine.match_batch = match_batch

    bs, interval = cfg.video.batch_size, cfg.video.interval_s
    warm = spec["warm_batches"] * bs
    engine.match_samples(((k, k * interval, pool[k % len(pool)]) for k in range(warm)),
                         total_ms=10**9, total_frames=10**9)
    if cuda:
        torch.cuda.synchronize(dev)
    t_warm = time.monotonic()

    proto.send(out, ("ready", dict(
        t_process=T_PROCESS, imported_s=t_imported - T_PROCESS, traffic_s=t_traffic - t_imported,
        deck_s=t_deck - t_imported, pool_s=t_pool - t_deck, kernels_wait_s=t_kernels - t_traffic,
        index_s=t_index - t_kernels,
        warm_s=t_warm - t_index, extract_s=extract_s,
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
    )))
    go = json.loads(sys.stdin.readline())
    t_start = go["t_start"]
    t_end = t_start + spec["seconds"]
    first = warm
    points = [(t_start, 0)]
    rows: dict[int, int] = {}
    mem_used = 0
    trace = spec["trace"] and cuda
    tracer = _Tracer() if spec["trace"] else None
    shapes: list = []
    prof_state = dict(prof=None, start=None, stop=None, mark=None)
    unwrap = _call_logger(shapes, lambda: prof_state["start"] is not None and prof_state["stop"] is None) \
        if trace else None
    prof_from = t_start + spec["profile_at"] * spec["seconds"]

    def checkpoint(new_rows, frontier):
        nonlocal mem_used
        now = time.monotonic()
        points.append((now, frontier - first + 1))
        for frame_idx, _ms, _hash, page in new_rows:
            rows[frame_idx] = -1 if page is None else page
        if cuda and now < t_end:
            free, total = torch.cuda.mem_get_info(dev)
            mem_used = max(mem_used, total - free)
        if trace:
            _profile_step(now)

    def _profile_step(now: float) -> None:
        from torch.profiler import ProfilerActivity, profile

        if prof_state["prof"] is None and now >= prof_from:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            torch.cuda.synchronize(dev)
            prof_state["mark"] = time.monotonic()
            torch.cuda._sleep(20000)
            torch.cuda.synchronize(dev)
            prof_state.update(prof=prof, start=time.monotonic())
        elif prof_state["stop"] is None and prof_state["start"] is not None \
                and now >= prof_state["start"] + spec["profile_s"]:
            torch.cuda.synchronize(dev)
            prof_state["stop"] = time.monotonic()
            prof_state["prof"].stop()

    def samples():
        k = first
        while True:
            if (k - first) % bs == 0 and points[-1][0] >= t_end:
                return
            yield k, k * interval, pool[k % len(pool)]
            k += 1

    while time.monotonic() < t_start:
        time.sleep(min(0.005, max(0.0, t_start - time.monotonic())))
    kwargs = dict(total_ms=10**9, total_frames=10**9, checkpoint=checkpoint)
    if tracer is None:
        engine.match_samples(samples(), **kwargs)
    else:   # the loop of match_samples, with its stage tracer
        from slideo_tpu_torch.app.progress import null_reporter

        engine._match_records(samples(), 10**9, 10**9, null_reporter, checkpoint, None, 0, tracer)
    t_done = time.monotonic()
    if unwrap is not None:
        unwrap()
    if prof_state["prof"] is not None and prof_state["stop"] is None:
        torch.cuda.synchronize(dev)
        prof_state["stop"] = time.monotonic()
        prof_state["prof"].stop()

    answers = {}
    for frame_seeds, res in captured:
        for k, s, sim, r in zip(frame_seeds, res.slide.cpu().tolist(), res.similarity.cpu().tolist(),
                                res.rating.cpu().tolist()):
            answers[k] = (s, sim, r)
    report = dict(
        points=points, rows=rows, answers=answers, first=first, last=max(rows, default=first - 1),
        t_done=t_done, mem_used=mem_used,
        mem_reserved=torch.cuda.max_memory_reserved(dev) if cuda else 0,
        deck_sums=deck_sums, pool_sums=pool_sums, forbidden=check.forbidden_modules(),
    )
    if tracer is not None:
        report.update(spans=tracer.spans, stages=tracer.inner.as_dict(), batch=bs)
    if prof_state["prof"] is not None:
        report.update(profile=dict(start=prof_state["start"], stop=prof_state["stop"],
                                   events=_device_events(prof_state["prof"], prof_state["mark"]),
                                   shapes=shapes))
    proto.send(out, ("report", report))


def main() -> None:
    from portbench.lib import proto

    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                 # whatever else prints goes to stderr
    spec = json.loads(sys.stdin.readline())
    try:
        run(spec, out)
    except Exception as e:        # report, then fail: the harness waits for a message
        import traceback

        traceback.print_exc()
        proto.send(out, ("error", f"{type(e).__name__}: {e}"))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
