"""Kernel calls are logged by the metric that reads them: each roofline
reader declares in ``LOGS`` the function to wrap and what to log of a call,
and the client wraps the union of the declarations while its profile runs.
On CPU calls of the two ``hamming`` entry points the log holds the tuples
written out below (those the client logged before the readers declared
them), a wrapped call returns what the function returns, and the readers
read the same values from a hand-made run."""

import numpy as np
import pytest
import torch

from portbench import client
from portbench.lib import spec
from portbench.lib.peaks import screen_bound, table_bound
from portbench.lib.run_data import Run

S, K, D = 4, 16, 256


def _inputs():
    g = torch.Generator().manual_seed(5)
    desc = (torch.randint(0, 2, (S * K, D), generator=g) * 2 - 1).to(torch.int8)
    valid = torch.rand(S * K, generator=g) < 0.8
    query = (torch.randint(0, 2, (8, D), generator=g) * 2 - 1).to(torch.int8)
    return query, desc, valid


# (entry point, arguments after the index, keyword arguments, logged tuple)
CALLS = [
    ("match_table_scores", (S, K), {}, ("table", 8, S, K)),
    ("match_table_scores", (S, K, torch.tensor([2, 0], dtype=torch.int32)), {}, ("table", 8, 2, K)),
    ("match_table_scores", (S, K), {"n_slots": 8}, ("table", 8, S, 8)),
    ("screen_scores", (S, K), {}, ("screen", 8, S, K, 128)),
    ("screen_scores", (S, K), {"n_slots": K}, ("screen", 8, S, K, 128)),
    ("screen_scores", (S, K), {"stride": 4}, ("screen_other", 8, S, K, 128)),
    ("screen_scores", (S, K), {"n_slots": 8}, ("screen_other", 8, S, K, 128)),
    ("screen_scores", (S, K), {"slide_ids": torch.tensor([[0, 1], [3, 2]], dtype=torch.int32)},
     ("screen_other", 8, S, K, 128)),
]


@pytest.mark.parametrize("func, args, kwargs, want", CALLS, ids=lambda v: v if isinstance(v, str) else None)
def test_a_call_logs_what_the_client_logged(func, args, kwargs, want):
    from slideo_tpu_torch.ops import hamming

    query, desc, valid = _inputs()
    if func == "screen_scores":
        query = query[:, :128].contiguous()
    original = getattr(hamming, func)
    expect = original(query, desc, valid, *args, **kwargs)
    log: list = []
    unwrap = client._call_logger(log, lambda: True)
    try:
        assert getattr(hamming, func) is not original
        got = getattr(hamming, func)(query, desc, valid, *args, **kwargs)
    finally:
        unwrap()
    assert getattr(hamming, func) is original
    assert log == [want]
    for a, b in zip(got if isinstance(got, tuple) else (got,), expect if isinstance(expect, tuple) else (expect,)):
        assert torch.equal(a, b)


def test_nothing_is_logged_outside_the_profile():
    from slideo_tpu_torch.ops import hamming

    query, desc, valid = _inputs()
    log: list = []
    unwrap = client._call_logger(log, lambda: False)
    try:
        hamming.match_table_scores(query, desc, valid, S, K)
        hamming.screen_scores(query[:, :128].contiguous(), desc, valid, S, K)
    finally:
        unwrap()
    assert log == []


def test_the_declarations_are_the_two_rooflines():
    declared = {(m, f) for name in spec.metric_names()
                for m, f, _ in getattr(spec.metric_module(name), "LOGS", ())}
    assert declared == {("slideo_tpu_torch.ops.hamming", "match_table_scores"),
                        ("slideo_tpu_torch.ops.hamming", "screen_scores")}


NAMES = ["_anonymous_namespace_::match_table_kernel<signed char>", "void screen_kernel<4>(int)",
         "Memcpy HtoD (Pageable -> Device)"]


def _profile(calls, shapes):
    """A client's profile: ``calls`` (name index, seconds) laid end to end."""
    t, idx, start, end = 10.0, [], [], []
    for i, sec in calls:
        idx.append(i)
        start.append(t)
        end.append(t + sec)
        t += sec + 1e-3
    events = dict(names=NAMES, name_idx=np.array(idx, np.int32), start=np.array(start), end=np.array(end))
    return dict(start=10.0, stop=t, events=events, shapes=shapes)


def _run(extra_table_launch=False):
    table = [(0, 2e-4), (0, 1e-4)] + ([(0, 1e-4)] if extra_table_launch else [])
    reports = [dict(profile=_profile(table + [(1, 5e-3), (2, 1e-3)],
                                     [("table", 2048, 64, 2048), ("screen", 16384, 500, 2048, 128),
                                      ("table", 768, 16, 2048), ("screen_other", 8192, 500, 2048, 128)])),
               dict(profile=_profile([(0, 3e-4), (2, 1e-3)], [("table", 2048, 64, 2048)]))]
    return Run(cell={}, seed=1, seconds=1.0, t_start=0.0, t_run=0.0, ready=[], reports=reports)


def test_the_rooflines_read_the_logged_calls():
    run = _run()
    table_ms = 2 * table_bound(2048, 64, 2048)["bound_ms"] + table_bound(768, 16, 2048)["bound_ms"]
    assert spec.metric_module("table_roofline").read(run) == pytest.approx(100 * table_ms / 0.6)
    screen_ms = screen_bound(16384, 500, 2048, 500, 128)["bound_ms"]
    assert spec.metric_module("screen_roofline").read(run) == pytest.approx(100 * screen_ms / 5.0)


def test_a_roofline_reads_nothing_when_launches_and_calls_differ():
    assert spec.metric_module("table_roofline").read(_run(extra_table_launch=True)) is None
