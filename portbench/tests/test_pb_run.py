"""A whole run of the harness on the CPU at a tiny size: clients started
as processes, released into one window, their answers compared with the
reference. The card check is skipped (``run_cell`` is called with the
CPU); the rest runs as on the card. A sound run is correct; a run whose
engine is broken underneath is not, for each fault the cells can have, in
filmed traffic and in screen-recorded traffic, where the dedup drops most
samples and the sample compared covers every frame of the window.
"""

import pytest

from portbench import run as harness
from portbench.lib import check, spec


CELLS = ["orb500-filmed-x4", "orb64-screencap-x4"]


def tiny_cell(name: str = "orb500-filmed-x4") -> dict:
    """The cell at a tiny size: 2 pages (x 5 reveals on a reveal deck) of
    240 x 320 (screened above 4 slides), 256 keypoints over 4 levels,
    batches of 4, one client; a cell whose dedup drops most samples compares
    as many frames as the pool holds."""
    cell = spec.cell(name)
    conf = cell["config"]
    conf["deck"].update(height=240, width=320, pages=2)
    conf["orb"].update(n_features=200, max_keypoints=256, query_buckets=[128], edge_threshold=16,
                       n_levels=4)
    conf["match"].update(screen_above_slides=4, screen_slides=4, screen_queries=64,
                         max_matches_per_slide=64, ransac_iters=500)
    conf["video"].update(batch_size=4, small_image_area=120 * 160)
    cell["traffic"].update(pool=24, period=12)
    cell.update(clients=1, check_frames=24 if cell["traffic"].get("hold") else 4)
    return cell


def _run(cell_name, fault=None):
    return harness.run_cell(tiny_cell(cell_name), seed=2**31 + 77, seconds=1.0, trace=False, device="cpu",
                            fault=fault)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    res = _run(cell_name)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", ["alter_answer", "half_batch", "stale"])
def test_a_broken_engine_is_not_correct(cell_name, fault):
    res = _run(cell_name, fault)
    assert not res["correct"], res["checks"]
    widest = [res["checks"][name] for name in check.WIDEST if name in res["checks"]]
    assert widest and all(c["value"] > c["limit"] for c in widest), res["checks"]
