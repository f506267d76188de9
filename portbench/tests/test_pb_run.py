"""A whole run of the harness on the CPU at a tiny size: clients started
as processes, released into one window, their answers compared with the
reference. The card check is skipped (``run_cell`` is called with the
CPU); the rest runs as on the card. A sound run is correct; a run whose
engine is broken underneath is not, for each fault the cells can have."""

import pytest

from portbench import run as harness
from portbench.lib import spec


def tiny_cell(name: str = "orb500-filmed-x4") -> dict:
    """The cell at a tiny size: 2 pages x 5 reveals of 240 x 320 (screened
    above 4 slides), 256 keypoints over 4 levels, batches of 4, one client."""
    cell = spec.cell(name)
    conf = cell["config"]
    conf["deck"].update(height=240, width=320, pages=2)
    conf["orb"].update(n_features=200, max_keypoints=256, query_buckets=[128], edge_threshold=16,
                       n_levels=4)
    conf["match"].update(screen_above_slides=4, screen_slides=4, screen_queries=64,
                         max_matches_per_slide=64, ransac_iters=500)
    conf["video"].update(batch_size=4, small_image_area=120 * 160)
    cell["traffic"].update(pool=24, period=12)
    cell.update(clients=1, check_frames=4)
    return cell


def _run(fault=None):
    return harness.run_cell(tiny_cell(), seed=2**31 + 77, seconds=1.0, trace=False, device="cpu",
                            fault=fault)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["alter_answer", "half_batch", "stale"])
def test_a_broken_engine_is_not_correct(fault):
    res = _run(fault)
    assert not res["correct"], res["checks"]
    assert res["checks"]["answer_gap_max"]["value"] > res["checks"]["answer_gap_max"]["limit"]
