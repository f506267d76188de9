"""The window's arithmetic: frames decided pro rata, device intervals."""

import pytest

from portbench.lib import window


def test_batch_straddling_each_end_counts_its_share():
    # Checkpoints of one client: 64 frames decided at t = 2, 4, 6, 8.
    points = [(0.0, 0), (2.0, 64), (4.0, 128), (6.0, 192), (8.0, 256)]
    # Window [1, 7]: half of the first batch, two whole, half of the last.
    assert window.decided_in(points, 1.0, 7.0) == pytest.approx(32 + 128 + 32)
    # A window inside one batch counts the share of that batch.
    assert window.decided_in(points, 4.5, 5.0) == pytest.approx(16)


@pytest.mark.parametrize("start, end, want", [
    (0.0, 8.0, 256), (-5.0, 20.0, 256), (8.0, 12.0, 0), (3.0, 3.0, 0), (6.0, 9.0, 64),
])
def test_decided_in_is_flat_outside_the_checkpoints(start, end, want):
    points = [(0.0, 0), (2.0, 64), (4.0, 128), (6.0, 192), (8.0, 256)]
    assert window.decided_in(points, start, end) == pytest.approx(want)


def test_uneven_batches_and_a_repeated_checkpoint():
    points = [(10.0, 0), (11.5, 64), (11.5, 64), (14.0, 128)]
    assert window.decided_in(points, 10.75, 12.75) == pytest.approx(32 + 32)
    assert window.decided_at([], 3.0) == 0.0


def test_union_and_gaps_of_device_intervals():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert window.union_length(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert window.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.0)]
    assert window.union_length(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert window.gaps([], 2.0, 3.0) == [(2.0, 3.0)]
