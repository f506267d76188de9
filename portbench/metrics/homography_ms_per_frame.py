"""Host milliseconds a matched frame spends from the float table to the
rated candidates: the stages ``sift.lowe`` (Lowe's ratio per slide, the
candidates and the gathers of their matches), ``sift.draws`` (the frame's
seeded draws) and ``sift.homography`` (the 4-point homography RANSAC and
the rating cascade), summed over the clients, before the profile, over the
frames matched (``sift.features`` spans)."""

from portbench.metrics._sift_spans import ms_per_frame

UNIT = "ms"


def read(run):
    return ms_per_frame(run, ("sift.homography", "sift.lowe", "sift.draws"))
