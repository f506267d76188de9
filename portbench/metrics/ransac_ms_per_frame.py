"""Host milliseconds a matched frame spends in RANSAC and the rating: the
stages ``match.draws`` (the frame's seeded uniform draws) and
``match.ransac`` (``ransac_similarity``, the rating top-k and retain),
summed over the clients, before the profile, over the frames matched."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.ransac", "match.draws"))
