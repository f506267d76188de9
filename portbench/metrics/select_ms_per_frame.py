"""Host milliseconds a matched frame spends in the ratio filter: the stage
``match.select`` (``select_candidates_table`` and the gathers of the
candidates' points), summed over the clients, before the profile, over
the frames matched."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.select",))
