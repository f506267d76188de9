"""Host milliseconds a matched frame spends in stage-1 screening: the stage
``match.screen`` (every frame's ``screen_queries`` and one
``screen_slides_batched`` a batch, K5 (b)), summed over the clients,
before the profile, over the frames matched; None on a deck the exact
table serves, which records no such stage."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.screen",))
