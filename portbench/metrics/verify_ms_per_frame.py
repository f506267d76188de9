"""Host milliseconds a matched frame spends in verification: the stage
``match.verify`` (``warp_similarity`` of the rated candidates, K6, and the
final pick), summed over the clients, before the profile, over the frames
matched."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.verify",))
