"""Host milliseconds a matched frame spends verifying its rated candidates:
the stage ``sift.verify`` (K6h's projective warp of the frame thumbnail,
the similarities and the winner, with its three ``sync.pick`` reads),
summed over the clients, before the profile, over the frames matched
(``sift.features`` spans)."""

from portbench.metrics._sift_spans import ms_per_frame

UNIT = "ms"


def read(run):
    return ms_per_frame(run, ("sift.verify",))
