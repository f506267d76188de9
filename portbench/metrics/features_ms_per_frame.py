"""Host milliseconds a matched frame spends in the ORB matcher's features:
the stages ``match.detect`` (pyramid, FAST, detect) and ``match.describe``
(describe at the query bucket, the verification thumbnail), summed over
the clients, before the profile, over the frames matched."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.detect", "match.describe"))
