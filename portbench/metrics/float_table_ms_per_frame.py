"""Host milliseconds a matched frame spends in the SIFT engine's float
table: the stage ``sift.table`` (``hamming.match_table_float``: 2,048
queries against every slide's 2,048 slots in float32, nearest and second
nearest a slide; stage-1 screening first above the screening limit),
summed over the clients, before the profile, over the frames matched
(``sift.features`` spans)."""

from portbench.metrics._sift_spans import ms_per_frame

UNIT = "ms"


def read(run):
    return ms_per_frame(run, ("sift.table",))
