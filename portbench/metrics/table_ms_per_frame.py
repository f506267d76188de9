"""Host milliseconds a matched frame spends in the exact table: the stage
``match.table`` (``match_table`` over a screened frame's candidates or
``match_table_frame``, K5 (a)), summed over the clients, before the
profile, over the frames matched."""

from portbench.metrics._spans import ms_per_matched_frame

UNIT = "ms"


def read(run):
    return ms_per_matched_frame(run, ("match.table",))
