"""Share of the traced window in which no operation of any client ran on
the card: the union of every client's device intervals, on one clock, over
the stretch in which all their profilers ran."""

UNIT = "%"


def read(run):
    busy = run.device_busy()
    if busy is None or busy[1] <= 0:
        return None
    return 100.0 * (1.0 - busy[0] / busy[1])
