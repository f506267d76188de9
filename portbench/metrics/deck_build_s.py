"""Seconds the engine takes to build the deck's index from the page arrays
(``MatchingEngine`` with ``page_grays``: ``LAST_BUILD_BREAKDOWN["extract_s"]``,
pyramid, FAST, describe and thumbnails of every page), the median over the
clients, which build side by side."""

import statistics

UNIT = "s"


def read(run):
    values = [r["extract_s"] for r in run.ready if "extract_s" in r]
    return statistics.median(values) if values else None
