"""What the readers of the matcher's and the engine's inner stages share:
the frames a stretch of spans covers. Each stage is read through
``Run.stage_seconds``, so only spans in the window before the profile
count, and a run whose program records none of a reader's stages gives
None."""

MATCHED = "match.describe"      # one span a matched frame
HOST_READS = ("sync.upload", "sync.verdict", "sync.count", "sync.pick", "sync.first", "match.fetch")


def ms_per_matched_frame(run, names: tuple[str, ...]):
    """Milliseconds in the stages ``names`` over the frames matched, or
    None without spans of ``names[0]`` or of ``match.describe``."""
    got, frames = run.stage_seconds(names), run.stage_seconds((MATCHED,))
    if not got or not got[1] or not frames or not frames[1]:
        return None
    return got[0] * 1e3 / frames[1]


def host_reads(run):
    """(seconds, spans) of the host's reads of device results, summed over
    ``HOST_READS``, and the frames sampled (``dedup`` spans x batch); None
    without ``sync.upload`` spans."""
    counts = [run.stage_seconds((name,)) for name in HOST_READS]
    dedup = run.stage_seconds(("dedup",))
    if not counts[0] or not counts[0][1] or not dedup or not dedup[1]:
        return None
    return (sum(s for s, _ in counts), sum(n for _, n in counts),
            dedup[1] * run.reports[0]["batch"])
