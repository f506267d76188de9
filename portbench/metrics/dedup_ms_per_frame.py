"""Host milliseconds a sampled frame spends in the engine's ``dedup`` stage
(the frame upload, the thumbnails and the comparison with the previous
frame, ``MatchingEngine._dedup``), summed over the clients: the stage's
spans in the window before the profile, over their frames."""

UNIT = "ms"


def read(run):
    got = run.stage_seconds(("dedup",))
    if not got or not got[1]:
        return None
    seconds, spans = got
    return seconds * 1e3 / (spans * run.reports[0]["batch"])
