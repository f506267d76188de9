"""Host milliseconds a matched frame spends in the engine's ``match.dispatch``
and ``match.fetch`` stages (``MatchingEngine.match_batch``: features,
stage-1 screening, the exact table and the verification cascade, then the
read of the decided slides), summed over the clients: their spans in the
window before the profile, over the frames of those batches."""

UNIT = "ms"


def read(run):
    got = run.stage_seconds(("match.dispatch", "match.fetch"))
    if not got or not got[1]:
        return None
    seconds, batches = got
    return seconds * 1e3 / (batches * run.reports[0]["batch"])
