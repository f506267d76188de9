"""Host reads of device results a sampled frame costs: the number of spans of
``sync.upload``, ``sync.verdict``, ``sync.count``, ``sync.pick``,
``sync.first`` and ``match.fetch`` (each one host sync),
summed over the clients, before the profile, over the frames sampled
(``dedup`` spans x batch)."""

from portbench.metrics._spans import host_reads

UNIT = "syncs"


def read(run):
    got = host_reads(run)
    return None if got is None else got[1] / got[2]
