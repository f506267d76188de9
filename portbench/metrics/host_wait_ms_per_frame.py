"""Host milliseconds a sampled frame spends waiting on reads of device
results: the stages ``sync.upload`` (the pageable frame upload),
``sync.verdict`` (the dedup verdicts), ``sync.count`` (each matched
frame's valid keypoint count), ``sync.pick`` (three a matched frame: the
winner's similarity, slide and rating, indexed by a device scalar),
``sync.first`` (a run's first similarity, written from the host) and
``match.fetch`` (the decided slides),
summed over the clients, before the profile, over the frames sampled
(``dedup`` spans x batch), as ``dedup_ms_per_frame`` counts them."""

from portbench.metrics._spans import host_reads

UNIT = "ms"


def read(run):
    got = host_reads(run)
    return None if got is None else got[0] * 1e3 / got[2]
