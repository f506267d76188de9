"""Host milliseconds a matched frame spends detecting SIFT keypoints: the
stage ``sift.detect`` of each octave (its image halved from the octave
before, four blurs, three DoG levels, extrema, offsets, the top-k of the
octave's quota), summed over the clients, before the profile, over the
frames matched (``sift.features`` spans)."""

from portbench.metrics._sift_spans import ms_per_frame

UNIT = "ms"


def read(run):
    return ms_per_frame(run, ("sift.detect",))
