"""Host milliseconds a matched frame spends describing its SIFT keypoints:
the stage ``sift.describe`` of each octave (the 63 x 63 patches, the
36-bin orientation histogram, the 4x4x8 descriptors), summed over the
clients, before the profile, over the frames matched (``sift.features``
spans)."""

from portbench.metrics._sift_spans import ms_per_frame

UNIT = "ms"


def read(run):
    return ms_per_frame(run, ("sift.describe",))
