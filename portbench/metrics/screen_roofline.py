"""Share of its roofline that stage-1 screening's single-stage kernel (K5 (b),
``screen_kernel`` in ``csrc/screen.cu``) reaches in the traced window: the
least time of each call at its shapes (``peaks.screen_bound``: R query rows
against every slot of every slide), summed, over the kernel's device time.
The calls are logged at ``hamming.screen_scores`` (``LOGS``); only those of
the single stage count. Nothing to read when the profile's launches and the
logged calls differ in number, or there are none."""

import re

from portbench.lib.peaks import screen_bound

UNIT = "%"
_KERNEL = re.compile(r"(^|[^A-Za-z0-9_])screen_kernel\b")


def describe(query, desc, valid, n_slides, k_per_slide, stride=1, slide_ids=None, n_slots=None):
    """("screen", rows, slides, slots, bits) of a call of the single stage
    (every slot of every slide), "screen_other" for the other forms."""
    single = stride == 1 and slide_ids is None and n_slots in (None, k_per_slide)
    return ("screen" if single else "screen_other", query.shape[0], n_slides, k_per_slide, query.shape[1])


LOGS = (("slideo_tpu_torch.ops.hamming", "screen_scores", describe),)


def read(run):
    bound_ms = time_ms = 0.0
    for shapes, launches, seconds in run.kernel_calls(_KERNEL):
        calls = [s for s in shapes if s[0] == "screen"]
        if launches != len(calls):
            return None
        bound_ms += sum(screen_bound(r, n, k, n, bits)["bound_ms"] for _, r, n, k, bits in calls)
        time_ms += seconds * 1e3
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None
