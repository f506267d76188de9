"""Share of its roofline that the exact table's kernel (K5 (a),
``match_table_kernel`` in ``csrc/table.cu``) reaches in the traced window:
the least time of each call at its query count, listed slides and slots
(``peaks.table_bound``), summed, over the kernel's device time. The calls
are logged at ``hamming.match_table_scores`` (``LOGS``). Nothing to read
when the profile's launches and the logged calls differ in number, or there
are none."""

import re

from portbench.lib.peaks import table_bound

UNIT = "%"
_KERNEL = re.compile(r"(^|[^A-Za-z0-9_])match_table_kernel\b")


def describe(query, desc, valid, n_slides, k_per_slide, slide_ids=None, n_slots=None):
    """("table", queries, columns, slots) of one call."""
    return ("table", query.shape[0], n_slides if slide_ids is None else slide_ids.shape[0],
            k_per_slide if n_slots is None else n_slots)


LOGS = (("slideo_tpu_torch.ops.hamming", "match_table_scores", describe),)


def read(run):
    bound_ms = time_ms = 0.0
    for shapes, launches, seconds in run.kernel_calls(_KERNEL):
        calls = [s for s in shapes if s[0] == "table"]
        if launches != len(calls):
            return None
        bound_ms += sum(table_bound(q, n_cols, k)["bound_ms"] for _, q, n_cols, k in calls)
        time_ms += seconds * 1e3
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None
