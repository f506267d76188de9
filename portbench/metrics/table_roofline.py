"""Share of its roofline that the exact table's kernel (K5 (a),
``match_table_kernel`` in ``csrc/table.cu``) reaches in the traced window:
the least time of each call at its query count, listed slides and slots
(``peaks.table_bound``), summed, over the kernel's device time. Nothing to
read when the profile's launches and the logged calls differ in number, or
there are none."""

import re

from portbench.lib.peaks import table_bound

UNIT = "%"
_KERNEL = re.compile(r"(^|[^A-Za-z0-9_])match_table_kernel\b")


def read(run):
    bound_ms = time_ms = 0.0
    for shapes, launches, seconds in run.kernel_calls(_KERNEL):
        calls = [s for s in shapes if s[0] == "table"]
        if launches != len(calls):
            return None
        bound_ms += sum(table_bound(q, n_cols, k)["bound_ms"] for _, q, n_cols, k in calls)
        time_ms += seconds * 1e3
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None
