"""Readers of the per-layer metrics, one module a metric, found by name:
each has ``UNIT`` and ``read(run)``, which returns the metric's value or
None when the run holds nothing to read it from.

A reader that needs the shapes of a kernel's calls declares ``LOGS``, a
tuple of (module, function, describe) triples: in a traced run the client
wraps ``module.function`` while its profile runs, and appends
``describe(*args, **kwargs)`` of each call, a tuple whose first item names
its kind, unless None, to the log that ``Run.kernel_calls`` hands back."""
