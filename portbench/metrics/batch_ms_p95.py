"""batch_ms_p95: the 95th percentile, over every call of the window, of
the host time from the ``process_batch`` call to its return."""

from portbench.record import percentile


def read(run):
    return percentile(run.batch_ms, 95)
