"""reply_ms_p95: the 95th percentile of the same times as
``reply_ms_p50``."""

from portbench.record import percentile


def read(run):
    return percentile(run.reply_ms, 95)
