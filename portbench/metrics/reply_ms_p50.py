"""reply_ms_p50: the median, over every request due in the window, of the
time from the moment it was due to its full reply at the client."""

from portbench.record import percentile


def read(run):
    return percentile(run.reply_ms, 50)
