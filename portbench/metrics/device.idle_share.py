"""device.idle_share: the share of the traced stretch in which no kernel
and no copy ran on the device, in the benchmark's own process: 1 - (the
union of the device's intervals) / (the stretch), in %."""


def read(run):
    if not run.traced or run.notes.get("served_trace"):
        return None
    return 100.0 * (1.0 - run.busy_s() / run.trace_window_s())
