"""device.idle_share.served: the same share as ``device.idle_share``, in
the serving daemon's process, which launches the kernels."""


def read(run):
    if not run.traced or not run.notes.get("served_trace"):
        return None
    return 100.0 * (1.0 - run.busy_s() / run.trace_window_s())
