"""setup_s: seconds from the start of the run's process to the opening of
the window: imports, the frame pool, the kernels' load (their build in a
checkout's first run), the engine or the daemon, and the warm-up."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
