"""frames_per_s: the frames whose maps and stats reached the host in the
window, over the window's seconds (from its opening to the return of the
last call that started in it)."""


def read(run):
    if run.frames <= 0 or run.window_s <= 0:
        return None
    return run.frames / run.window_s
