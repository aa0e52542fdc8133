"""serve.coalesce_fill: frames folded into a coalesced dispatch on mean
(``coalesce_mean_fill`` of the daemon's ``metrics`` reply)."""


def read(run):
    fill = (run.server or {}).get("coalesce_mean_fill")
    return float(fill) if fill else None
