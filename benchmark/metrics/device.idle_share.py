"""Share of the profiled fit chunk's wall time in which no operation ran on
the device (the second chunk of the window's first fit, after its capture,
its launch and its one read of the host)."""


def read(record):
    p = record["profile"]
    if not p or not p["busy_s"] or not p["window_s"]:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
