"""Device busy milliseconds of the profiled fit chunk per subject-iteration
it ran (a batch's chunk runs B subjects' iterations at once)."""


def read(record):
    p = record["profile"]
    if not p or not p["busy_s"] or not p["iters"]:
        return None
    return 1e3 * p["busy_s"] / p["iters"]
