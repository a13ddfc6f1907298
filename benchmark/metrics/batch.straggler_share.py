"""Share of a batch's subject-iterations spent frozen, waiting for the
cohort's slowest subject: 1 - sum n_iter / (B x the iterations the stacked
chunk ran, its slowest subject's), over the window's cohorts of B > 1."""


def read(record):
    units = [u for u in record["units"] if u["B"] > 1]
    if not units:
        return None
    slots = sum(u["B"] * max(u["n_iter"]) for u in units)
    return 1.0 - sum(sum(u["n_iter"]) for u in units) / slots if slots else None
