"""Outer iterations to convergence, the mean over the window's subjects (the
length of each fit's objective trace)."""


def read(record):
    n = [k for u in record["units"] for k in u["n_iter"]]
    return sum(n) / len(n) if n else None
