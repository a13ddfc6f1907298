"""Launches of the rigid Gauss-Newton statistics' kernel per subject-iteration
of the fit, from the program's own counts (``unires_torch.utils.trace``):
each ``fit`` span's ``gn_stats`` (the device launch counter of
``ops.gn_stats.gn_moments`` over the fit: two launches a call, the partial
sums and their reduction, one call per observation in each rigid round; 0
where the plain chain ran) over the window's iterations (each subject's
``n_iter``). A program whose ``fit`` spans carry no such count has nothing
to read.

A check that the fit's rigid round takes the kernel, not a number to push:
0 means the plain chain ran. Declared ``lower`` because fewer launches
doing the same work (a fused pass, rarer rounds) is the way it should move
once it is above 0."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    fits = [f for _, below in units for f in below["fit"]]
    if not fits or any("gn_stats" not in f.attrs for f in fits):
        return None
    launches = sum(f.attrs["gn_stats"] for f in fits)
    iters = sum(sum(u["n_iter"]) for u in record["units"])
    return launches / iters if iters else None
