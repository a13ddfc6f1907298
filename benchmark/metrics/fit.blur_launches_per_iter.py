"""Launches of the slice-profile blur's passes per subject-iteration of the
fit, from the program's own counts (``unires_torch.utils.trace``): each
``fit`` span's ``blurs`` (the device launch counters of ``ops.conv``'s
down and up passes over the fit: one launch a pass, none for a dirac axis;
0 where the plain chain ran) over the window's iterations (each subject's
``n_iter``). A program whose ``fit`` spans carry no such count has nothing
to read.

A check that the super-resolution fit takes the kernels, not a number to
push: 0 means the plain chain ran (a denoising fit has no blur). Declared
``lower`` because fewer launches doing the same work (passes fused, fewer
CG steps) is the way it should move once it is above 0."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    fits = [f for _, below in units for f in below["fit"]]
    if not fits or any("blurs" not in f.attrs for f in fits):
        return None
    launches = sum(f.attrs["blurs"] for f in fits)
    iters = sum(sum(u["n_iter"]) for u in record["units"])
    return launches / iters if iters else None
