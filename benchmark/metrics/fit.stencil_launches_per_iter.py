"""Launches of the finite-difference stencil kernels per subject-iteration of
the fit, from the program's own counts (``unires_torch.utils.trace``): each
``fit`` span's ``stencils`` (the device launch counters of
``ops.finite_diff``'s gradient, divergence and membrane kernels over the
fit; 0 where the plain chain ran) over the window's iterations (each
subject's ``n_iter``). A program whose ``fit`` spans carry no such count has
nothing to read.

A check that the fit takes the kernels, not a number to push: 0 means the
plain chain ran. Declared ``lower`` because fewer launches doing the same
work (a stencil fused into its neighbour, fewer CG steps) is the way it
should move once it is above 0."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    fits = [f for _, below in units for f in below["fit"]]
    if not fits or any("stencils" not in f.attrs for f in fits):
        return None
    launches = sum(f.attrs["stencils"] for f in fits)
    iters = sum(sum(u["n_iter"]) for u in record["units"])
    return launches / iters if iters else None
