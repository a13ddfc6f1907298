"""Launches of the resampling kernels per subject-iteration of the fit, from
the program's own counts (``unires_torch.utils.trace``): each ``fit``
span's ``resamples`` (the device launch counters of ``ops.resample``'s
pull, push and pull_grad kernels over the fit, a batched launch counted
once; 0 where the plain versions ran) over the window's iterations (each
subject's ``n_iter``). A program whose ``fit`` spans carry no such count
has nothing to read.

Above 0 it shows that the fit takes the kernels; past that it counts the
data term's work an iteration: a pull and a push per observation in each
CG step's A^T A, a push for the right-hand side, and the pulls and
pull_grads of the objective and of the rigid Gauss-Newton round and its
line search. Declared ``lower``: fewer launches doing the same work (fewer
CG steps, a fused A^T A) is how it should move once it is above 0."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    fits = [f for _, below in units for f in below["fit"]]
    if not fits or any("resamples" not in f.attrs for f in fits):
        return None
    launches = sum(f.attrs["resamples"] for f in fits)
    iters = sum(sum(u["n_iter"]) for u in record["units"])
    return launches / iters if iters else None
