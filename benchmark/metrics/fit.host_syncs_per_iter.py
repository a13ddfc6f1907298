"""Host reads of the device per subject-iteration of the fit, from the
program's own counts (``unires_torch.utils.trace``): each ``fit`` span's
``syncs`` (``utils.host.to_host.syncs`` over the fit: the capture's wait,
one read a chunk) over the window's iterations (each subject's
``n_iter``)."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    syncs = sum(f.attrs["syncs"] for _, below in units for f in below["fit"])
    iters = sum(sum(u["n_iter"]) for u in record["units"])
    return syncs / iters if iters else None
