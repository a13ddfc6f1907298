"""Milliseconds of the fit's chunks per subject-iteration, from the
program's own spans (``unires_torch.utils.trace``): every unprofiled
``fit.chunk`` of the window (launch and one read, less the capture the
first chunk of a fit holds) over the subject-iterations they ran, where
``device.busy_ms_per_subject_iter`` sees one chunk under the profiler."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    s = iters = 0
    for _, below in units:
        for c in below["fit.chunk"]:
            if not c.profiled:
                s += recorder.chunk_s(c, below)
                iters += c.attrs["iters"]
    return 1e3 * s / iters if iters else None
