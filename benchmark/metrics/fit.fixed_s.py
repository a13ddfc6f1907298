"""Seconds per subject of a unit outside ``init`` and the fit's chunks, from
the program's own spans (``unires_torch.utils.trace``): each ``run.unit``
span less its ``init`` spans and its ``fit.chunk`` spans (a chunk's own
time, less the ``fit.capture`` the first one holds): the fit's set-up, the
chunk's warm-up and capture, its finish and the output's clamp and copy.
In a traced run the profiler's own time around its profiled chunk is left
out too."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    s = 0.0
    for run, below in units:
        s += (run.s - sum(i.s for i in below["init"])
              - sum(recorder.chunk_s(c, below) for c in below["fit.chunk"])
              - recorder.profiler_s(below))
    return s / recorder.subjects(units)
