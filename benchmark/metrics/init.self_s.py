"""Seconds of ``init`` per subject outside registration, from the program's
own spans (``unires_torch.utils.trace``): each ``init`` span less its
``registration.coreg`` and ``registration.atlas`` children (reading the
inputs, the hyper-parameters, the output grid, the initial reslice)."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    s = 0.0
    for _, below in units:
        reg = below["registration.coreg"] + below["registration.atlas"]
        for init in below["init"]:
            s += init.s - sum(r.s for r in reg if r.parent == init.serial)
    return s / recorder.subjects(units)
