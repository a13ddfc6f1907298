"""NMI evaluations per subject in registration (coreg and atlas
alignment), from the program's own counts (``unires_torch.utils.trace``):
the ``evals`` of every ``registration.level`` span, summed over its
movers."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    n = sum(sum(lv.attrs["evals"]) for _, below in units
            for lv in below["registration.level"])
    return n / recorder.subjects(units)
