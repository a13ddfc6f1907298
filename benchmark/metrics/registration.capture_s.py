"""Seconds per subject of building the registration levels' CUDA graphs,
from the program's own spans (``unires_torch.utils.trace``): the sum of the
``registration.level.capture`` spans (each level's warm-up and capture, up
to the capture's wait for the device) of coreg and atlas alignment."""
from harness import recorder


def read(record):
    units = recorder.units(record)
    if not units:
        return None
    s = sum(c.s for _, below in units
            for c in below["registration.level.capture"])
    return s / recorder.subjects(units)
