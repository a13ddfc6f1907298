"""Seconds of co-registration (``affine_align``, called by
``pipeline.run.init``) per subject, from the benchmark's span around it."""


def read(record):
    spans = record["spans"].get("registration.coreg", [])
    n = sum(u["B"] for u in record["units"])
    return sum(spans) / n if spans and n else None
