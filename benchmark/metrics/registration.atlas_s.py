"""Seconds of atlas alignment (``atlas_align``, called by
``pipeline.run.init``) per subject, from the benchmark's span around it."""


def read(record):
    spans = record["spans"].get("registration.atlas", [])
    n = sum(u["B"] for u in record["units"])
    return sum(spans) / n if spans and n else None
