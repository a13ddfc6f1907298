"""Seconds of the fit chunk's warm-up and graph capture (``FitChunk._capture``,
device included) per fit: per subject, or per cohort in a batch."""


def read(record):
    spans = record["spans"].get("fit.capture", [])
    fits = len(record["units"])
    return sum(spans) / fits if spans and fits else None
