"""The least time the traced queries' bytes need at the card's published
memory rate, as a share of the device's busy time in the traced window.
Bytes: ``portbench/bytecount.py``, each input byte read once and each
output byte written once. One reader for every ``roofline_pct.<cell>``."""


def read(run):
    if (run.trace is None or not run.trace.busy_s or not run.queries
            or not run.peak_bytes_per_s):
        return None
    return 100.0 * sum(run.bytes) / run.peak_bytes_per_s / run.trace.busy_s
