"""95th percentile of the window's query latencies; a batch is one query.
Each latency is the interval between two CUDA events recorded on the
card's stream, one before the query is issued and one after its last
operation: the device's own timestamps, not the host's clock. One reader
for every ``query_p95_ms.<cell>``."""

import numpy as np


def read(run):
    if not run.queries:
        return None
    return float(np.percentile([q.latency_ms for q in run.queries], 95))
