"""Device operations (kernels, copies, fills) in the traced window over the
queries it completed. One reader for every
``device_ops_per_query.<cell>``."""


def read(run):
    if run.trace is None or not run.queries or not run.trace.n_device_ops:
        return None
    return run.trace.n_device_ops / len(run.queries)
