"""Share of the traced window in which no operation ran on the device: 1 -
busy / window, busy from the profiler's device-side events. One reader
for every ``idle_pct.<cell>``."""


def read(run):
    if run.trace is None or not run.trace.busy_s or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
