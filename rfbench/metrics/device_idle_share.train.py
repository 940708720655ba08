"""Share of the traced window in which no device operation ran, in %."""


def read(run):
    s = run.summary
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
