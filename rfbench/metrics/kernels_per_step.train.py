"""Device kernels launched in the traced window per train step."""


def read(run):
    steps = run.total("steps")
    return len(run.summary.kernels) / steps if steps else None
