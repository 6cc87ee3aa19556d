"""Device milliseconds a sample of every device operation that is none of
the port's hand-written kernels (``kernels.json``): torch's kernels,
copies and fills, the frame loop's and the integrator's glue."""


def read(t):
    if not t.units or not t.device:
        return None
    return t.device_s("glue") * 1e3 / t.units
