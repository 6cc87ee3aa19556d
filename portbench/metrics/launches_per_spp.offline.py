"""Device operations a sample: kernels, copies and fills, the port's own
kernels included."""


def read(t):
    if not t.units or not t.device:
        return None
    return len(t.device) / t.units
