"""The sphere and rectangle traces' share of their roofline: the summed
bounds of a sample's closest-hit calls (``charges.py``, from the live rays
each call was given) over the summed device time of the K3 kernels (the
nearest-hit kernels and K3b's live-lane listing)."""

from portbench import charges


def read(t):
    return charges.share(t.counter.of("spheres", "rects"), t.device_s("k3"),
                         t.peaks)
