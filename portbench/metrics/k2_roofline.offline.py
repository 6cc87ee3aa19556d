"""The shade and texture kernels' share of their roofline: the summed
bounds of every depth's shading and texture stage (``charges.py``, from
the live lanes and hit lanes each call was given) over the summed device
time of K2 (all stages and their listing passes) and the texture
kernel."""

from portbench import charges


def read(t):
    return charges.share(t.counter.of("shade", "texture"),
                         t.device_s("k2", "tex"), t.peaks)
