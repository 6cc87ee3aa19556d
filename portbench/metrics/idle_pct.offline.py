"""The device's idle share: 1 - (device busy seconds a sample, from the
profiled stretch) / (wall seconds a sample, from the unprofiled window of
the same run)."""


def read(t):
    if not t.units or not t.device or t.wall_per_unit_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.units / t.wall_per_unit_s)
