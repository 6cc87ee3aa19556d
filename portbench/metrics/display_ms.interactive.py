"""Mean milliseconds of a frame's ``display_to_u8``, from the
synchronised end of its ``draw_frame`` to the uint8 image on the host
(host clock, the unprofiled window of the traced run)."""


def read(t):
    if not t.split or not t.split[1]:
        return None
    return 1e3 * sum(t.split[1]) / len(t.split[1])
