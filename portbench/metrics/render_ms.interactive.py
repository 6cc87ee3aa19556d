"""Mean milliseconds of a frame's ``Renderer.draw_frame``, synchronised
(host clock, the unprofiled window of the traced run)."""


def read(t):
    if not t.split or not t.split[0]:
        return None
    return 1e3 * sum(t.split[0]) / len(t.split[0])
