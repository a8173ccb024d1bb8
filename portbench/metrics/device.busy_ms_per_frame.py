"""Device busy time (the union of kernels, copies and fills) a frame, in ms."""


def read(s):
    if not s["frames"] or s["busy_us"] <= 0:
        return None
    return s["busy_us"] / s["frames"] * 1e-3
