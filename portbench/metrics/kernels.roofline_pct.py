"""The port's own kernels against their bound, in %: the sum over every
kernel with a cost file under ``kernels/`` (and a count for this geometry)
of its bound (max of bytes / HBM bandwidth, operations / FP32 peak, for the
launches profiled) over the sum of their profiled device time."""


def read(s):
    rows = [r for r in s["kernels"].values() if r["bound_us"] is not None and r["us"] > 0]
    if not rows:
        return None
    return 100.0 * sum(r["bound_us"] for r in rows) / sum(r["us"] for r in rows)
