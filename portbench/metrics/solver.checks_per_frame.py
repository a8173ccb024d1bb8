"""The multigrid's host reads of a residual a frame (each waits on the
card), from the port's counter (``solvers.multigrid.COUNTS["checks"]``)
over the profiled requests; None where the program has no such counter."""


def read(s):
    p = s.get("program")
    n = p and (p["counters"] or {}).get("solvers.multigrid.checks")
    if n is None or not p["frames"]:
        return None
    return n / p["frames"]
