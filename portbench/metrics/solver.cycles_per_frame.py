"""The multigrid's V-cycles a frame, from the port's counter
(``solvers.multigrid.COUNTS["cycles"]``) over the profiled requests; None
where the program has no such counter."""


def read(s):
    p = s.get("program")
    n = p and (p["counters"] or {}).get("solvers.multigrid.cycles")
    if n is None or not p["frames"]:
        return None
    return n / p["frames"]
