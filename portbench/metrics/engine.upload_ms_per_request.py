"""The port's ``engine.upload`` span a request, in ms: the host's time in
the copies of a request's host arrays (source, destination) to the card,
pageable memory as the API takes it; the mean over the profiled
requests."""


def read(s):
    p = s.get("program")
    row = p and p["spans"].get("engine.upload")
    if not row or not p["requests"]:
        return None
    return row["us"] / p["requests"] * 1e-3
