"""The port's ``engine.prepare`` span a request, in ms: validation, the
mask's prep (its upload, ``prep_mask``, the bbox read on the side stream),
``auto`` and the cache lookups, on the host; the mean over the profiled
requests (a request of F ``run`` calls holds F such spans)."""


def read(s):
    p = s.get("program")
    row = p and p["spans"].get("engine.prepare")
    if not row or not p["requests"]:
        return None
    return row["us"] / p["requests"] * 1e-3
