"""The share of the device's idle time, in %, in which no program span
below ``engine.request`` was open: under the request span alone, or
outside every span of the port (between requests, or in the caller's own
code, such as the API's copy of the answer back to the host). None where
the program records no ``engine.request`` span or the card never idled."""

REQUEST = "engine.request"


def read(s):
    p = s.get("program")
    if not p or REQUEST not in p["spans"]:
        return None
    idle = p["idle_by_span"]
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * (idle.get(None, 0.0) + idle.get(REQUEST, 0.0)) / total
