"""Host time before a request reaches the card: from the harness's
``portbench.request`` span's start to the request's first device op (the
first engine call's validation and the dispatch of its mask's upload), the
mean over the profiled requests, in ms."""


def read(s):
    if not s["host_us"]:
        return None
    return sum(s["host_us"]) / len(s["host_us"]) * 1e-3
