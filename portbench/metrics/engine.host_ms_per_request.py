"""Host time before a request reaches the card: from the harness's
``portbench.request`` span's start to the request's first device op
(``timed_serve``'s mask prep on the host, the buffer copy's and the mask
upload's dispatch), the mean over the profiled requests, in ms."""


def read(s):
    if not s["host_us"]:
        return None
    return sum(s["host_us"]) / len(s["host_us"]) * 1e-3
