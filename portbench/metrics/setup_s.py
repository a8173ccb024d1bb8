"""Set-up: from the start of the process to the window's first request
(imports, the kernels' build or load, the input pool, the engine's warm-up
with one request of each clone mode the traffic sends), in s."""


def read(s):
    return s["setup_s"]
