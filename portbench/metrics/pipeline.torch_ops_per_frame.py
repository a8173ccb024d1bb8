"""Top-level ``aten::`` ops the host issues a frame inside the profiled
requests (the pipeline's and the solver's glue in torch ops, each a
dispatch on the host and as a rule a launch on the card)."""


def read(s):
    return s["aten_ops"] / s["frames"] if s["frames"] else None
