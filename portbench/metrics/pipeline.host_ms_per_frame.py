"""The host's enqueue time a frame, in ms: the port's ``pipeline.frame``
spans less the ``solver.check`` waits inside them (a host read of a
residual waits on the card), over the profiled frames."""


def read(s):
    p = s.get("program")
    row = p and p["spans"].get("pipeline.frame")
    if not row or not p["frames"]:
        return None
    return (row["us"] - p["checks_in_frames_us"]) / p["frames"] * 1e-3
