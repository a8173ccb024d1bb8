"""``erode3``: the mask window (u8, bh x bw) eroded three times by a 3x3
box. Reads the window once, writes it once; 8 minima a pixel a pass.
One launch a frame on every path."""

from portbench.geometry import for_launches

NAMES = [r"\berode3_kernel\b"]


def cost(geom, launches):
    px = geom["bh"] * geom["bw"]
    return for_launches(launches, 1, 24 * px, 2 * px)
