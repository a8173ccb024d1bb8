"""``fold_minor``: the even/odd fold of one axis before its half-size DST
GEMMs (s_j = x_j + x_{n-1-j}, d_j = x_j - x_{n-1-j}). On the pair chain
two launches a frame (the h axis, then the w axis), each reading the f32
grid (c x h x w) and writing its two halves (c x h x w together); one add
a point."""

from portbench.geometry import for_launches

NAMES = [r"\bfold_minor_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "dst_pair":
        return None
    p = geom["c"] * geom["h"] * geom["w"]
    return for_launches(launches, 2, 2 * p, 2 * 8 * p)
