"""``mg_down_q``: the finest level's first descent from a known-zero guess
(nu1 = 1 red-black sweep, the residual, its full-weighting restriction to
the transposed coarse level). Reads g (f32, c x h x w), writes u (c x h x
w) and the coarse RHS (c x hc x wc, hc = (h - 1) // 2); about 11
operations a point. One launch a frame in tolerance mode."""

from portbench.geometry import coarse, for_launches

NAMES = [r"\blevel_q_kernel<(false|0), (true|1)"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c, h, w = geom["c"], geom["h"], geom["w"]
    p = c * h * w
    return for_launches(launches, 1, 11 * p, 8 * p + 4 * c * coarse(h) * coarse(w))
