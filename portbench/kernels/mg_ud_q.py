"""``mg_ud_q``: one V-cycle's turn at the finest level, the ascent (the
coarse correction added from its even / odd column halves, nu2 = 2 sweeps)
fused with the next descent (nu1 = 1 sweep, the residual and its max, the
restriction). Reads u and g (f32, c x h x w each) and the two correction
halves (c x ceil(h/2) x ceil(w/2) each), writes u and the coarse RHS (c x
hc x wc); about 25 operations a point. One launch a cycle."""

from portbench.geometry import coarse, for_launches

NAMES = [r"\blevel_q_kernel<(true|1), (true|1)"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c, h, w = geom["c"], geom["h"], geom["w"]
    p = c * h * w
    halves = 2 * c * ((h + 1) // 2) * ((w + 1) // 2)
    return for_launches(launches, 1, 25 * p, 4 * (3 * p + halves + c * coarse(h) * coarse(w)))
