"""``mg_prolong_tq``: the first coarse level's correction (transposed, c x
wc x hc) prolonged to the finest level's even / odd column halves (c x
ceil(h/2) x ceil(w/2) each). Reads the correction once, writes both
halves; two operations a written point. One launch a cycle."""

from portbench.geometry import coarse, for_launches

NAMES = [r"\bmg_prolong_tq_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c, h, w = geom["c"], geom["h"], geom["w"]
    halves = 2 * c * ((h + 1) // 2) * ((w + 1) // 2)
    return for_launches(launches, 1, 2 * halves, 4 * (c * coarse(h) * coarse(w) + halves))
