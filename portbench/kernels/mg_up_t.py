"""``mg_up_t``: a coarse level's ascent (the next level's transposed
correction prolonged and added, nu2 = 2 sweeps). At each fused coarse level
(h, w) of the quarter chain it reads u and g (f32, c x h x w each) and the
correction (c x hc x wc) and writes u; about 14 operations a point. One
launch a fused level a cycle."""

from portbench.geometry import coarse, mg_q_coarse_levels, for_launches

NAMES = [r"\bmg_up_t_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c = geom["c"]
    levels = mg_q_coarse_levels(geom["h"], geom["w"])
    ops = sum(14 * c * h * w for h, w in levels)
    nbytes = sum(4 * c * (3 * h * w + coarse(h) * coarse(w)) for h, w in levels)
    return for_launches(launches, len(levels), ops, nbytes)
