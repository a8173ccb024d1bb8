"""``mg_down_t``: a coarse level's descent from a known-zero guess (nu1 = 1
sweep, the residual, the restriction to the next, transposed level). At
each fused coarse level (h, w) of the quarter chain
(``geometry.mg_q_coarse_levels``) it reads g (f32, c x h x w) and writes u
(c x h x w) and the next level's RHS; about 14 operations a point. One
launch a fused level a cycle, the levels in descent order."""

from portbench.geometry import coarse, mg_q_coarse_levels, for_launches

NAMES = [r"\bmg_down_t_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c = geom["c"]
    levels = mg_q_coarse_levels(geom["h"], geom["w"])
    ops = sum(14 * c * h * w for h, w in levels)
    nbytes = sum(4 * c * (2 * h * w + coarse(h) * coarse(w)) for h, w in levels)
    return for_launches(launches, len(levels), ops, nbytes)
