"""``preprocess_rhs_q``: guidance and Poisson RHS of the multigrid chain,
born as the finest level's four quarter planes. Reads the destination ROI
and the patch (u8, c x bh x bw each) and the eroded mask (bh x bw), writes
the f32 RHS (c x h x w); about 30 operations a pixel and channel. One
launch a frame."""

from portbench.geometry import for_launches

NAMES = [r"\bpreprocess_rhs_q_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    c, px = geom["c"], geom["bh"] * geom["bw"]
    return for_launches(launches, 1, 30 * c * px, 2 * c * px + px + 4 * c * geom["h"] * geom["w"])
