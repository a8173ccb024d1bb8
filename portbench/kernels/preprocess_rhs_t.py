"""``preprocess_rhs_t``: guidance and Poisson RHS of the DST chain, its
output transposed. Reads the destination ROI and the patch (u8, c x bh x
bw each) and the eroded mask (bh x bw), writes the f32 RHS (c x h x w);
about 30 operations a pixel and channel. One launch a frame. The patch is
counted at c channels (a MONOCHROME request's gray is one plane: the count
is then 2 x bh x bw bytes high, under 6% of the stage)."""

from portbench.geometry import for_launches

NAMES = [r"\bpreprocess_rhs_t_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "dst_pair":
        return None
    c, px = geom["c"], geom["bh"] * geom["bw"]
    return for_launches(launches, 1, 30 * c * px, 2 * c * px + px + 4 * c * geom["h"] * geom["w"])
