"""``transpose_pair``: two folded halves joined and transposed. On the pair
chain three launches a frame: one plain over the whole grid, and two that
also divide by the eigenvalue sums (lam_h + lam_w), each over half of the
rows. Each point is read once and written once (f32, c x h x w) by the
plain launch and once by the two dividing ones; the dividing ones read the
two eigenvalue vectors and add and divide once a point."""

from portbench.geometry import for_launches

NAMES = [r"\btranspose_pair_(kernel|ragged)\b"]


def cost(geom, launches):
    if geom["path"] != "dst_pair":
        return None
    h, w = geom["h"], geom["w"]
    p = geom["c"] * h * w
    return for_launches(launches, 3, 2 * p, 16 * p + 4 * (h + w))
