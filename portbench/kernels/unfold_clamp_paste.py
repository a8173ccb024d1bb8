"""``unfold_clamp_paste``: the w axis's inverse unfold, clamp to [0, 255],
truncation to u8 and the paste into the destination's interior. One
launch a frame on the pair chain: reads the two f32 halves (c x h x w
together), writes c x h x w bytes; an add, a clamp and a cast a point."""

from portbench.geometry import for_launches

NAMES = [r"\bunfold_clamp_paste_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "dst_pair":
        return None
    p = geom["c"] * geom["h"] * geom["w"]
    return for_launches(launches, 1, 3 * p, 5 * p)
