"""``clamp_cast_paste_q``: the quarter planes interleaved back, clamped to
[0, 255], truncated to u8 and pasted into the destination's interior. One
launch a frame: reads u (f32, c x h x w), writes c x h x w bytes; a clamp
and a cast a point."""

from portbench.geometry import for_launches

NAMES = [r"\bclamp_cast_paste_q_kernel\b"]


def cost(geom, launches):
    if geom["path"] != "mg_q":
        return None
    p = geom["c"] * geom["h"] * geom["w"]
    return for_launches(launches, 1, 2 * p, 5 * p)
