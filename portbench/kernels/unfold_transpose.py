"""``unfold_transpose``: the h axis's inverse unfold (out_x = E_x + O_x,
out_{n-1-x} = E_x - O_x) fused with a transpose. On the pair chain two
launches a frame, each over half of the columns; together they read the
two f32 halves (c x h x w together) and write the grid once, one add a
point."""

from portbench.geometry import for_launches

NAMES = [r"\bunfold_transpose_(kernel|strip|ragged)\b"]


def cost(geom, launches):
    if geom["path"] != "dst_pair":
        return None
    p = geom["c"] * geom["h"] * geom["w"]
    return for_launches(launches, 2, p, 8 * p)
