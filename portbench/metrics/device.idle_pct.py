"""The share of the profiled window in which no kernel, copy or fill ran on
the card, in %."""


def read(s):
    if s["window_us"] <= 0 or s["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
