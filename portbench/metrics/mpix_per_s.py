"""Interior megapixels of every frame that the window's requests completed,
over all of the window's time (first request's call to the last one's
return), in MP/s."""


def read(s):
    return s["mpix"] / s["window_s"] if s["window_s"] > 0 and s["mpix"] > 0 else None
