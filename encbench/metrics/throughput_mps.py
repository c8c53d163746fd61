"""Megapixels encoded per second: every pixel of every call in the window
over the window's whole time (host clock)."""


def read(run):
    return run.calls * run.pixels_per_call / run.window_s / 1e6
