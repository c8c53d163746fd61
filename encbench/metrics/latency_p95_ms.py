"""The 95th percentile of the window's call latencies, each from the
call's start to its bytes returned (host clock), by the nearest rank over
all calls."""

import math


def read(run):
    lat = sorted(run.latencies)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
