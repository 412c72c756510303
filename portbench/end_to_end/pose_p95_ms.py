"""95th percentile over every pose of the window of the time from the
request's start to its estimate on the host, ms (linear between order
statistics); a failed request reads as infinitely late."""

import math


def read(w):
    lat = sorted((e - s) * 1e3 if ok else math.inf for s, e, _, ok in w["requests"])
    if not lat:
        return None
    k = 0.95 * (len(lat) - 1)
    lo, hi = math.floor(k), math.ceil(k)
    if math.isinf(lat[hi]):
        return math.inf
    return lat[lo] + (lat[hi] - lat[lo]) * (k - lo)
