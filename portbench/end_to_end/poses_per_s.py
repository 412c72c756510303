"""Pose estimates completed over the time from the window's start to the
end of the last request started in it."""


def read(w):
    if not w["requests"]:
        return None
    done = sum(n for _, _, n, ok in w["requests"] if ok)
    return done / (max(e for _, e, _, _ in w["requests"]) - w["t0"])
