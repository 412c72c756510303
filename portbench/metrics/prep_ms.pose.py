"""Host prep per pose (crop camera, crops, prior point), ms: the mean of
the benchmark's host-clock span around those calls, over the window's
untraced requests."""


def read(s):
    if s["kind"] != "pose" or not s["prep_s"]:
        return None
    return 1e3 * sum(s["prep_s"]) / len(s["prep_s"])
