"""Share of a request's wall in which no device operation ran, %: 1 - the
device's busy time per traced request (the union of its operations'
intervals in the profiler's trace) over the wall of the same requests (same
item, same seed, so the same device work) served untraced just before. The
traced requests' own wall is not used: under the profiler the host's replay
loop runs 1.5-2.5x slower. The profiler also stretches device work by a
percent or two, so a device-bound cell can read slightly below 0."""


def read(s):
    if s["kind"] != "track" or not s["requests_traced"] or not s.get("request_wall_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["requests_traced"] / s["request_wall_s"])
