"""Host calls that put work on the device (kernel and graph launches,
copies, fills: the profiler's CPU events) per replayed sampler step of the
traced requests, prep and readback included."""


def read(s):
    if s["kind"] != "pose" or not s["units"]:
        return None
    return s["host_calls"] / s["units"]
