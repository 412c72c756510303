"""Host calls that put work on the device per tracked frame of the traced
clips, upload and readback included."""


def read(s):
    if s["kind"] != "track" or not s["units"]:
        return None
    return s["host_calls"] / s["units"]
