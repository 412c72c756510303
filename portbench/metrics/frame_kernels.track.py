"""CUDA kernels the device ran per tracked frame (render_score included)."""


def read(s):
    if s["kind"] != "track" or not s["units"]:
        return None
    return s["kernels"] / s["units"]
