"""CUDA kernels the device ran per sampler step (render_score included)."""


def read(s):
    if s["kind"] != "pose" or not s["units"]:
        return None
    return s["kernels"] / s["units"]
