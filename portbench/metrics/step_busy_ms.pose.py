"""Device time per sampler step of every device operation (kernels,
copies, fills) that is not a kernel of csrc/render_score.cu, ms."""


def read(s):
    if s["kind"] != "pose" or not s["units"]:
        return None
    return 1e3 * s["nonraster_busy_s"] / s["units"]
