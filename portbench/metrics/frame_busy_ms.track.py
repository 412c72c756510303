"""Device time per tracked frame of every device operation that is not a
kernel of csrc/render_score.cu, ms."""


def read(s):
    if s["kind"] != "track" or not s["units"]:
        return None
    return 1e3 * s["nonraster_busy_s"] / s["units"]
