"""render_score's share of its roofline, %: the benchmark-counted bound of
one launch (portbench/roofline.py, on the populations the traced requests
held) over the profiler's device time per recorded launch."""


def read(s):
    if s["kind"] != "track" or not s["raster_recorded"] or not s.get("bound_per_launch_s"):
        return None
    return 100.0 * s["bound_per_launch_s"] / (s["raster_s"] / s["raster_recorded"])
