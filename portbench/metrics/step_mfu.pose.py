"""The whole step's share of the card's fp32 peak, %: the fp32 operations
of the step's render_score launches (portbench/roofline.py, on the traced
populations; the other kernels, elementwise over [particles, <= 16]
tensors, are not counted) over the wall per step of the traced requests'
untraced twins times 67 TFLOP/s."""


def read(s):
    if s["kind"] != "pose" or not s.get("ops_per_unit") or not s.get("request_wall_s"):
        return None
    per_unit_s = s["request_wall_s"] / s["units_per_request"]
    return 100.0 * s["ops_per_unit"] / (per_unit_s * s["peak_flops"])
