"""``kernels.ops.moe_experts``'s share of its roofline over the traced window:
the least times of its launches (``kernels/moe_experts.py``: the routed
experts' weights read once, the rows in and out, the products, at 989
TFLOP/s and 3.35 TB/s) over the device time of the grouped products'
kernels named there, %.  None in a program without the op."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "moe_experts")
