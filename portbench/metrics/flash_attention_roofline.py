"""``kernels.ops.flash_attention``'s share of its roofline over the traced window:
the least times of its launches (``kernels/flash_attention.py``, at 989 TFLOP/s and
3.35 TB/s) over the device time of the kernels named there, %."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "flash_attention")
