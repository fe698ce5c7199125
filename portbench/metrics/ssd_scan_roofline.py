"""``kernels.ops.ssd_scan``'s share of its roofline over the traced window:
the least times of its launches (``kernels/ssd_scan.py``, at 989 TFLOP/s and
3.35 TB/s) over the device time of the kernels named there, %."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "ssd_scan")
