"""``kernels.ops.ssd_scan``'s share of its roofline over the traced window of
a chat cell, whose end-to-end rate it moves (``ssd_scan_roofline`` is the
same share in a prompt cell, where it moves the time to the first token):
the least times of its launches (``kernels/ssd_scan.py``, at 989 TFLOP/s and
3.35 TB/s) over the device time of the kernels named there, %."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "ssd_scan")
