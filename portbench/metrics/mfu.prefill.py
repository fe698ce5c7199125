"""The operations of the window's untraced prefill calls (in a ``--trace 1``
run the first half's: the profiler is on over the second), by the
reference's ``call_flops`` from the configuration's shapes (the same
whatever computes them), over their summed ``compute_s`` at the H100's
bf16 peak of 989 TFLOP/s, %."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "prefill")
