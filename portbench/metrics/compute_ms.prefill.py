"""Mean over the window's untraced prefill calls (in a ``--trace 1`` run the
first half's: the profiler is on over the second) of the destination's
``compute_s`` (``DestinationExecutor._run_one``: the library call between
two device synchronizations): the executor and the model step, ms."""
from portbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "prefill", "compute_s")
