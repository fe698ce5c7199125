"""Mean over the window's untraced prefill calls (in a ``--trace 1`` run the
first half's: the profiler is on over the second) of the round trip less
the destination's ``compute_s``, from the session's ``AvecProfiler``
cycles: the facade, the host runtime, AVC2 serialization and the loopback
wire, ms."""
from portbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "prefill", "comm_s")
