"""Mean host time of one call into a ``kernels.ops`` wrapper over the
window's untraced decode calls (in a ``--trace 1`` run the first half's):
the wrappers' counters (``obs.trace``), summed seconds over summed calls,
us.  In decode the wrappers are ``rmsnorm`` and ``decode_attention``."""
from portbench import spans


def read(ctx):
    return spans.wrapper_us(ctx, "decode")
