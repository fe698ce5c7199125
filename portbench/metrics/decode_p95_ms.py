"""95th percentile of the round trip of the untraced decode calls of a
``--trace 1`` run (the first half's: the profiler is on over the second), as
the host's clock reads it around ``ClientSession.call``, ms.  It stands in
for ``itl_p95_ms`` per layer in the cells whose runs spread too widely to
bound that end to end."""
import numpy as np

from portbench import readers


def read(ctx):
    rts = [c["rt_s"] for c in readers.untraced(ctx, "decode")]
    return float(np.percentile(rts, 95)) * 1e3 if rts else None
