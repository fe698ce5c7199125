"""Mean over the window's untraced decode calls (in a ``--trace 1`` run the
first half's) of the destination's ``issue`` span (``obs.trace``): the
library function on the host, entry to return, the model step's host work
that enqueues its device work; ``compute_ms.decode`` less the ``sync``
span, ms."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "decode", ("issue",))
