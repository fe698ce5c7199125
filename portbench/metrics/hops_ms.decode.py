"""Mean over the window's untraced decode calls (in a ``--trace 1`` run the
first half's) of the measured hops outside the model step (``obs.trace``):
the client's ``serialize`` and ``send``, both ``unpack`` spans, the
destination's ``queue``, ``h2d`` and ``d2h``, ms.  ``offload_ms.decode``
less this is the ``respond`` remainder: the response pack, both flights
and the hand-off to the caller."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "decode", spans.HOPS)
