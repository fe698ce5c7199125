"""Mean over the window's untraced decode calls (in a ``--trace 1`` run the
first half's) of the ``mixer`` stage inside ``issue`` (``obs.trace``,
stamped in ``models/blocks.py``): host time in each layer's norm,
attention or Mamba call and residual add, summed over the layers, ms."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "decode", ("mixer",))
