"""Mean over the window's untraced prefill calls (in a ``--trace 1`` run the
first half's) of a MoE's stages inside each layer's ``ffn`` (``obs.trace``,
stamped in ``models/moe.py``): host time in the router and dispatch
(``route``), the routed experts and the combine (``experts``) and the shared
expert (``shared``), summed over the layers, ms.  None where the program
books no such stage."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "prefill", ("route", "experts", "shared"))
