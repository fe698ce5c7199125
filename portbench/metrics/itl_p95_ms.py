"""95th percentile of the round trip of every decode call issued in the
window, as the host's clock reads it around ``ClientSession.call``: the gap
between tokens an edge device sees, ms."""
from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx, "decode")
