"""95th percentile of the round trip of every prefill call issued in the
window (host clock around ``ClientSession.call``): the time to the first
token, ms."""
from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx, "prefill")
