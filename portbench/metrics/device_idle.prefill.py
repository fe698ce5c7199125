"""The share of the traced prefill call cycles (from a call's start on the
device to the next call's) in which no device operation ran, from the
destination's device trace, %."""
from portbench import readers


def read(ctx):
    return readers.device_idle(ctx, "prefill")
