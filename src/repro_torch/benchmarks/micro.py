"""Microbenchmark helpers, the JAX package's ``benchmarks/micro.py``'s
twin.  So far the OpenPose-lite destination that the paper's use case
(``repro_torch.examples.openpose_pipeline``) serves from in a process of
its own; the other probes are still to be ported.
"""
from __future__ import annotations

_OPENPOSE_DESTINATION = r"""
import sys, os, threading
sys.path.insert(0, sys.argv[1])
# model the paper's topology: the destination is a separate machine with its
# own compute — keep it off the host's core so overlap has CPU to run on
n = os.cpu_count() or 2
if n > 1:
    try:
        os.sched_setaffinity(0, set(range(1, n)))
    except (AttributeError, OSError):
        pass
import repro_torch.models.openpose as op
from repro_torch.core.executor import DestinationExecutor
from repro_torch.core.library import make_openpose_library
from repro_torch.core.transport import TCPServer
device = sys.argv[2]
net = op.OpenPoseLite()
ex = DestinationExecutor({"openpose": make_openpose_library(net, device=device)},
                         name="bench-dest", device=device)
server = TCPServer(ex.handle).start()
print(server.port, flush=True)
threading.Event().wait()
"""


def spawn_openpose_destination(device: str = "cuda"):
    """Start an OpenPose-lite destination executor in its OWN process (the
    paper's topology: host and destination are different machines with
    different interpreters), computing on ``device`` (the card unless the
    caller asks for the CPU).  Returns (subprocess, port)."""
    import os
    import subprocess
    import sys

    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _OPENPOSE_DESTINATION, src, str(device)],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.strip():        # child died before binding: name the failure
        proc.terminate()
        rc = proc.wait()
        raise RuntimeError(
            f"openpose destination subprocess failed to start (exit {rc}); "
            "run it by hand to see the traceback")
    return proc, int(line)
