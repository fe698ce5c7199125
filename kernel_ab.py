#!/usr/bin/env python3
"""Compare the kernels of two checkouts of this repository on one NVIDIA
card, in one process each, in turns (old, new, new, old).

    python3 kernel_ab.py [--only FAMILY[,FAMILY...]] OLD_TREE [NEW_TREE]

OLD_TREE and NEW_TREE are checkouts (for the parent commit: ``git archive
<commit> | tar -x -C DIR``); NEW_TREE defaults to ``.``; ``--only`` picks
families (default: all).  For each, device time per call through the
checkout's own ``kernels.ops``:

* ``flash``: ``ops.flash_attention`` at granite-3-2b's attention shapes (32/8
  heads of 64, bf16) at B 2, S 128 and B 8, S 256;
* ``decode``: ``ops.decode_attention`` against a 256-slot cache filled to 136
  and a 4096-slot cache filled to 4000;
* ``ssd``: ``ops.ssd_scan`` at mamba2-130m's shape (B 2, S 1024, 24 heads
  of 64, one group, d_state 128, chunk 256, bf16; x, B and C strided views
  of one conv output, as the model hands them over) and at
  jamba-1.5-large-398b's (128 heads of 128, the rest alike; a tree whose
  tensor-core branch stops at head dim 64 runs it on its CUDA-core kernel);
* ``rmsnorm``: ``ops.rmsnorm`` at every main-path shape: granite-3-2b's
  prefill (2,128,2048), decode (2,1,2048) and training (8,256,2048) rows,
  bf16 with the fp32 scale; mamba2-130m's mixer and final norms (2,1024,768)
  and (2,1,768) bf16 with the bf16 scale, its gated norm (2,1024,1536) and
  (2,1,1536) fp32;
* ``quant``: ``ops.quantize_int8`` over one exchange of granite-3-2b's
  gradients (its 11 leaves' rows, as ``compressed_psum`` quantizes them) in
  bf16 and in fp32 (the pass ``ErrorFeedback`` runs), and alone at w_gate's
  (81,920 x 8192), wq's (2,621,440 x 64) and w_down's (327,680 x 2048)
  rows in both types;
* ``exchange``: the host wall (synchronized) of ``compressed_grad_allreduce``
  over random bf16 gradients of granite-3-2b's 11 leaves on a one-rank NCCL
  group (from a file store), as ``chip_smoke.py`` phase 7 exchanges them:
  the least and the median of 7 calls after a warm one;

each with the inputs L2-resident (warm) and, for the attention kernels and
the scan, with the 50 MB L2 overwritten before every call (cold); the
PyTorch yardstick beside each (SDPA for attention, ``F.rms_norm`` with the
weight in x's type for rmsnorm; no single PyTorch call computes the scan);
and each wrapper's host time per call at its first shape (the quantize's at
granite's (40, 2048) norm leaf; the least of 5 rounds of 200 calls without
a sync).  Device time is the profiler's sum of
the call's kernels' durations (one process per tree and kernel family, so
each traces a short history).  Prints one JSON line per run and a table.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

FAMILIES = ("flash", "decode", "ssd", "rmsnorm", "quant", "exchange")
RMS_SHAPES = [((2, 128, 2048), "bfloat16", "float32"), ((2, 1, 2048), "bfloat16", "float32"),
              ((8, 256, 2048), "bfloat16", "float32"), ((2, 1024, 768), "bfloat16", "bfloat16"),
              ((2, 1, 768), "bfloat16", "bfloat16"), ((2, 1024, 1536), "float32", "float32"),
              ((2, 1, 1536), "float32", "float32")]


def measure(tree: Path, which: str) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ops
    assert str(tree) in ops.__file__, ops.__file__

    dev = torch.device("cuda", 0)
    _build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)   # > the 50 MB L2

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def device_ms(fn, key, cold=False, iters=50, per_call=None):
        """Summed duration of the kernels whose name holds ``key`` (the
        flush's fill excluded), per call.  ``per_call``, where given, is the
        number of such kernels a call launches: the trace then holds one
        call more than it counts and sums the last ``iters * per_call``
        kernels by start time, so a trace that lost the first call's
        kernels (seen in a long process) still counts whole calls."""
        for _ in range(3):
            fn()
        calls = iters if per_call is None else iters + 1
        for _ in range(3):      # a trace that lost its kernel events is taken again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    if cold:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and key in e.name and "Fill" not in e.name
                             and not e.is_user_annotation), key=lambda e: e.time_range.start)
            want = iters if per_call is None else iters * per_call
            if len(events) >= want:
                kept = events if per_call is None else events[len(events) - want:]
                return sum(e.time_range.elapsed_us() for e in kept) / 1e3 / iters
        raise RuntimeError(f"the profiler saw {len(events)} kernels for {calls} calls ({key!r})")

    def host_us(fn, n=200, rounds=5):      # the least of 5 rounds: the host is shared
        best = float("inf")
        for _ in range(rounds):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
        return best / n * 1e6

    out = {}
    for B, S in ((2, 128), (8, 256)) if which == "flash" else ():
        q, k, v = randn(B, S, 32, 64), randn(B, S, 8, 64), randn(B, S, 8, 64)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        tag = f"flash B{B} S{S}"
        for cold in (False, True):
            c = " cold" if cold else ""
            out[tag + c] = device_ms(lambda: ops.flash_attention(q, k, v), "flash", cold)
            out[f"sdpa {tag}{c}"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), "", cold)
        if B == 2:
            out["flash host us"] = host_us(lambda: ops.flash_attention(q, k, v))
    for S, kv_len in ((256, 136), (4096, 4000)) if which == "decode" else ():
        q, kc, vc = randn(2, 1, 32, 64), randn(2, S, 8, 64), randn(2, S, 8, 64)
        lens = torch.full((2,), kv_len, dtype=torch.int32, device=dev)
        qd, kd, vd = q.transpose(1, 2), kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
        tag = f"decode S{S} kv_len {kv_len}"
        for cold in (False, True):
            c = " cold" if cold else ""
            out[tag + c] = device_ms(lambda: ops.decode_attention(q, kc, vc, lens), "decode", cold)
            out[f"sdpa {tag}{c}"] = device_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, enable_gqa=True), "", cold)
        if S == 256:
            out["decode host us"] = host_us(lambda: ops.decode_attention(q, kc, vc, lens))
    for tag, H, P in (("", 24, 64), (" jamba", 128, 128)) if which == "ssd" else ():
        B, S, G, N, L = 2, 1024, 1, 128, 256
        big = randn(B, S, H * P + 2 * G * N)
        x = big[..., :H * P].unflatten(-1, (H, P))
        Bm = big[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = big[..., H * P + G * N:].unflatten(-1, (G, N))
        dt = F.softplus(randn(B, S, H, dtype=torch.float32))
        A = -torch.exp(randn(H, dtype=torch.float32) * 0.5)
        for cold in (False, True):   # every kernel of the call: the scan's own
            out["ssd_scan" + tag + (" cold" if cold else "")] = device_ms(
                lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=L), "", cold, iters=20)
        out[f"ssd_scan{tag} host us"] = host_us(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=L))
    for shape, dt, sdt in RMS_SHAPES if which == "rmsnorm" else ():
        xr = randn(*shape, dtype=getattr(torch, dt))
        sr = randn(shape[-1], dtype=getattr(torch, sdt))
        w = sr.to(xr.dtype)
        tag = f"rmsnorm {shape} {dt} scale {sdt}"
        out[tag] = device_ms(lambda: ops.rmsnorm(xr, sr), "rmsnorm")
        out[f"F.rms_norm {shape} {dt}"] = device_ms(
            lambda: F.rms_norm(xr, (shape[-1],), w, 1e-6), "")
        if shape == RMS_SHAPES[0][0]:
            out["rmsnorm host us"] = host_us(lambda: ops.rmsnorm(xr, sr))
    if which == "quant":
        out.update(quant_times(ops, randn, device_ms, host_us))
    if which == "exchange":
        out.update(exchange_wall(randn))
    return out


def quant_times(ops, randn, device_ms, host_us) -> dict:
    """``ops.quantize_int8`` over one exchange's 11 leaves in bf16 and fp32,
    and at w_gate's and wq's rows alone."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.comm_quant import leaf_rows
    from repro_torch.models import model as M
    from repro_torch.utils import tree_leaves

    shapes = [tuple(leaf_rows(t).shape)
              for t in tree_leaves(M.abstract_params(get_arch("granite-3-2b")))]   # meta tensors
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        leaves = [randn(*shape, dtype=dt) for shape in shapes]
        name = str(dt).removeprefix("torch.")

        def exchange():
            for x in leaves:
                ops.quantize_int8(x)
        out[f"quantize {len(leaves)} leaves {name}"] = device_ms(exchange, "quantize", iters=5,
                                                                 per_call=len(leaves))
        for shape in ((81920, 8192), (2621440, 64), (327680, 2048)):
            x = next(x for x in leaves if tuple(x.shape) == shape)
            out[f"quantize {shape} {name}"] = device_ms(lambda: ops.quantize_int8(x), "quantize",
                                                        iters=20, per_call=1)
        del leaves
        torch.cuda.empty_cache()
    x = randn(40, 2048)
    out["quantize host us"] = host_us(lambda: ops.quantize_int8(x))
    return out


def exchange_wall(randn) -> dict:
    """Host wall of one compressed exchange of granite-3-2b-shaped bf16
    gradients on a one-rank NCCL group."""
    import os
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import ReduceGroups, compressed_grad_allreduce
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map

    grads = tree_map(lambda t: randn(*t.shape), M.abstract_params(get_arch("granite-3-2b")))
    walls = []
    with tempfile.TemporaryDirectory(prefix="kernel_ab_nccl_") as store_dir:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1)
        try:
            groups = ReduceGroups(fast=None, slow=dist.group.WORLD)
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = compressed_grad_allreduce(groups, grads)
                torch.cuda.synchronize()
                if i:                              # the first call is the warm one
                    walls.append((time.perf_counter() - t0) * 1e3)
                del out
        finally:
            dist.destroy_process_group()
    return {"exchange wall min (ms)": min(walls),
            "exchange wall median (ms)": statistics.median(walls)}


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--one":
        print("RESULT " + json.dumps(measure(Path(argv[2]).resolve(), argv[3])), flush=True)
        return 0
    families, argv = FAMILIES, list(argv)
    if len(argv) > 2 and argv[1] == "--only":
        families = tuple(argv[2].split(","))
        del argv[1:3]
    if len(argv) not in (2, 3) or not set(families) <= set(FAMILIES):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = Path(argv[1]).resolve(), Path(argv[2] if len(argv) == 3 else ".").resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for label, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        run = {}
        for which in families:     # one process each: a short profiler history
            res = subprocess.run([sys.executable, __file__, "--one", str(tree), which],
                                 capture_output=True, text=True)
            line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
            if res.returncode != 0 or not line:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            run.update(json.loads(line[0][len("RESULT "):]))
        runs.append((label, run))
        print(label, str(tree), json.dumps(run), flush=True)
    keys = list(runs[0][1])
    print(f"{'':58s} " + " ".join(f"{label:>10s}" for label, _ in runs))
    for k in keys:
        unit = "" if "(ms)" in k else " (us)" if "host" in k else " (ms)"
        print(f"{k + unit:58s} " + " ".join(f"{r[k]:10.5f}" for _, r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
