#!/usr/bin/env python3
"""Compare the kernels of two checkouts of this repository on one NVIDIA
card, in one process each, in turns (old, new, new, old).

    python3 kernel_ab.py OLD_TREE [NEW_TREE]

OLD_TREE and NEW_TREE are checkouts (for the parent commit: ``git archive
<commit> | tar -x -C DIR``); NEW_TREE defaults to ``.``.  For each, device
time per call through the checkout's own ``kernels.ops``:

* ``flash``: ``ops.flash_attention`` at granite-3-2b's attention shapes (32/8
  heads of 64, bf16) at B 2, S 128 and B 8, S 256;
* ``decode``: ``ops.decode_attention`` against a 256-slot cache filled to 136
  and a 4096-slot cache filled to 4000;
* ``ssd``: ``ops.ssd_scan`` at mamba2-130m's shape (B 2, S 1024, 24 heads
  of 64, one group, d_state 128, chunk 256, bf16; x, B and C strided views
  of one conv output, as the model hands them over);
* ``rmsnorm``: ``ops.rmsnorm`` at every main-path shape: granite-3-2b's
  prefill (2,128,2048), decode (2,1,2048) and training (8,256,2048) rows,
  bf16 with the fp32 scale; mamba2-130m's mixer and final norms (2,1024,768)
  and (2,1,768) bf16 with the bf16 scale, its gated norm (2,1024,1536) and
  (2,1,1536) fp32;

each with the inputs L2-resident (warm) and, for the attention kernels and
the scan, with the 50 MB L2 overwritten before every call (cold); the
PyTorch yardstick beside each (SDPA for attention, ``F.rms_norm`` with the
weight in x's type for rmsnorm; no single PyTorch call computes the scan);
and each wrapper's host time per call at its first shape (the least of 5
rounds of 200 calls without a sync).  Device time is the profiler's sum of
the call's kernels' durations (one process per tree and kernel family, so
each traces a short history).  Prints one JSON line per run and a table.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

FAMILIES = ("flash", "decode", "ssd", "rmsnorm")
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

    def device_ms(fn, key, cold=False, iters=50):
        """Summed duration of the kernels whose name holds ``key`` (the
        flush's fill excluded), per call."""
        for _ in range(3):
            fn()
        for _ in range(3):      # a trace that lost its kernel events is taken again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    if cold:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and key in e.name and "Fill" not in e.name and not e.is_user_annotation]
            if len(events) >= iters:
                return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
        raise RuntimeError(f"the profiler saw {len(events)} of {iters} calls' kernels ({key!r})")

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
    if which == "ssd":
        B, S, H, P, G, N, L = 2, 1024, 24, 64, 1, 128, 256
        big = randn(B, S, H * P + 2 * G * N)
        x = big[..., :H * P].unflatten(-1, (H, P))
        Bm = big[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = big[..., H * P + G * N:].unflatten(-1, (G, N))
        dt = F.softplus(randn(B, S, H, dtype=torch.float32))
        A = -torch.exp(randn(H, dtype=torch.float32) * 0.5)
        for cold in (False, True):   # every kernel of the call: the scan's own
            out["ssd_scan" + (" cold" if cold else "")] = device_ms(
                lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=L), "", cold, iters=20)
        out["ssd_scan host us"] = host_us(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=L))
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
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--one":
        print("RESULT " + json.dumps(measure(Path(argv[2]).resolve(), argv[3])), flush=True)
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = Path(argv[1]).resolve(), Path(argv[2] if len(argv) == 3 else ".").resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for label, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        run = {}
        for which in FAMILIES:     # one process each: a short profiler history
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
        unit = "us" if "host" in k else "ms"
        print(f"{k + ' (' + unit + ')':58s} " + " ".join(f"{r[k]:10.5f}" for _, r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
