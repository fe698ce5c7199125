#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card, at
   granite-3-2b's and mamba2-130m's shapes, head dims 16 and 128, ragged
   lengths, kv_len 1 and S, S < chunk and S = 1, float32 and bfloat16; rmsnorm
   also at the training rows, with a bf16 scale, and on rows off 16 bytes
   or of a D that is not a multiple of the vector (its scalar loop); the SSD
   scan on both of its kernels (tensor cores: bf16 at mamba2-130m's shape,
   B 1 S 4096, ragged S, G > 1, P 48 N 96; CUDA cores: fp32, N 16, ragged
   L), each case checked to take its branch and called twice for
   bit-identical output; flash
   attention also at the training shape (B 8, S 256), a 1000-token ragged
   prompt at head dim 128 and phase 9's shapes (the engine's B 1 prefills at
   each of its prompt lengths, the sharded call's B 4 and B 8), decode attention also at B 8, a 4096-slot cache,
   kv_len on a split boundary and one past it, G 1 and 8, each attention
   kernel called twice for bit-identical output; time kernel, plain version
   and the PyTorch yardstick (``F.rms_norm``,
   ``F.scaled_dot_product_attention``, timed only, never called by the port;
   no single PyTorch call computes the SSD scan) at the main paths' shapes
   (rmsnorm at every one of them), flash also at the training shape and
   decode also at S 4096, with the wrappers' host time per call;
   the int8 quantize/dequantize kernels at every gradient leaf shape of
   granite-3-2b and mamba2-130m (fp32 and bf16 input), with rows that tie
   at k + 0.5, all-zero rows, rows of +-absmax and rows holding NaN or Inf:
   q equal, scale within rtol 1e-6 (NaN and Inf in place), every model
   leaf on the quantize's vector branch; rows off 16 bytes (``x[:, 1:]``)
   on its scalar branch; fp32 rows within 4 ulps of a tie at scales that
   are not powers of two (absmax up to 3e38 and under 1e-12); timed at
   w_gate's and wq's shapes and summed over one exchange's 11 leaves, the
   quantize in bf16 and in fp32, with its wrapper's host time
   (dequantize's yardstick ``torch.mul(q, scale)``, timed only; no single
   PyTorch call quantizes per row);
3b. each kernel's ``torch.autograd.Function`` (rmsnorm, flash attention,
   SSD scan) against the plain path at the training path's shapes, bf16 and
   fp32, ragged lengths and head_dim 16: the forward output at the kernel's
   phase-3 tolerance, and the gradients (the autograd plumbing);
4. a reduced granite-3-2b in float32 through the kernels on the card against
   the plain versions on the CPU (the CPU tests hold those against the JAX
   package), and prefill + decode against forward;
4b. the same for a reduced mamba2-130m;
4c. reduced granite-3-2b and mamba2-130m (float32) take 3 train steps on the
   card (kernels, recompute backward) and on the CPU (plain) from the same
   params: losses and params agree;
5. the first main path at full width: a port ``DestinationExecutor`` serving
   ``make_model_library(granite-3-2b)`` behind the port's ``TCPServer`` on
   127.0.0.1, driven by a port ``HostRuntime`` over ``TCPChannel``: ping,
   put_model of the full bf16 weights (made on the card from ``--seed``),
   prefill (B 2, S 128), 8 decodes and a score.  The launch counters are
   zeroed just before and read just after, and must match the model's
   structure; the prefill logits are compared with the same call through the
   plain versions;
6. the second main path, the same way: full-width mamba2-130m (24 layers,
   d_model 768), prefill (B 2, S 1024: four chunks of 256), 8 decodes and a
   score, through the SSD-scan and rmsnorm kernels, every scan on the
   tensor-core branch;
7. the training path at full width: granite-3-2b as registered (bf16,
   remat, AdamW) takes 4 ``Trainer`` steps (B 8, S 256), with exact
   launch counts per step; one data-parallel step exchanges its gradients
   through ``compressed_grad_allreduce`` over a one-rank NCCL group (built
   from a file store: no network) before ``apply_updates``; then
   ``ErrorFeedback`` and ``compress_tree``/``decompress_tree`` over the same
   gradients.  Prints step wall time, peak device memory and the exchange's
   time and wire bytes (``--profile``: one training step traced);
8. the paper's loop: OpenPose-lite (weights made on the card from
   ``--seed``, brought to the host, sent once by ``AvecSession.ensure_model``)
   served by a port ``DestinationExecutor`` behind ``TCPServer`` to a
   ``PipelinedHostRuntime`` (window 2).  An unmodified loop over 4 frames of
   368x656 calls ``op_forward`` and ``render_pose`` under
   ``InterceptionLibrary``: ``op_forward`` goes to the card, ``render_pose``
   stays on the host.  The beliefs are bit-identical to the destination
   library's own call and within 1e-4 x max|belief| of the CPU path; 8 frames
   through ``call_async`` are bit-identical to the same 8 through ``call``
   (walls, window and ``stats()`` printed); the paper's smallest image
   batch, B 64, twice (cold and warm, bit-identical; frame 0 against its B 1
   forward).  Prints ``compute_s``, ``wire_s``, the bytes per cycle against
   Eq. 1 and peak device memory; no kernel of the six is launched (cuDNN
   convolutions) (``--profile``: the B 1 and B 64 forwards traced);
9. the front door at granite-3-2b's full width: two port destinations on
   the card, "edge" behind ``TCPServer`` and ``SharedMemoryServer``, "cloud"
   behind ``TCPServer`` only, reached through ``repro_torch.avec.connect``
   (both handshakes give ``PipelinedHostRuntime``; edge is re-dialed over
   shared memory).  A tenant's session sends the weights once and repeats
   phase 5's calls, each output bit-identical to phase 5's, with phase 5's
   launch counts; the same prefill on the other destination (TCP against
   SHM ``wire_s``, ``put_model`` over each, SHM spills); ``hidden`` (B 8)
   sharded over both and stitched (within 5 % of the unsharded call); a
   ``map`` of 4 scores over both, each bit-identical to a direct call on the
   destination its ``served_by`` record names.  Then ``ServingEngine`` (4 slots, fp32
   cache) serves 8 requests of 16 tokens with prompts of 5–67 tokens on the
   card: exact launch counts (flash per prefill, decode per step), each
   token within the bf16 tolerance of a teacher-forced plain forward's
   argmax, near-ties counted; then a held run of 5 requests of unequal
   lengths (emptied slots decode at stale positions, one request spliced
   into a freed slot), every decode launch against its plain version on the
   same inputs and each tick's logits against a plain decode step on the
   same cache (``--profile``: one 4-slot tick traced).  Last,
   ``python -m repro_torch.launch.serve`` in its three roles as processes of
   their own (destination over TCP and SHM, stopped by SIGINT under
   ``--drain``; host; local), each exiting 0.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12             # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, no sparsity
MAIN_B, MAIN_S, CACHE_LEN, N_DECODE = 2, 128, 256, 8
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 4
LONG_CACHE, LONG_KV = 4096, 4000       # decode at a long cache
SSM_S = 1024                          # mamba2-130m prompt: four chunks of 256
# mamba2-130m's scan: (B, S, H, P, G, N, chunk)
SSD_MAIN = (MAIN_B, SSM_S, 24, 64, 1, 128, 256)
OP_FRAMES, OP_STREAM, OP_WINDOW = 4, 8, 2     # phase 8: the loop, the stream, the window
# phase 9: the engine's slots, cache, requests, tokens each and prompt lengths;
# the sharded hidden call's rows; the map's requests
ENGINE_B, ENGINE_LEN, ENGINE_REQS, ENGINE_NEW, ENGINE_PROMPT = 4, 256, 8, 16, (5, 67)
# the held decode run after it: tokens per request, unequal so that slots empty
# and decode at their stale positions, and one request admitted into a freed slot
ENGINE_CHECK_NEW = (3, 6, 9, 12, 4)
HIDDEN_B, MAP_REQS = 8, 4


def engine_prompts(seed: int, vocab: int) -> dict:
    """Phase 9d's prompts, drawn from ``seed``: a warm-up pair, the run's
    requests, the held decode run's and the profiled tick's, each a list of
    token lists of ENGINE_PROMPT's lengths.  Phase 3 holds flash at every
    one of these lengths."""
    gen = np.random.default_rng(seed + 9)
    lo, hi = ENGINE_PROMPT
    return {tag: [gen.integers(0, vocab, int(gen.integers(lo, hi + 1))).tolist()
                  for _ in range(n)]
            for tag, n in (("w", 2), ("r", ENGINE_REQS), ("c", len(ENGINE_CHECK_NEW)),
                           ("p", ENGINE_B))}


class CheckFailed(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)
    print(f"  ok  {msg}", flush=True)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def device_events(fn):
    """Run ``fn`` under torch.profiler; -> (host wall ms, device events, all
    events: host ops and ranges too)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a record_function range also leaves a device-side annotation event
    # spanning its kernels: not a kernel, so not device time
    return wall_ms, [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation], events


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call: the summed duration of the kernels ``fn``
    launches, over ``iters`` calls after a warm-up.  At these sizes a
    wrapper's host cost can exceed its kernel's, so events around the launch
    loop would time the host; inputs stay L2-resident, as in the main path."""
    for _ in range(warmup):
        fn()

    def loop():
        for _ in range(iters):
            fn()

    # every call launches the same kernels, so a trace whose count is not a
    # multiple of the calls lost events (now and then some or all of them,
    # at times in consecutive traces): take it again in a fresh profiler
    # session after a growing pause
    for pause in (0, 0.1, 0.5, 1, 2, 4):
        time.sleep(pause)
        _, events, _ = device_events(loop)
        if events and len(events) % iters == 0:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    raise CheckFailed(f"the profiler saw {len(events)} kernel events for {iters} calls")


def bound_ms(nbytes: int, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa_gqa(q, k, v, **kw):
    """Yardstick only: PyTorch's fused attention on (B,H,S,D) with GQA."""
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(gen, dev, engine_lens) -> dict:
    """-> each kernel's max abs error at the main path's shapes.
    ``engine_lens``: phase 9d's prompt lengths, each prefilled at B 1."""
    from repro_torch.kernels import ops

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    main_err = {}
    print("phase 3: kernels vs plain versions on the card", flush=True)
    # rmsnorm: f32 atol 1e-5 (test_kernels.py); bf16 within one output ulp (rtol 1e-2).
    # granite-3-2b's shapes (also the training rows, and with a bf16 scale),
    # small ones, then mamba2-130m's as its path gives them: mixer and final
    # norms on bf16 x with the bf16 scale, the gated norm on fp32 x (d_inner
    # 1536) with the fp32 scale, prefill and decode; then rows the vector
    # path does not take (off 16 bytes, D not a multiple of the vector),
    # which run the kernel's scalar loop
    for shape, dt, sdt, skew in [
            ((MAIN_B, MAIN_S, 2048), bf16, f32, 0), ((MAIN_B, MAIN_S, 2048), f32, f32, 0),
            ((MAIN_B, 1, 2048), bf16, f32, 0), ((TRAIN_B, TRAIN_S, 2048), bf16, f32, 0),
            ((MAIN_B, MAIN_S, 2048), bf16, bf16, 0), ((MAIN_B, 1, 2048), bf16, bf16, 0),
            ((37, 512), f32, f32, 0), ((37, 512), f32, bf16, 0), ((5, 16), f32, f32, 0),
            ((3, 128), bf16, f32, 0), ((MAIN_B, SSM_S, 768), bf16, bf16, 0),
            ((MAIN_B, SSM_S, 1536), f32, f32, 0), ((MAIN_B, 1, 768), bf16, bf16, 0),
            ((MAIN_B, 1, 1536), f32, f32, 0), ((37, 512), f32, f32, 1),
            ((MAIN_B, MAIN_S, 2048), bf16, f32, 1), ((7, 13), bf16, bf16, 0),
            ((9, 100), f32, f32, 3)]:
        # skew > 0: rows of a wider tensor from its element `skew` (off 16 bytes)
        x = randn(*shape[:-1], shape[-1] + skew, dtype=dt)[..., skew:]
        s = randn(shape[-1], dtype=sdt)
        got, want = ops.rmsnorm(x, s), ops.rmsnorm(x, s, impl="ref")
        e = max_err(got, want)
        tol = (got.float() - want.float()).abs() <= 1e-5 + (1e-2 if dt == bf16 else 0) * want.float().abs()
        rows = f", rows off 16 bytes by {skew}" if skew else ""
        check(bool(tol.all()), f"rmsnorm {shape} {dt} scale {sdt}{rows}: max abs err {e:.3e}")
        if (shape, dt, sdt, skew) == ((MAIN_B, MAIN_S, 2048), bf16, f32, 0):
            main_err["rmsnorm"] = e
    # flash: atol 2e-5 in f32, 2e-2 in bf16 (test_kernels.py); bf16 runs the
    # tensor-core kernel, f32 the CUDA-core one.  Serving and training shapes,
    # a long ragged prompt, head dims 16 and 128, Sq != Sk (the causal
    # diagonal of packed query heads), non-causal; then phase 9's shapes: the
    # engine's B 1 prefills at each of its prompt lengths and at lengths on
    # and around the 64-row tile (16 positions of G 4), and the sharded
    # hidden call's whole and per-shard rows; two calls bit-identical
    engine_cases = [((1, 32, 8, S, S, 64), bf16, True)
                    for S in sorted(set(engine_lens) | {5, 15, 16, 17, 37, 63, 64, 65, 67})]
    hidden_cases = [((B, 32, 8, MAIN_S, MAIN_S, 64), bf16, True)
                    for B in (HIDDEN_B // 2, HIDDEN_B)]
    for (B, H, K, Sq, Sk, D), dt, causal in [
            ((MAIN_B, 32, 8, MAIN_S, MAIN_S, 64), bf16, True),
            ((MAIN_B, 32, 8, MAIN_S, MAIN_S, 64), f32, True),
            ((TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 64), bf16, True),
            ((1, 32, 8, 1000, 1000, 128), bf16, True),
            ((1, 4, 2, 64, 64, 16), f32, True), ((1, 4, 2, 64, 64, 16), bf16, True),
            ((1, 4, 2, 64, 64, 16), bf16, False), ((1, 8, 2, 128, 128, 128), f32, True),
            ((1, 8, 2, 128, 128, 128), bf16, True), ((1, 8, 2, 128, 128, 128), bf16, False),
            ((2, 4, 2, 77, 77, 64), f32, True), ((2, 4, 2, 77, 77, 64), bf16, True),
            ((1, 4, 2, 37, 53, 64), f32, False), ((1, 4, 2, 37, 53, 64), bf16, True),
            ((1, 4, 2, 37, 53, 64), bf16, False), ((1, 4, 1, 19, 45, 16), bf16, True),
            ((1, 4, 1, 19, 45, 16), f32, True), ((1, 6, 2, 50, 70, 128), bf16, True),
            *engine_cases, *hidden_cases]:
        q, k, v = randn(B, Sq, H, D, dtype=dt), randn(B, Sk, K, D, dtype=dt), randn(B, Sk, K, D, dtype=dt)
        got = ops.flash_attention(q, k, v, causal=causal)
        again = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
        e = max_err(got, want)
        check(e <= (2e-2 if dt == bf16 else 2e-5) and torch.equal(got, again),
              f"flash_attention B{B} H{H} K{K} Sq{Sq} Sk{Sk} D{D} {dt} causal={causal}: "
              f"max abs err {e:.3e}, two calls bit-identical")
        if (B, H, Sq, D, dt, causal) == (MAIN_B, 32, MAIN_S, 64, bf16, True):
            main_err["flash_attention"] = e
    # decode: atol 2e-5 in f32, 2e-2 in bf16; kv_len random, 1 and S, on a
    # split boundary (32) and one past it (33); B 8, a 4096-slot cache, G 1
    # and 8; two calls bit-identical (the splits merge in a fixed order)
    for (B, K, G, S, D), qdt, kdt in [((MAIN_B, 8, 4, CACHE_LEN, 64), bf16, bf16),
                                      ((MAIN_B, 8, 4, CACHE_LEN, 64), f32, f32),
                                      ((8, 8, 4, CACHE_LEN, 64), bf16, bf16),
                                      ((MAIN_B, 8, 4, 4096, 64), bf16, bf16),
                                      ((MAIN_B, 8, 1, CACHE_LEN, 64), bf16, bf16),
                                      ((MAIN_B, 8, 8, CACHE_LEN, 64), bf16, bf16),
                                      ((3, 2, 8, 40, 16), f32, f32),
                                      ((1, 4, 1, 128, 128), f32, f32),
                                      ((2, 2, 4, 100, 128), bf16, bf16),
                                      ((2, 2, 2, 64, 16), f32, bf16),
                                      ((ENGINE_B, 8, 4, ENGINE_LEN, 64), bf16, f32)]:
        q = randn(B, 1, K * G, D, dtype=qdt)
        kc, vc = randn(B, S, K, D, dtype=kdt), randn(B, S, K, D, dtype=kdt)
        for lens in (torch.randint(1, S + 1, (B,), generator=gen, device=dev),
                     torch.ones(B, device=dev), torch.full((B,), S, device=dev),
                     torch.full((B,), min(32, S), device=dev),
                     torch.full((B,), min(33, S), device=dev)):
            lens = lens.to(torch.int32)
            got = ops.decode_attention(q, kc, vc, lens)
            again = ops.decode_attention(q, kc, vc, lens)
            want = ops.decode_attention(q, kc, vc, lens, impl="ref")
            e = max_err(got, want)
            check(e <= (2e-2 if qdt == bf16 else 2e-5) and torch.equal(got, again),
                  f"decode_attention B{B} K{K} G{G} S{S} D{D} q {qdt} kv {kdt} "
                  f"kv_len {lens.tolist()}: max abs err {e:.3e}, two calls bit-identical")
            if (B, K, G, S, qdt) == (MAIN_B, 8, 4, CACHE_LEN, bf16):
                main_err["decode_attention"] = max(main_err.get("decode_attention", 0.0), e)

    main_err["ssd_scan"] = ssd_checks(gen, dev)
    return main_err


def ssd_inputs(gen, dev, B, S, H, P, G, N, dtype):
    """x, dt, A, B, C in the distribution of ``tests/test_kernels.py``'s SSD
    cases; x, B and C are views of one (B,S,H*P+2GN) tensor, the layout in
    which the model hands them over (its conv output)."""
    big = torch.randn(B, S, H * P + 2 * G * N, generator=gen, device=dev)
    big[..., H * P:] *= 0.3
    big = big.to(dtype)
    x = big[..., :H * P].unflatten(-1, (H, P))
    Bm = big[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = big[..., H * P + G * N:].unflatten(-1, (G, N))
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.5)
    return x, dt, A, Bm, Cm


def ssd_checks(gen, dev) -> float:
    """ssd_scan against its plain version (the chunked algorithm) -> the
    main shape's bf16 max abs error on y.  Tolerances: y within
    2e-4 * (max|y| + 1) and the fp32 state within 2e-4 * (max|state| + 1),
    the bound ``tests/test_kernels.py`` holds the Pallas kernel to (fp32
    sums in another order, over up to 256-step decays); in bf16, y also
    within one output ulp (rtol 1e-2), since both round the same fp32 value
    to bf16 and may land on neighbouring values.  Each case must take the
    branch ``ssd_scan.tensor_core_branch`` names (bf16 at P, N multiples of
    16 and L a multiple of 64: the tensor cores; the rest the CUDA cores);
    the bf16 cases at B 1, S 4096 (16 chunks: the state passes along 16),
    ragged S and G > 1 run the tensor-core kernels.  Two calls must agree
    bit for bit (the chunk states pass in a fixed order, whichever block of
    a (batch row, head) finishes last)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import tensor_core_branch

    bf16, f32 = torch.bfloat16, torch.float32
    main = 0.0
    for shape, dt_ in [(SSD_MAIN, bf16), (SSD_MAIN, f32),
                       ((2, 512, 4, 64, 2, 128, 128), f32), ((1, 256, 2, 128, 1, 64, 256), f32),
                       ((2, 300, 4, 64, 4, 32, 128), f32), ((1, 128, 8, 32, 2, 64, 64), f32),
                       ((2, 37, 8, 16, 1, 16, 8), f32), ((2, 37, 8, 16, 1, 16, 8), bf16),
                       ((1, 5, 2, 16, 1, 16, 8), f32), ((1, 1, 24, 64, 1, 128, 256), bf16),
                       ((1, 4096, 24, 64, 1, 128, 256), bf16), ((2, 300, 4, 64, 4, 32, 128), bf16),
                       ((1, 128, 8, 32, 2, 64, 64), bf16), ((2, 200, 6, 16, 3, 16, 64), bf16),
                       ((1, 200, 2, 48, 1, 96, 64), bf16)]:
        B, S, H, P, G, N, L = shape
        args = ssd_inputs(gen, dev, B, S, H, P, G, N, dt_)
        ops.reset_launch_counts()
        y, st = ops.ssd_scan(*args, chunk=L)
        branch = {k: v for k, v in ops.branch_counts().items() if k.startswith("ssd_scan")}
        y2, st2 = ops.ssd_scan(*args, chunk=L)
        yr, sr = ops.ssd_scan(*args, chunk=L, impl="ref")
        torch.cuda.synchronize()
        tc = tensor_core_branch(dt_, P, N, ops.ssd_chunk_len(S, L))
        ey, es = max_err(y, yr), max_err(st, sr)
        tol_y = 2e-4 * (yr.float().abs().max().item() + 1.0)
        tol_s = 2e-4 * (sr.abs().max().item() + 1.0)
        ok_y = (y.float() - yr.float()).abs() <= tol_y + (1e-2 if dt_ == bf16 else 0) * yr.float().abs()
        check(bool(ok_y.all()) and es <= tol_s and y.dtype == dt_ and st.dtype == f32
              and branch == {"ssd_scan_tc": int(tc), "ssd_scan_simt": int(not tc)}
              and torch.equal(y, y2) and torch.equal(st, st2),
              f"ssd_scan B{B} S{S} H{H} P{P} G{G} N{N} L{L} {dt_} "
              f"({'tensor' if tc else 'CUDA'} cores): y max abs err {ey:.3e} "
              f"(tol {tol_y:.3e}), state {es:.3e} (tol {tol_s:.3e}), two calls bit-identical")
        if shape == SSD_MAIN and dt_ == bf16:
            main = ey
    ops.reset_launch_counts()
    return main


def kernel_times(gen, dev, main_err: dict) -> dict:
    """Kernel, plain and yardstick times at the main paths' shapes
    (granite-3-2b and mamba2-130m, bf16), with each kernel's bound."""
    from repro_torch.kernels import ops

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    # granite-3-2b's prefill rows first, then every other main-path shape:
    # its decode and training rows, mamba2-130m's norms (bf16 scale) and
    # its gated norm (fp32)
    rms = [rmsnorm_row(randn, shape, dt, sdt, host=i == 0) for i, (shape, dt, sdt) in enumerate(
        [((MAIN_B, MAIN_S, 2048), bf16, f32), ((MAIN_B, 1, 2048), bf16, f32),
         ((TRAIN_B, TRAIN_S, 2048), bf16, f32), ((MAIN_B, SSM_S, 768), bf16, bf16),
         ((MAIN_B, 1, 768), bf16, bf16), ((MAIN_B, SSM_S, 1536), f32, f32),
         ((MAIN_B, 1, 1536), f32, f32)])]
    rows["rmsnorm"] = dict(rms[0], at_other_shapes=rms[1:])
    rows["flash_attention"] = flash_row(randn, MAIN_B, MAIN_S, host=True)
    rows["flash_attention"]["at_other_shapes"] = [flash_row(randn, TRAIN_B, TRAIN_S)]
    rows["decode_attention"] = decode_row(randn, dev, CACHE_LEN, MAIN_S + N_DECODE, host=True)
    rows["decode_attention"]["at_other_shapes"] = [decode_row(randn, dev, LONG_CACHE, LONG_KV)]
    B, S, H, P, G, N, L = SSD_MAIN
    args = ssd_inputs(gen, dev, B, S, H, P, G, N, bf16)
    x, dtt, A, Bm, Cm = args
    nc = -(-S // L)
    flops = 2 * B * nc * (G * L * L * N + H * (L * L * P + 2 * L * N * P))
    b, why = bound_ms(B * S * (H * P + 2 * G * N) * 2 + nbytes(dtt, A)       # inputs read once
                      + B * S * H * P * 2 + B * H * P * N * 4, flops, bf16)  # y, state written once
    rows["ssd_scan"] = dict(
        shape=f"x {tuple(x.shape)} B/C {tuple(Bm.shape)} bf16 (strided views), chunk {L}, "
              f"tensor cores",
        ms=time_ms(lambda: ops.ssd_scan(*args, chunk=L), iters=20),
        plain_ms=time_ms(lambda: ops.ssd_scan(*args, chunk=L, impl="ref"), iters=20),
        library_ms=None, bound_ms=b, bound_by=why,   # no single PyTorch call computes SSD
        host_us=host_us(lambda: ops.ssd_scan(*args, chunk=L)))
    ops.reset_launch_counts()        # timing launches are not the main path's
    for name, r in rows.items():
        r["max_abs_err"] = main_err[name]
        for row in [r] + r.get("at_other_shapes", []):
            lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.5f} ms"
            host = f", wrapper host {row['host_us']:.1f} us/call" if "host_us" in row else ""
            print(f"  {name} [{row['shape']}]: kernel {row['ms']:.5f} ms, plain "
                  f"{row['plain_ms']:.5f} ms, yardstick {lib}, bound {row['bound_ms']:.5f} ms "
                  f"({row['bound_by']}){host}", flush=True)
        print(f"  {name}: main-shape max abs err {r['max_abs_err']:.3e}", flush=True)
    return rows


def host_us(fn, n: int = 200, rounds: int = 5) -> float:
    """Host time per call of ``fn`` (the wrapper's Python, allocation and
    launch), in microseconds: the least over ``rounds`` rounds of ``n`` calls
    without a sync (the host is shared, so single rounds vary)."""
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


def rmsnorm_row(randn, shape, dt, sdt, host=False) -> dict:
    """rmsnorm on x ``shape`` in ``dt`` with a ``sdt`` scale: kernel, plain,
    ``F.rms_norm`` (its weight in x's type) and the bound (x and the scale
    read once, y written once; 4 flops per element)."""
    from repro_torch.kernels import ops, ref

    x, s = randn(*shape, dtype=dt), randn(shape[-1], dtype=sdt)
    w = s.to(dt)
    b, why = bound_ms(nbytes(x, s) + nbytes(x), 4 * x.numel(), torch.float32)
    row = dict(shape=f"x {tuple(x.shape)} {str(dt)[6:]}, scale {str(sdt)[6:]}",
               ms=time_ms(lambda: ops.rmsnorm(x, s)), plain_ms=time_ms(lambda: ref.rmsnorm(x, s)),
               library_ms=time_ms(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6)),
               bound_ms=b, bound_by=why)
    if host:
        row["host_us"] = host_us(lambda: ops.rmsnorm(x, s))
    return row


def flash_row(randn, B, S, host=False) -> dict:
    """granite-3-2b's causal self-attention (32/8 heads of 64, bf16) at
    (B, S): kernel, plain, SDPA and the bound (q, k, v read once, o written
    once; 4*D flops per causal (query, key) pair per head)."""
    bf16 = torch.bfloat16
    from repro_torch.kernels import ops

    q = randn(B, S, 32, 64, dtype=bf16)
    k, v = randn(B, S, 8, 64, dtype=bf16), randn(B, S, 8, 64, dtype=bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = S * (S + 1) // 2
    b, why = bound_ms(nbytes(q, k, v) + nbytes(q), 4 * B * 32 * 64 * pairs, bf16)
    row = dict(shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
               ms=time_ms(lambda: ops.flash_attention(q, k, v)),
               plain_ms=time_ms(lambda: ops.flash_attention(q, k, v, impl="ref")),
               library_ms=time_ms(lambda: sdpa_gqa(qt, kt, vt, is_causal=True)),
               bound_ms=b, bound_by=why)
    if host:
        row["host_us"] = host_us(lambda: ops.flash_attention(q, k, v))
    return row


def decode_row(randn, dev, S, kv_len, host=False) -> dict:
    """granite-3-2b's decode attention (B 2, 32/8 heads of 64, bf16) against
    an S-slot cache filled to kv_len: kernel, plain, SDPA over the first
    kv_len keys, and the bound (the kv_len rows of K and V read once)."""
    bf16 = torch.bfloat16
    from repro_torch.kernels import ops

    qd = randn(MAIN_B, 1, 32, 64, dtype=bf16)
    kc, vc = randn(MAIN_B, S, 8, 64, dtype=bf16), randn(MAIN_B, S, 8, 64, dtype=bf16)
    lens = torch.full((MAIN_B,), kv_len, dtype=torch.int32, device=dev)
    read = 2 * MAIN_B * 8 * kv_len * 64 * 2
    b, why = bound_ms(nbytes(qd, lens) + read + nbytes(qd), 4 * MAIN_B * 32 * 64 * kv_len, bf16)
    qdt, kct, vct = qd.transpose(1, 2), kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
    row = dict(shape=f"q {tuple(qd.shape)} cache {tuple(kc.shape)} kv_len {kv_len} bf16",
               ms=time_ms(lambda: ops.decode_attention(qd, kc, vc, lens)),
               plain_ms=time_ms(lambda: ops.decode_attention(qd, kc, vc, lens, impl="ref")),
               library_ms=time_ms(lambda: sdpa_gqa(qdt, kct, vct)), bound_ms=b, bound_by=why)
    if host:
        row["host_us"] = host_us(lambda: ops.decode_attention(qd, kc, vc, lens))
    return row


# ---------------------------------------------------------------------------
# phase 3: the int8 quantize / dequantize kernels
# ---------------------------------------------------------------------------

def leaf_row_shapes(arch: str) -> list:
    """(rows, cols) of every parameter leaf of ``arch`` under
    ``comm_quant.leaf_rows``: the shapes its gradients are quantized at."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.comm_quant import leaf_rows
    from repro_torch.models import model as M
    from repro_torch.utils import tree_leaves

    out = []
    for t in tree_leaves(M.abstract_params(get_arch(arch))):     # meta tensors
        rs = tuple(leaf_rows(t).shape)
        if rs not in out:
            out.append(rs)
    return out


N_SPECIAL = 7


def special_rows(dev, cols: int) -> torch.Tensor:
    """The N_SPECIAL rows: three whose x / scale lands exactly on k + 0.5
    (scale 2**-7, so absmax 127/128 and every (k + 0.5) * 2**-7 is exact),
    an all-zero row, a row of +-absmax, a row holding one NaN and a row
    holding +Inf (and -Inf where it has room), among finite values."""
    s = 2.0 ** -7
    ks = np.arange(-127, 127)                       # k + 0.5 in [-126.5, 126.5]
    ties = np.resize((ks + 0.5) * s, (3, cols))
    ties[:, 0] = 127 * s                            # the row's absmax, q = 127
    ties[1] *= -1
    signs = np.where(np.arange(cols) % 2 == 0, 1.0, -1.0) * 3.25
    nonfinite = np.resize(ks * s, (2, cols))
    nonfinite[0, cols // 2] = np.nan
    nonfinite[1, -1], nonfinite[1, 0] = -np.inf, np.inf
    rows = np.concatenate([ties, np.zeros((1, cols)), signs[None], nonfinite], axis=0)
    return torch.from_numpy(rows.astype(np.float32)).to(dev)


def near_tie_rows(gen, dev, absmax: float, rows: int = 1024, cols: int = 2048) -> torch.Tensor:
    """fp32 rows whose x / scale lies within 0 to 4 ulps of k + 0.5, at
    scale = max(absmax, 1e-12) / 127 (fp32), absmax in column 0."""
    s = torch.tensor(max(absmax, 1e-12), dtype=torch.float32) / torch.tensor(127.0)
    k = torch.randint(-126, 126, (rows, cols), generator=gen, device=dev).float()
    x = (k + 0.5) * s.to(dev)
    off = torch.randint(-4, 5, (rows, cols), generator=gen, device=dev)
    inf = torch.full_like(x, float("inf"))
    for _ in range(4):
        x = torch.where(off != 0, torch.nextafter(x, torch.where(off > 0, inf, -inf)), x)
        off = off - off.sign()
    x[:, 0] = absmax
    return x


def same_nonfinite(a, b) -> bool:
    """a and b hold NaN at the same places and the same Inf at the same
    places."""
    a, b = a.float(), b.float()
    return (torch.equal(a.isnan(), b.isnan()) and torch.equal(a.isinf(), b.isinf())
            and torch.equal(a[a.isinf()], b[b.isinf()]))


def finite_err(a, b) -> float:
    """max abs error where b is finite."""
    f = b.float().isfinite()
    return max_err(a[f], b[f]) if bool(f.any()) else 0.0


def quant_checks(gen, dev) -> dict:
    """quantize_int8 / dequantize_int8 against their plain versions (and
    quantize against the wire codec's numpy mirror) -> the max abs errors at
    w_gate's shape (q as an integer difference).
    Tolerances: q equal element for element and scale within rtol 1e-6
    (``tests/test_kernels.py``'s hold on the Pallas kernel: the same IEEE
    division and round-half-to-even, so nothing may differ); dequantize
    equal to the plain fp32 product of the same q and scale; the round trip
    within the documented bound absmax_row / 254 plus fp32 rounding
    (absmax_row * 2**-22).  Rows holding NaN or Inf: scale NaN or Inf at the
    same rows as the plain version's, q 0 wherever the quotient is NaN (what
    the reference's cast gives, held on the CPU by the tests; the plain
    version's own cast of NaN is not compared), and the row dequantized to
    all NaN, so a non-finite gradient stays non-finite.  Each quantize is
    checked to take its branch: the vector path wherever D is a multiple
    of the 16-byte vector (every model leaf), the scalar loop elsewhere and
    on rows off 16 bytes; and on near-tie rows (:func:`near_tie_rows`)."""
    from repro_torch.kernels import comm_quant as cq
    from repro_torch.kernels import ops

    print("phase 3: int8 quantize / dequantize vs plain versions on the card", flush=True)
    shapes = leaf_row_shapes("granite-3-2b") + [
        rs for rs in leaf_row_shapes("mamba2-130m") if rs not in leaf_row_shapes("granite-3-2b")]
    errs = {}
    for rows, cols in shapes + [(N_SPECIAL, 24), (N_SPECIAL, 64), (N_SPECIAL, 257),
                                (N_SPECIAL, 8192)]:
        base = (torch.randn(rows, cols, generator=gen, device=dev)
                * torch.rand(rows, 1, generator=gen, device=dev) * 0.01)
        if rows >= N_SPECIAL:             # ties, zero, +-absmax, NaN and Inf rows
            base[:N_SPECIAL] = special_rows(dev, cols)
        for dt in (torch.float32, torch.bfloat16):
            x = base.to(dt)
            ops.reset_launch_counts()
            q, s = ops.quantize_int8(x)
            branch = "vec" if cols % (16 // x.element_size()) == 0 else "scalar"
            took = ops.branch_counts()[f"quantize_int8_{branch}"] == 1
            qr, sr = ops.quantize_int8(x, impl="ref")
            torch.cuda.synchronize()
            nan_q = (x.float() / sr).isnan()          # x / NaN and Inf / Inf
            eq = int((q.int() - qr.int()).masked_fill(nan_q, 0).abs().max().item())
            fs = sr.isfinite()
            es = ((s[fs] - sr[fs]).abs() / sr[fs].abs()).max().item()
            ok = (eq == 0 and es <= 1e-6 and same_nonfinite(s, sr) and not bool(q[nan_q].any())
                  and q.dtype == torch.int8 and tuple(s.shape) == (rows, 1) and took)
            # the wire codec's numpy mirror (host IEEE arithmetic) on up to
            # 4096 rows, the special rows among them
            n = min(rows, 4096)
            with np.errstate(invalid="ignore"):        # its cast of a NaN quotient
                qn, sn = cq.quantize_int8_np(x[:n].float().cpu().numpy())
            keep = ~nan_q[:n].cpu().numpy()
            ok = ok and np.array_equal(q[:n].cpu().numpy()[keep], qn[keep]) and np.array_equal(
                s[:n].cpu().numpy(), sn, equal_nan=True)
            deq = ops.dequantize_int8(q, s)
            deq_bf = ops.dequantize_int8(q, s, torch.bfloat16)
            want, want_bf = (ops.dequantize_int8(q, s, t, impl="ref")
                             for t in (torch.float32, torch.bfloat16))
            ed, ed_bf = finite_err(deq, want), finite_err(deq_bf, want_bf)
            ok = ok and same_nonfinite(deq, want) and same_nonfinite(deq_bf, want_bf)
            fin = x.float().isfinite().all(-1)
            xf, dq = x.float()[fin], deq[fin]
            absmax = xf.abs().amax(-1, keepdim=True)
            within = bool(((dq - xf).abs() <= absmax / 254 + absmax * 2.0 ** -22).all())
            all_nan = bool(deq[~fin].isnan().all())
            check(ok and ed == 0 and ed_bf == 0 and within and all_nan,
                  f"int8 codec ({rows}, {cols}) {dt} ({branch} branch): q max diff {eq}, "
                  f"scale rel err {es:.1e}, "
                  f"dequantize err {ed:.1e} (bf16 out {ed_bf:.1e}), round trip within "
                  f"absmax/254, {int((~fin).sum())} non-finite rows all NaN")
            if (rows, cols) == (81920, 8192) and dt == torch.float32:
                errs = {"quantize_int8": float(eq), "dequantize_int8": ed}
            del x, q, s, qr, sr, deq, deq_bf, want, want_bf, nan_q
        del base
    # rows off 16 bytes (a view past the first column of a contiguous
    # tensor) take the scalar loop
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(4096, 2049, generator=gen, device=dev).to(dt)[:, 1:]
        ops.reset_launch_counts()
        q, s = ops.quantize_int8(x)
        took = ops.branch_counts()["quantize_int8_scalar"] == 1
        qr, sr = ops.quantize_int8(x, impl="ref")
        check(took and torch.equal(q, qr) and torch.equal(s, sr),
              f"quantize_int8 on x[:, 1:] of a (4096, 2049) {dt} tensor (rows off 16 bytes): "
              f"scalar branch, q and scale equal")
    # x / scale within 0-4 ulps of k + 0.5, at scales that are not powers of
    # two (fp32: a bf16 value cannot lie that close), the reciprocal's tie
    # guard's cases; absmax near FLT_MAX and near the 1e-12 floor too
    for absmax in (3.7, 0.013, 5.9e-3, 3.0e38, 1.1e-12, 1e-13):
        x = near_tie_rows(gen, dev, absmax)
        ops.reset_launch_counts()
        q, s = ops.quantize_int8(x)
        took = ops.branch_counts()["quantize_int8_vec"] == 1
        qr, sr = ops.quantize_int8(x, impl="ref")
        check(took and torch.equal(q, qr) and torch.equal(s, sr),
              f"quantize_int8 on {tuple(x.shape)} near-tie rows, absmax {absmax:g}: vector branch, "
              f"q equal ({int((q != qr).sum())} differ), scale equal")
    ops.reset_launch_counts()
    # leaf helpers on a strided (non-contiguous) leaf and a rank-1 leaf
    g = torch.randn(8, 6, 40, generator=gen, device=dev).transpose(0, 1)
    for leaf in (g, g[0, :, 0]):
        q, s = cq.quantize_leaf(leaf)
        qr, sr = cq.quantize_leaf(leaf, impl="ref")
        back = cq.dequantize_leaf(q, s, leaf.shape, leaf.dtype)
        check(bool((q == qr).all()) and bool((s == sr).all()) and back.shape == leaf.shape,
              f"quantize_leaf/dequantize_leaf on a {tuple(leaf.shape)} "
              f"{'strided' if not leaf.is_contiguous() else 'contiguous'} leaf")
    torch.cuda.empty_cache()
    return errs


def quant_times(gen, dev, errs: dict) -> dict:
    """Kernel, plain and yardstick times at w_gate's shape (81,920 x 8192
    fp32, the main shape) and wq's (2,621,440 x 64, the narrow one)."""
    from repro_torch.kernels import comm_quant as cq

    rows = {}
    for shape in ((81920, 8192), (2621440, 64)):
        x = torch.randn(*shape, generator=gen, device=dev)
        q, s = cq.quantize_int8_cuda(x)
        n, N = x.numel(), shape[0]
        bq, wq = bound_ms(4 * n + n + 4 * N, 0, torch.float32)
        bd, wd = bound_ms(n + 4 * N + 4 * n, 0, torch.float32)
        r = {"quantize_int8": dict(
                 shape=f"x {shape} f32", ms=time_ms(lambda: cq.quantize_int8_cuda(x), iters=10),
                 plain_ms=time_ms(lambda: cq.quantize_int8_plain(x), iters=10),
                 library_ms=None, bound_ms=bq, bound_by=wq),
             "dequantize_int8": dict(
                 shape=f"q {shape} int8", ms=time_ms(lambda: cq.dequantize_int8_cuda(q, s), iters=10),
                 plain_ms=time_ms(lambda: cq.dequantize_int8_plain(q, s), iters=10),
                 library_ms=time_ms(lambda: torch.mul(q, s), iters=10), bound_ms=bd, bound_by=wd)}
        xb = x.to(torch.bfloat16)
        bf_ms = time_ms(lambda: cq.quantize_int8_cuda(xb), iters=10)
        for name, v in r.items():
            lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            print(f"  {name} [{v['shape']}]: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
                  f"yardstick {lib}, bound {v['bound_ms']:.5f} ms ({v['bound_by']})", flush=True)
        print(f"  quantize_int8 [x {shape} bf16]: kernel {bf_ms:.4f} ms", flush=True)
        if shape == (81920, 8192):
            rows = r
        del x, xb, q, s
        torch.cuda.empty_cache()
    for name, r in rows.items():
        r["max_abs_err"] = errs[name]
    exchange_times(gen, dev, rows)
    return rows


def exchange_times(gen, dev, rows: dict) -> None:
    """The int8 kernels over one compressed exchange of granite-3-2b's
    gradients (``compressed_psum``): quantize_int8 on each of the 11 leaves'
    rows in bf16 (the parameter dtype, read directly) and dequantize_int8
    back to fp32, and quantize_int8 on the same rows in fp32 (the pass
    ``ErrorFeedback`` runs on the corrected gradients), timed leaf by leaf
    and summed, beside the summed bounds.  Added to ``rows`` as each
    kernel's ``per_exchange`` (and the quantize's ``per_exchange_fp32``),
    with the quantize wrapper's host time per call at the (40, 2048) norm
    leaf."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import comm_quant as cq
    from repro_torch.kernels import ops
    from repro_torch.kernels.comm_quant import leaf_rows
    from repro_torch.models import model as M
    from repro_torch.utils import tree_leaves

    names = ("quantize_int8", "quantize_int8 fp32", "dequantize_int8")
    total = {k: {"launches": 0, "ms": 0.0, "bound_ms": 0.0} for k in names}
    for t in tree_leaves(M.abstract_params(get_arch("granite-3-2b"))):   # meta tensors
        n_rows, cols = leaf_rows(t).shape
        xf = torch.randn(n_rows, cols, generator=gen, device=dev)
        x = xf.to(torch.bfloat16)
        q, s = cq.quantize_int8_cuda(x)
        n = x.numel()
        for name, fn, moved in (("quantize_int8", lambda x=x: cq.quantize_int8_cuda(x),
                                 2 * n + n + 4 * n_rows),
                                ("quantize_int8 fp32", lambda xf=xf: cq.quantize_int8_cuda(xf),
                                 4 * n + n + 4 * n_rows),
                                ("dequantize_int8", lambda q=q, s=s: cq.dequantize_int8_cuda(q, s),
                                 n + 4 * n_rows + 4 * n)):
            total[name]["launches"] += 1
            total[name]["ms"] += time_ms(fn, iters=5)
            total[name]["bound_ms"] += bound_ms(moved, 0, torch.float32)[0]
        del x, xf, q, s
    torch.cuda.empty_cache()
    rows["quantize_int8"]["per_exchange"] = total["quantize_int8"]
    rows["quantize_int8"]["per_exchange_fp32"] = total["quantize_int8 fp32"]
    rows["dequantize_int8"]["per_exchange"] = total["dequantize_int8"]
    for name, t in total.items():
        what = "fp32 gradients" if "fp32" in name else "bf16 gradients"
        print(f"  {name.split()[0]} over one exchange ({t['launches']} leaves, {what}): kernel "
              f"{t['ms']:.5f} ms, bound {t['bound_ms']:.5f} ms (bytes)", flush=True)
    x = torch.randn(40, 2048, generator=gen, device=dev).to(torch.bfloat16)
    rows["quantize_int8"]["host_us"] = host_us(lambda: ops.quantize_int8(x))
    ops.reset_launch_counts()
    print(f"  quantize_int8 wrapper host {rows['quantize_int8']['host_us']:.1f} us/call "
          f"(x (40, 2048) bf16)", flush=True)


# ---------------------------------------------------------------------------
# phase 3b: gradients through the kernels' autograd.Functions
# ---------------------------------------------------------------------------

def grad_checks(gen, dev) -> None:
    """Each kernel's ``autograd.Function`` (forward: the kernel; backward:
    the plain version recomputed) against the plain path on the same inputs
    and upstream gradient, at the training path's shapes (B 8, S 256) and
    at a ragged length with head_dim 16.

    The forward output is held to the kernel's phase-3 tolerance (rmsnorm
    1e-5 plus 1e-2 * |want| in bf16; flash 2e-5 fp32, 2e-2 bf16; the SSD
    scan's y bound): this is what checks each kernel at these shapes.  The
    gradients only check the autograd plumbing: the backward computes the
    same plain function on the same inputs, so they may differ only by
    reduction order, within 1e-5 (fp32) or 1e-2 (bf16, one ulp) of each
    gradient's max magnitude; each must come back in its input's dtype and
    shape.  Each kernel must launch once per forward, and the output must
    carry a grad_fn."""
    from repro_torch.kernels import ops

    print("phase 3b: gradients through the kernels vs the plain path on the card", flush=True)
    bf16, f32 = torch.bfloat16, torch.float32

    def leaf(t):
        return t.detach().clone().requires_grad_()

    def compare(name, fn, inputs, dt, kernel):
        outs_k, outs_p = [], []
        for impl, outs in ((None, outs_k), ("ref", outs_p)):
            ins = [leaf(t) for t in inputs]
            ops.reset_launch_counts()
            y = fn(*ins, impl=impl)
            y = y[0] if isinstance(y, tuple) else y
            launched = ops.launch_counts()[kernel]
            gy = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(7),
                             device=dev).to(y.dtype)
            gs = torch.autograd.grad(y, ins, gy)
            outs.append((y, launched, gs))
        (yk, nk, gk), (yp, np_, gp) = outs_k[0], outs_p[0]
        ey, yk_f, yp_f = max_err(yk, yp), yk.detach().float(), yp.detach().float()
        rel_y = 1e-2 if dt == bf16 else 0.0
        if kernel == "rmsnorm":
            fwd_ok = bool(((yk_f - yp_f).abs() <= 1e-5 + rel_y * yp_f.abs()).all())
        elif kernel == "flash_attention":
            fwd_ok = ey <= (2e-2 if dt == bf16 else 2e-5)
        else:
            tol_y = 2e-4 * (yp_f.abs().max().item() + 1.0)
            fwd_ok = bool(((yk_f - yp_f).abs() <= tol_y + rel_y * yp_f.abs()).all())
        tol = 1e-2 if dt == bf16 else 1e-5
        errs = [max_err(a, b) / (b.float().abs().max().item() + 1e-30) for a, b in zip(gk, gp)]
        ok = (fwd_ok and yk.dtype == yp.dtype and nk == 1 and np_ == 0 and yk.grad_fn is not None
              and all(a.dtype == t.dtype and a.shape == t.shape for a, t in zip(gk, inputs))
              and max(errs) <= tol)
        check(ok, f"{name} {dt}: forward max abs err {ey:.3e}; grads through the kernel vs "
                  f"plain, rel max err {', '.join(f'{e:.1e}' for e in errs)} (tol {tol:g})")

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # the scale in fp32, as the model's norm parameters are
    for shape, dt in [((8, 256, 2048), bf16), ((8, 256, 2048), f32), ((3, 37, 16), f32)]:
        compare(f"rmsnorm x {shape}", lambda x, s, impl: ops.rmsnorm(x, s, impl=impl),
                [randn(*shape, dtype=dt), randn(shape[-1])], dt, "rmsnorm")
    for (B, H, K, S, D), dt in [((8, 32, 8, 256, 64), bf16), ((8, 32, 8, 256, 64), f32),
                                ((2, 4, 2, 37, 16), f32), ((2, 4, 2, 37, 16), bf16)]:
        compare(f"flash_attention B{B} H{H} K{K} S{S} D{D}",
                lambda q, k, v, impl: ops.flash_attention(q, k, v, impl=impl),
                [randn(B, S, H, D, dtype=dt), randn(B, S, K, D, dtype=dt),
                 randn(B, S, K, D, dtype=dt)], dt, "flash_attention")
    for shape, dt in [(SSD_MAIN, bf16), (SSD_MAIN, f32), ((2, 37, 8, 16, 1, 16, 8), f32)]:
        B, S, H, P, G, N, L = shape
        x, dtt, A, Bm, Cm = ssd_inputs(gen, dev, B, S, H, P, G, N, dt)
        big = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], dim=-1)
        hp, gn = H * P, G * N

        def scan(big, dtt, A, impl, L=L, H=H, P=P, G=G, N=N, hp=hp, gn=gn):
            # x, B and C as strided views of one tensor, as the model passes
            # them; the loss uses y only, so the final state's grad is None
            return ops.ssd_scan(big[..., :hp].unflatten(-1, (H, P)), dtt, A,
                                big[..., hp:hp + gn].unflatten(-1, (G, N)),
                                big[..., hp + gn:].unflatten(-1, (G, N)), chunk=L, impl=impl)
        compare(f"ssd_scan B{B} S{S} H{H} P{P} N{N} L{L}", scan, [big, dtt, A], dt, "ssd_scan")
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# phase 4: small model on the card against the plain versions on the CPU
# ---------------------------------------------------------------------------

def small_model_check(phase: str, arch: str, seed: int, dev) -> None:
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map

    print(f"phase {phase}: reduced {arch} (float32), kernels on the card vs plain on the CPU",
          flush=True)
    cfg = reduced(get_arch(arch))
    p_cpu = M.init_params(cfg, seed, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 13)))
    with torch.inference_mode():
        h_cpu = M.forward_hidden(cfg, p_cpu, {"tokens": toks})[0]
        h_gpu = M.forward_hidden(cfg, p_gpu, {"tokens": toks.to(dev)})[0]
        check(max_err(h_gpu.cpu(), h_cpu) <= 1e-4,
              f"forward_hidden card vs CPU: max abs err {max_err(h_gpu.cpu(), h_cpu):.3e} (atol 1e-4)")
        lg_c, c_cpu = M.prefill(cfg, p_cpu, {"tokens": toks[:, :9]}, 16)
        lg_g, c_gpu = M.prefill(cfg, p_gpu, {"tokens": toks[:, :9].to(dev)}, 16)
        steps = [(lg_g, lg_c)]
        for i in range(9, 13):
            b = {"tokens": toks[:, i:i + 1], "pos": i}
            lc, c_cpu = M.decode_step(cfg, p_cpu, c_cpu, b)
            lg, c_gpu = M.decode_step(cfg, p_gpu, c_gpu, {**b, "tokens": b["tokens"].to(dev)})
            steps.append((lg, lc))
        e = max(max_err(g[..., :cfg.vocab_size].cpu(), c[..., :cfg.vocab_size]) for g, c in steps)
        check(e <= 1e-4, f"prefill + 4 decodes card vs CPU: max abs err {e:.3e} (atol 1e-4)")
        full = M.logits_from_hidden(cfg, p_gpu, h_gpu)[:, 8:13, :cfg.vocab_size].cpu()
        inc = torch.cat([g[..., :cfg.vocab_size].cpu() for g, _ in steps], dim=1)
        check(max_err(inc, full) <= 2e-3,
              f"prefill + decode == forward on the card: max abs err {max_err(inc, full):.3e} (atol 2e-3)")


def small_train_check(arch: str, seed: int, dev) -> None:
    """Three train steps of reduced ``arch`` (float32) on the card through
    the kernels (backward: the plain versions recomputed) and on the CPU
    through the plain versions, from the same params and batches.
    Tolerances: losses within 1e-4 relative (fp32 sums in another order);
    params within 1e-5 on average, and every element within 2 * lr * 3
    steps, since Adam moves each parameter by about lr * sign(g) and a
    near-zero gradient's sign may differ between the card and the CPU."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils import tree_leaves, tree_map

    print(f"phase 4c: reduced {arch} (float32), 3 train steps on the card vs the CPU", flush=True)
    cfg = reduced(get_arch(arch))
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const")
    data = make_pipeline(cfg.vocab_size, 16, 4, seed=seed)
    p_cpu = M.init_params(cfg, seed, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev, copy=True), p_cpu)   # updated in place: own copies
    o_cpu, o_gpu = init_opt_state(ocfg, p_cpu), init_opt_state(ocfg, p_gpu)
    step = make_train_step(cfg, ocfg)
    for i in range(1, 4):                      # step 0 has lr 0 under warmup
        _, _, m_cpu = step(p_cpu, o_cpu, data.batch(i), i)
        _, _, m_gpu = step(p_gpu, o_gpu, data.batch(i), i)
        lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
        check(abs(lc - lg) <= 1e-4 * abs(lc), f"step {i}: loss card {lg:.6f} vs CPU {lc:.6f}")
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in
                       zip(tree_leaves(p_gpu), tree_leaves(p_cpu))])
    check(diffs.mean().item() <= 1e-5 and diffs.max().item() <= 2 * ocfg.lr * 3,
          f"params after 3 steps: mean abs diff {diffs.mean().item():.2e} (tol 1e-5), "
          f"max {diffs.max().item():.2e} (tol {2 * ocfg.lr * 3:g})")


# ---------------------------------------------------------------------------
# phases 5 and 6: the main paths at full width
# ---------------------------------------------------------------------------

def all_counts() -> dict:
    """Every kernel's launch count, and the SSD scan's and the quantize's by
    branch."""
    from repro_torch.kernels import ops
    return {**ops.launch_counts(), **ops.branch_counts()}


def expected_counts(cfg) -> dict:
    """Kernel launches of one prefill, N_DECODE decodes and one score: an
    rmsnorm per mixer norm, per FFN norm (dense) or gated norm (SSM), and
    the final norm; attention or the SSD scan once per layer per prefill
    or score, the scan on the tensor cores (bf16, P 64, N 128, chunk 256);
    decode attention once per layer per step (an SSM decode step is one
    plain ``ssd_step``)."""
    L, n_fwd = cfg.num_layers, 1 + N_DECODE + 1
    quant = {"quantize_int8": 0, "dequantize_int8": 0,      # serving quantizes on the host
             "quantize_int8_vec": 0, "quantize_int8_scalar": 0}
    if cfg.family == "ssm":
        return {"rmsnorm": (2 * L + 1) * n_fwd, "flash_attention": 0, "decode_attention": 0,
                "ssd_scan": 2 * L, **quant, "ssd_scan_tc": 2 * L, "ssd_scan_simt": 0}
    return {"rmsnorm": (2 * L + 1) * n_fwd, "flash_attention": 2 * L,
            "decode_attention": L * N_DECODE, "ssd_scan": 0, **quant,
            "ssd_scan_tc": 0, "ssd_scan_simt": 0}


def main_path(phase: str, arch: str, seq: int, seed: int, dev,
              profile: bool = False) -> tuple[dict, dict]:
    """-> (launch counts, outputs: the prefill and decode logits and the
    score loss, which phase 9 holds the facade's calls to)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.cache import model_fingerprint
    from repro_torch.core.executor import DestinationExecutor, HostRuntime
    from repro_torch.core.library import make_model_library
    from repro_torch.core.transport import TCPChannel, TCPServer
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.utils import to_numpy_tree, tree_leaves

    cfg = get_arch(arch)
    L = cfg.num_layers
    mixer = (f"{cfg.ssm.n_heads(cfg.d_model)} SSD heads of {cfg.ssm.head_dim}, d_state "
             f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}" if cfg.family == "ssm"
             else f"{cfg.num_heads}/{cfg.num_kv_heads} heads")
    print(f"phase {phase}: main path, {cfg.name} at full width ({L} layers, d_model "
          f"{cfg.d_model}, {mixer}, vocab {cfg.padded_vocab}), B {MAIN_B} S {seq}, "
          f"served over TCP", flush=True)
    dest = DestinationExecutor({"lm": make_model_library(cfg, CACHE_LEN, device=dev)},
                               name="h100", device=dev)
    server = TCPServer(dest.handle).start()
    host = HostRuntime(TCPChannel.connect("127.0.0.1", server.port), timeout=900.0)
    try:
        check(host.ping()["ok"], "ping")
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed, device=dev)
        fp = model_fingerprint(cfg, params)
        params_host = to_numpy_tree(params)
        del params
        torch.cuda.empty_cache()
        n_params = sum(a.size for a in tree_leaves(params_host))
        print(f"  weights: {n_params / 1e9:.3f} B params, made on the card and brought to "
              f"the host in {time.perf_counter() - t0:.2f} s", flush=True)
        sent0 = host.bytes_sent
        t0 = time.perf_counter()
        transfer_s = host.put_model(fp, "lm", params_host)
        wall = time.perf_counter() - t0
        print(f"  put_model: {(host.bytes_sent - sent0) / 1e9:.3f} GB on the wire, "
              f"{wall:.2f} s wall ({transfer_s:.2f} s at the destination to the device)",
              flush=True)
        del params_host

        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (MAIN_B, seq)).astype(np.int32)
        calls = []

        def call(fn, args):
            t = time.perf_counter()
            out = host.run(fp, fn, args)
            w = time.perf_counter() - t
            calls.append((fn, host.last_compute_s, w - host.last_compute_s))
            return out

        ops.reset_launch_counts()
        prefill_logits = np.array(call("prefill", {"tokens": tokens})["logits"])
        logits = [prefill_logits]
        nxt = prefill_logits[:, -1].argmax(-1).astype(np.int32)[:, None]
        for _ in range(N_DECODE):
            lg = np.array(call("decode", {"tokens": nxt})["logits"])
            logits.append(lg)
            nxt = lg[:, -1].argmax(-1).astype(np.int32)[:, None]
        targets = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        loss = float(np.asarray(call("score", {"tokens": tokens, "targets": targets})["loss"]))
        counts = all_counts()
        for fn, comp, wire in calls:
            print(f"  {fn:8s} compute_s {comp:.5f}  wire_s {wire:.5f}", flush=True)
        print(f"  launches on the main path: {counts}", flush=True)

        want = expected_counts(cfg)
        check(counts == want, f"launch counts match the model's structure: {want}")
        check(all(np.isfinite(lg[..., :cfg.vocab_size]).all() for lg in logits)
              and all(lg.shape == (MAIN_B, 1, cfg.padded_vocab) for lg in logits),
              f"logits finite, shape {(MAIN_B, 1, cfg.padded_vocab)}")
        check(np.isfinite(loss), f"score loss finite ({loss:.4f})")

        entry = dest.cache.get(fp)
        with torch.inference_mode(), ops.force_impl("ref"):
            plain = M.prefill(cfg, entry["params"], {"tokens": torch.from_numpy(tokens).to(dev)},
                              CACHE_LEN)[0][..., :cfg.vocab_size].float().cpu()
        got = torch.from_numpy(prefill_logits[..., :cfg.vocab_size])
        e = max_err(got, plain)
        scale = plain.abs().max().item()
        check(e <= 0.05 * scale,
              f"prefill logits, kernels vs plain versions on the card: max abs err {e:.4f} "
              f"({100 * e / scale:.2f}% of max |logit| {scale:.3f}; bf16 tolerance 5%)")
        if profile:
            lib = dest.libraries["lm"]
            toks = torch.from_numpy(tokens).to(dev)
            profile_call(f"{arch} prefill", lambda: lib["prefill"](
                entry["params"], entry["state"], {"tokens": toks}))
            profile_call(f"{arch} decode", lambda: lib["decode"](
                entry["params"], entry["state"], {"tokens": toks[:, :1]}))
        return counts, {"logits": logits, "loss": loss}
    finally:
        host.close()
        server.stop()
        dest.shutdown()


# ---------------------------------------------------------------------------
# phase 7: the training path at full width
# ---------------------------------------------------------------------------


def expected_train_counts(cfg) -> dict:
    """Kernel launches of one training step of a dense model under remat:
    each block's two rmsnorms and its attention run in the forward and
    again when backward recomputes the block; the final norm runs once
    outside the blocks; the backward itself launches nothing (it
    recomputes the plain versions)."""
    L = cfg.num_layers
    return {"rmsnorm": 2 * 2 * L + 1, "flash_attention": 2 * L, "decode_attention": 0,
            "ssd_scan": 0, "quantize_int8": 0, "dequantize_int8": 0, "ssd_scan_tc": 0,
            "ssd_scan_simt": 0, "quantize_int8_vec": 0, "quantize_int8_scalar": 0}


def row_bound(g):
    """Per-row bound of the int8 round trip, shaped like ``leaf_rows(g)``:
    absmax_row / 254, plus the rounding of the result to ``g``'s dtype (half
    a bf16 ulp, at most absmax_row * 2**-8) or fp32 (absmax_row * 2**-22)."""
    from repro_torch.kernels.comm_quant import leaf_rows

    absmax = leaf_rows(g).float().abs().amax(-1, keepdim=True)
    return absmax / 254 + absmax * (2.0 ** -8 if g.dtype == torch.bfloat16 else 2.0 ** -22)


def train_path(seed: int, dev, profile: bool = False) -> dict:
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.collectives import (ReduceGroups, compressed_grad_allreduce,
                                                     dcn_wire_bytes)
    from repro_torch.kernels import ops
    from repro_torch.kernels.comm_quant import leaf_rows, quantize_leaf
    from repro_torch.optim.compression import ErrorFeedback, compress_tree, decompress_tree
    from repro_torch.optim.optimizer import OptimizerConfig, apply_updates
    from repro_torch.train.steps import loss_and_grads
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils import tree_leaves, tree_leaves_with_path, keystr

    cfg = get_arch("granite-3-2b")
    L = cfg.num_layers
    print(f"phase 7: training path, {cfg.name} at full width ({L} layers, d_model {cfg.d_model}, "
          f"{cfg.param_dtype}, remat={cfg.remat}, {cfg.optimizer}), B {TRAIN_B} S {TRAIN_S}",
          flush=True)
    check(cfg.remat and cfg.param_dtype == "bfloat16" and cfg.optimizer == "adamw",
          "granite-3-2b as registered: bf16, remat, adamw")
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=3e-4, warmup_steps=2, total_steps=100)
    data = make_pipeline(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory allocated before phase 7: {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    peaks = {}
    counts = {}

    # 7.1: Trainer steps, launch counts per step
    trainer = Trainer(cfg, ocfg, data, seed=seed, device=dev)
    ops.reset_launch_counts()
    rep = trainer.run(TRAIN_STEPS)
    counts["trainer"] = all_counts()
    want = {k: v * TRAIN_STEPS for k, v in expected_train_counts(cfg).items()}
    print(f"  Trainer.run({TRAIN_STEPS}): losses {[round(x, 5) for x in rep.losses]}, "
          f"wall {rep.wall_s:.2f} s (init included); launches {counts['trainer']}", flush=True)
    check(len(rep.losses) == TRAIN_STEPS and all(np.isfinite(rep.losses)),
          f"{TRAIN_STEPS} finite losses")
    check(counts["trainer"] == want, f"launch counts match the structure per step x "
                                     f"{TRAIN_STEPS}: {want}")
    params, opt = trainer._final["params"], trainer._final["opt"]
    del trainer
    step_fn = make_step_timer(cfg, ocfg)
    walls = [step_fn(params, opt, data.batch(TRAIN_STEPS + i), TRAIN_STEPS + i)
             for i in range(2)]
    print(f"  train step wall (host clock, synchronized): "
          f"{', '.join(f'{w * 1e3:.1f} ms' for w in walls)}", flush=True)
    if profile:
        batch = data.batch(TRAIN_STEPS + 2)
        profile_call("granite-3-2b train step",
                     lambda: step_fn(params, opt, batch, TRAIN_STEPS + 2))
    peaks["train steps"] = peak_and_reset()

    # 7.2: one data-parallel step through the compressed all-reduce
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(TRAIN_STEPS + 3).items()}
    ops.reset_launch_counts()
    loss, _, grads = loss_and_grads(cfg, params, batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as store_dir:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1)
        try:
            groups = ReduceGroups(fast=None, slow=dist.group.WORLD)
            compressed_grad_allreduce(groups, {"warm": torch.ones(4, 4, device=dev)})
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reduced_g = compressed_grad_allreduce(groups, grads)
            torch.cuda.synchronize()
            exchange_s = time.perf_counter() - t0
            counts["exchange"] = all_counts()
        finally:
            dist.destroy_process_group()
    n_leaves = len(tree_leaves(grads))
    wire_c, wire_f = dcn_wire_bytes(grads, compressed=True), dcn_wire_bytes(grads, compressed=False)
    wire_rows = sum(leaf_rows(g).numel() + 4 * leaf_rows(g).shape[0] for g in tree_leaves(grads))
    print(f"  compressed exchange: {exchange_s * 1e3:.1f} ms for {n_leaves} leaves; int8 wire "
          f"{wire_rows / 1e9:.4f} GB (dcn_wire_bytes {wire_c / 1e9:.4f} GB) vs fp32 "
          f"{wire_f / 1e9:.4f} GB; launches {counts['exchange']}", flush=True)
    check(counts["exchange"]["quantize_int8"] == n_leaves == 11
          and counts["exchange"]["dequantize_int8"] == n_leaves
          and counts["exchange"]["quantize_int8_vec"] == n_leaves,
          f"the exchange quantizes and dequantizes each of the {n_leaves} leaves once, every "
          f"quantize on the vector branch")
    worst = 0.0
    for (path, g), r in zip(tree_leaves_with_path(grads), tree_leaves(reduced_g)):
        err = (leaf_rows(r).float() - leaf_rows(g).float()).abs()
        ok = bool((err <= row_bound(g)).all()) and r.dtype == g.dtype and r.shape == g.shape
        check(ok, f"reduced {keystr(path)} {tuple(g.shape)} within its per-row bound of the "
                  f"raw gradient (max abs err {err.max().item():.3e})")
        worst = max(worst, err.max().item())
    wg = grads["blocks"]["layers"][0]["mlp"]["w_gate"]
    q, s = quantize_leaf(wg)
    qr, sr = ops.quantize_int8(leaf_rows(wg), impl="ref")
    check(bool((q == qr).all()) and bool((s == sr).all()),
          f"q of w_gate's gradient {tuple(wg.shape)} (bf16, read directly) equals the plain version's")
    del q, s, qr, sr
    _, _, om = apply_updates(ocfg, reduced_g, opt, params, TRAIN_STEPS + 3)
    check(np.isfinite(float(loss)) and np.isfinite(float(om["grad_norm"]))
          and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)),
          f"data-parallel step: loss {float(loss):.5f}, grad_norm {float(om['grad_norm']):.4f}, "
          f"params finite after apply_updates")
    del reduced_g
    peaks["data-parallel step and its checks"] = peak_and_reset()

    # 7.3: error feedback and compress_tree / decompress_tree
    ops.reset_launch_counts()
    residual = ErrorFeedback.init(grads)
    out, residual = ErrorFeedback.compress(grads, residual)
    ef = all_counts()
    del out, residual
    ctree, wire = compress_tree(grads)
    back = decompress_tree(ctree)
    counts["compress"] = all_counts()
    check(ef["quantize_int8"] == ef["dequantize_int8"] == n_leaves
          and counts["compress"]["quantize_int8"] == counts["compress"]["dequantize_int8"]
          == counts["compress"]["quantize_int8_vec"] == 2 * n_leaves,
          f"one quantize and one dequantize per leaf per pass (ErrorFeedback, then "
          f"compress/decompress), every quantize on the vector branch: {counts['compress']}")
    check(wire == wire_rows, f"compress_tree wire bytes {wire} == sum(rows*cols + 4*rows)")
    within = all(bool(((leaf_rows(b).float() - leaf_rows(g).float()).abs() <= row_bound(g)).all())
                 for b, g in zip(tree_leaves(back), tree_leaves(grads)))
    check(within, "decompress_tree(compress_tree(grads)) within the per-row bound")
    peaks["ErrorFeedback, compress/decompress and checks"] = peak_and_reset()
    del ctree, back, grads, params, opt
    print(f"  peak device memory (torch.cuda.max_memory_allocated): "
          f"{', '.join(f'{k} {v / 1e9:.2f} GB' for k, v in peaks.items())}", flush=True)
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts.values()) for k in counts["trainer"]}


# ---------------------------------------------------------------------------
# phase 8: the paper's loop, OpenPose-lite intercepted on the host
# ---------------------------------------------------------------------------

def openpose_application(net, params, frames) -> list:
    """An unmodified application, written like the JAX package's
    ``examples/openpose_pipeline.py`` loop: detect and render poses frame by
    frame through the library's module functions -> [(beliefs, rendered)]."""
    from repro_torch.models import openpose

    outputs = []
    for i in range(frames.shape[0]):
        frame = frames[i:i + 1]
        beliefs = openpose.op_forward(net, params, {"frames": frame})
        if isinstance(beliefs, dict):           # (transparent to the app)
            beliefs = beliefs["beliefs"]
        beliefs = torch.from_numpy(np.array(beliefs))
        outputs.append((beliefs, openpose.render_pose(frame, beliefs)))
    return outputs


def openpose_path(seed: int, dev, profile: bool = False) -> dict:
    from repro_torch.configs.avec_openpose import WORKLOAD
    from repro_torch.core.executor import DestinationExecutor, PipelinedHostRuntime
    from repro_torch.core.interception import ArgSpec, AvecSession, InterceptionLibrary
    from repro_torch.core.library import make_openpose_library
    from repro_torch.core.transport import TCPChannel, TCPServer
    from repro_torch.kernels import ops
    from repro_torch.models import openpose
    from repro_torch.models.params import from_numpy_tree, init_params
    from repro_torch.utils import to_numpy_tree

    net = openpose.OpenPoseLite()
    H, W = WORKLOAD.frame_h, WORKLOAD.frame_w
    B_big = WORKLOAD.image_batches[0]
    print(f"phase 8: the paper's loop, OpenPose-lite ({net.channels} channels, {net.stages} "
          f"stages, {net.n_parts + net.n_pafs} belief maps) at {H}x{W}, intercepted on the host "
          f"and served through PipelinedHostRuntime (window {OP_WINDOW}) over TCP", flush=True)
    dest = DestinationExecutor({"openpose": make_openpose_library(net, device=dev)},
                               name="h100", device=dev)
    server = TCPServer(dest.handle).start()
    rt = PipelinedHostRuntime(TCPChannel.connect("127.0.0.1", server.port),
                              max_in_flight=OP_WINDOW, timeout=900.0)
    try:
        params_host = to_numpy_tree(init_params(openpose.op_param_specs(net), seed,
                                                torch.float32, device=dev))
        sess = AvecSession(net, params_host, rt, "openpose")
        check(not sess.ensure_model() and sess.model_transfer_s is not None,
              f"ensure_model sent the weights once ({sess.model_transfer_s:.4f} s)")
        entry, lib = dest.cache.get(sess.fp), dest.libraries["openpose"]

        def own_forward(frames):
            """The destination library's own call, on the card."""
            return lib["forward"](entry["params"], entry["state"],
                                  {"frames": frames.to(dev)})["beliefs"].cpu()

        frames = openpose.make_frames(OP_FRAMES, H, W, seed)
        # warm, outside the session's profiler: cuDNN makes a handle per
        # thread (the server's first call took 43 ms), the allocator grows
        rt.run(sess.fp, "forward", {"frames": frames[:1]})

        # 8.1: the unmodified loop, op_forward intercepted, render_pose local
        orig = openpose.op_forward
        disp = sess.make_argspec_dispatcher({"op_forward": ("forward", ArgSpec(position=2))})
        ops.reset_launch_counts()
        with InterceptionLibrary(openpose, ["op_forward", "render_pose"], disp):
            outputs = openpose_application(net, params_host, frames)
        per = sess.profiler.per_cycle()
        check(len(sess.profiler.cycles) == OP_FRAMES,
              f"the profiler holds {OP_FRAMES} offloaded cycles")
        check(openpose.op_forward is orig, "op_forward is the original function after uninstall")
        check(all(tuple(r.shape) == (1, H, W, 3) for _, r in outputs),
              f"rendered frames have the input's shape {(1, H, W, 3)}")
        shape = (1, -(-H // 8), -(-W // 8), net.n_parts + net.n_pafs)
        check(all(tuple(b.shape) == shape and torch.isfinite(b).all() for b, _ in outputs),
              f"beliefs finite, shape {shape}")
        check(all(torch.equal(b, own_forward(frames[i:i + 1])) for i, (b, _) in enumerate(outputs)),
              "intercepted beliefs bit-identical to the destination library's own forward")
        cpu = openpose.op_forward(net, from_numpy_tree(params_host, "cpu"), frames[:1])
        e, scale = max_err(outputs[0][0], cpu), cpu.abs().max().item()
        check(e <= 1e-4 * scale, f"beliefs vs the CPU path: max abs err {e:.3e} "
              f"(tolerance 1e-4 x max|belief| {scale:.4f})")
        print(f"  per frame (mean of {OP_FRAMES}): compute_s {per['gpu_s']:.6f}  wire_s "
              f"{per['communication_s']:.6f}  render (host) {sess.profiler.other_s / OP_FRAMES:.6f} s; "
              f"{per['bytes_per_cycle'] / 1e6:.4f} MB on the wire per cycle "
              f"(Eq. 1: {WORKLOAD.data_transfer_bytes() / 1e6:.4f} MB); each cycle (compute_s, "
              f"wire_s): {[(c.gpu_s, c.comm_s) for c in sess.profiler.cycles]}", flush=True)

        # 8.2: the same stream synchronous and pipelined, min of 2 passes each
        stream = list(openpose.make_frames(OP_STREAM, H, W, seed + 1).split(1))

        def sync_pass():
            n0 = len(sess.profiler.cycles)
            t0 = time.perf_counter()
            outs = [np.array(sess.call("forward", {"frames": f})["beliefs"]) for f in stream]
            wall = time.perf_counter() - t0
            sync_cycles[:] = sess.profiler.cycles[n0:]
            return wall, outs

        def pipe_pass():
            t0 = time.perf_counter()
            futs = [sess.call_async("forward", {"frames": f}) for f in stream]
            outs = [np.array(f.result()["beliefs"]) for f in futs]
            return time.perf_counter() - t0, outs

        walls = {"sync": [], "pipelined": []}
        results, sync_cycles = {}, []
        for _ in range(2):
            for name, fn in (("sync", sync_pass), ("pipelined", pipe_pass)):
                wall, results[name] = fn()
                walls[name].append(wall)
        check(all(np.array_equal(a, b) for a, b in zip(results["sync"], results["pipelined"])),
              f"{OP_STREAM} frames: pipelined beliefs bit-identical to synchronous")
        stats = rt.stats()
        print(f"  {OP_STREAM} frames: synchronous {min(walls['sync']):.6f} s, pipelined "
              f"{min(walls['pipelined']):.6f} s (min of 2; passes {walls}), window "
              f"{rt.window}/{rt.max_in_flight}", flush=True)
        print(f"  the last synchronous pass, per frame: median compute_s "
              f"{float(np.median([c.gpu_s for c in sync_cycles])):.6f}, median wire_s "
              f"{float(np.median([c.comm_s for c in sync_cycles])):.6f}", flush=True)
        print(f"  rt.stats(): {json.dumps(stats)}", flush=True)

        # 8.3: the paper's smallest image batch, one call cold (the allocator
        # grows) and one warm
        big = openpose.make_frames(B_big, H, W, seed + 2)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = np.array(sess.call("forward", {"frames": big})["beliefs"])
        peak = torch.cuda.max_memory_allocated()
        beliefs = torch.from_numpy(np.array(sess.call("forward", {"frames": big})["beliefs"]))
        cold, cyc = sess.profiler.cycles[-2:]
        check(np.array_equal(first, beliefs.numpy()), f"B {B_big}: two calls bit-identical")
        del first
        flops = openpose.op_flops(net, H, W) * B_big
        check(tuple(beliefs.shape) == (B_big,) + shape[1:] and torch.isfinite(beliefs).all(),
              f"B {B_big}: beliefs finite, shape {(B_big,) + shape[1:]}")
        e1 = max_err(beliefs[:1], own_forward(big[:1]))
        check(e1 <= 1e-4 * beliefs[:1].abs().max().item(),
              f"B {B_big}: frame 0 vs its B 1 forward on the card, max abs err {e1:.3e} "
              f"(tolerance 1e-4 x max|belief|)")
        t_bound, by = bound_ms(big.numel() * 4 + beliefs.numel() * 4, flops, torch.float32)
        print(f"  B {B_big}: compute_s {cyc.gpu_s:.6f}  wire_s {cyc.comm_s:.6f} (the first "
              f"call: {cold.gpu_s:.6f}, {cold.comm_s:.6f})  "
              f"{cyc.bytes_sent / 1e6:.3f} MB out, {cyc.bytes_received / 1e6:.3f} MB back, "
              f"{flops / 1e9:.3f} GFLOP ({flops / cyc.gpu_s / 1e12:.2f} TFLOP/s over compute_s; "
              f"bound {t_bound:.4f} ms by {by}), peak device memory {peak / 1e9:.3f} GB "
              f"({base / 1e9:.3f} GB allocated before the call)",
              flush=True)
        counts = all_counts()
        print(f"  launches on the main path: {counts}", flush=True)
        check(not any(counts.values()), "phase 8 launches none of the six kernels "
              "(its convolutions are cuDNN's)")
        if profile:
            f1, fb = frames[:1].to(dev), big.to(dev)
            profile_call("openpose forward B 1", lambda: lib["forward"](
                entry["params"], entry["state"], {"frames": f1}))
            profile_call(f"openpose forward B {B_big}", lambda: lib["forward"](
                entry["params"], entry["state"], {"frames": fb}))
            del f1, fb
        return counts
    finally:
        rt.close()
        server.stop()
        dest.shutdown()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the front door — avec.connect, SHM, sharding, the engine, launch/serve
# ---------------------------------------------------------------------------

def add_counts(total: dict, counts: dict) -> dict:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    return total


def host_float(x) -> torch.Tensor:
    """A host leaf (bf16 included) as an fp32 CPU tensor."""
    from repro_torch.utils import to_tensor
    return to_tensor(x, "cpu").float()


def facade_calls(sess, tokens, n_decode: int) -> tuple[list, float, list]:
    """Phase 5's calls through a facade session: prefill, ``n_decode``
    greedy decodes, score -> (logits, loss, [(fn, compute_s, wire_s)])."""
    cycles = []

    def call(fn, args):
        out = sess.call(fn, args)
        c = sess.profiler.cycles[-1]
        cycles.append((fn, c.gpu_s, c.comm_s))
        return out

    logits = [np.array(call("prefill", {"tokens": tokens})["logits"])]
    for _ in range(n_decode):
        nxt = logits[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
        logits.append(np.array(call("decode", {"tokens": nxt})["logits"]))
    targets = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    loss = float(np.asarray(call("score", {"tokens": tokens, "targets": targets})["loss"]))
    return logits, loss, cycles


def put_model_line(sess, label: str) -> str:
    """Send the session's weights once (timed) -> a printable line with the
    bytes on the wire and, over SHM, the ring's spill count."""
    rt = sess.runtime
    sent0 = rt.bytes_sent
    stats0 = rt.channel.stats() if hasattr(rt.channel, "stats") else None
    t0 = time.perf_counter()
    check(not sess.ensure_model(), f"{label}: ensure_model sent the weights")
    wall = time.perf_counter() - t0
    line = (f"  put_model to {label} over {type(rt.channel).__name__}: "
            f"{(rt.bytes_sent - sent0) / 1e9:.3f} GB on the wire, {wall:.3f} s wall")
    if stats0 is not None:
        stats = rt.channel.stats()
        line += (f"; ring {stats['ring_bytes'] / 2**20:.0f} MiB, spills sent "
                 f"{stats['spills_sent'] - stats0['spills_sent']}, frames through the ring "
                 f"{stats['frames_sent'] - stats0['frames_sent']}")
    return line


def engine_checks(cfg, params, reqs, dev) -> int:
    """Each generated token against one teacher-forced forward of prompt +
    generated[:-1] through the plain versions: the token's plain logit is
    within the bf16 tolerance (5 % of the position's max |logit|) of the
    plain argmax's.  -> the count of near-ties (token != plain argmax)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    V = cfg.vocab_size
    near = worst = 0
    with torch.inference_mode(), ops.force_impl("ref"):
        for r in reqs:
            seq = torch.tensor([r.prompt + r.generated[:-1]], dtype=torch.int32, device=dev)
            h, _ = M.forward_hidden(cfg, params, {"tokens": seq})
            lg = M.logits_from_hidden(cfg, params, h[:, len(r.prompt) - 1:])[0, :, :V].float()
            mine = lg.gather(-1, torch.tensor(r.generated, device=dev)[:, None])[:, 0]
            gap = lg.amax(-1) - mine
            tol = 0.05 * lg.abs().amax(-1)
            check(bool((gap <= tol).all()),
                  f"request {r.rid} (prompt {len(r.prompt)}): every token within the bf16 "
                  f"tolerance of the plain argmax (largest gap {gap.max().item():.4f}, "
                  f"tolerance {tol.min().item():.4f})")
            near += int((gap > 0).sum())
            worst = max(worst, gap.max().item())
    print(f"  engine tokens against the plain teacher-forced forwards: {near} near-ties "
          f"of {sum(len(r.generated) for r in reqs)} tokens (largest gap {worst:.4f})",
          flush=True)
    return near


def engine_decode_checks(eng, reqs) -> None:
    """The engine's decode held at its own inputs.  ``reqs`` ask for unequal
    token counts, so rows sit at unequal positions, emptied slots decode at
    their stale positions and a queued request is spliced into a freed
    slot.  At every tick: each ``decode_attention`` launch against its plain
    version on the same q, fp32 cache and per-row kv_len (phase 3's bf16
    tolerance, 2e-2; two calls bit-identical), and the tick's logits
    against ``M.decode_step`` through the plain versions on a copy of the
    same cache (phase 5's bf16 tolerance, 5 % of max |logit|)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map

    cfg, V = eng.cfg, eng.cfg.vocab_size
    held = {"on": False, "calls": 0, "err": 0.0, "same": True}
    ticks = []
    attn, decode = ops.decode_attention, eng._decode

    def attn_held(q, k, v, kv_len, *, impl=None):
        out = attn(q, k, v, kv_len, impl=impl)
        if held["on"]:
            again = attn(q, k, v, kv_len)
            want = attn(q, k, v, kv_len, impl="ref")
            held["calls"] += 1
            held["err"] = max(held["err"], max_err(out, want))
            held["same"] &= torch.equal(out, again)
        return out

    def decode_held(params, cache, tokens, pos):
        copy = tree_map(torch.clone, cache)
        active = [r is not None for r in eng.slots]
        held["on"] = True
        try:
            logits, cache = decode(params, cache, tokens, pos)
        finally:
            held["on"] = False
        with torch.inference_mode(), ops.force_impl("ref"):
            plain = M.decode_step(cfg, params, copy, {"tokens": tokens, "pos": pos})[0]
        lg, pl = logits[:, 0, :V].float(), plain[:, 0, :V].float()
        rows = [i for i, a in enumerate(active) if a]
        agree = bool((lg[rows].argmax(-1) == pl[rows].argmax(-1)).all())
        ticks.append((pos.tolist(), active, max_err(lg, pl), pl.abs().max().item(), agree))
        return logits, cache

    for r in reqs:
        eng.submit(r)
    ops.decode_attention, eng._decode = attn_held, decode_held
    try:
        eng.run()
    finally:
        ops.decode_attention = attn
        del eng._decode
    check(all(len(r.generated) == r.max_new_tokens for r in reqs),
          f"held decode run: {len(reqs)} requests of {[r.max_new_tokens for r in reqs]} tokens "
          f"in {len(ticks)} ticks")
    stale = sum(not all(a) for _, a, *_ in ticks)
    check(stale > 0 and all(len(set(p)) > 1 for p, *_ in ticks),
          f"every tick at unequal per-row positions, {stale} ticks with an emptied slot "
          f"decoding at its stale position (positions {[p for p, *_ in ticks]})")
    check(held["calls"] == cfg.num_layers * len(ticks) and held["err"] <= 2e-2 and held["same"],
          f"every decode_attention launch of the held run ({held['calls']}) against the plain "
          f"version on the same inputs: max abs err {held['err']:.3e}, two calls bit-identical")
    worst = max(e / s for _, _, e, s, _ in ticks)
    check(worst <= 0.05, f"every tick's logits against M.decode_step through the plain versions "
          f"on the same cache: largest err {100 * worst:.2f}% of max |logit| (bf16 tolerance 5%)")
    print(f"  held decode run: argmax of the active rows equal to the plain decode's at "
          f"{sum(t[4] for t in ticks)} of {len(ticks)} ticks", flush=True)


class Lines:
    """A subprocess's output read line by line on a thread of its own, so a
    pipe never fills and a wait never blocks on a partial read."""

    def __init__(self, stream) -> None:
        import queue
        import threading

        self.lines: list = []
        self._q = queue.Queue()
        self._t = threading.Thread(target=self._read, args=(stream,), daemon=True)
        self._t.start()

    def _read(self, stream) -> None:
        for line in stream:
            self.lines.append(line.rstrip("\n"))
            self._q.put(line)
        self._q.put(None)

    def wait_for(self, event: str, timeout: float) -> dict:
        """The first JSON line whose ``event`` is ``event``."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._q.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                line = None
            if line is None:
                raise CheckFailed(f"no {event!r} line within {timeout:.0f} s; read "
                                  f"{self.lines}")
            rec = events(line).get(event)
            if rec is not None:
                return rec

    def text(self) -> str:
        self._t.join(timeout=30)
        return "\n".join(self.lines)


def events(stdout: str) -> dict:
    """The JSON event lines of a finished subprocess, by event name (the
    last of each)."""
    out = {}
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "event" in rec:
            out[rec["event"]] = rec
    return out


def serve_roles() -> None:
    """9e: ``python -m repro_torch.launch.serve`` in its three roles, each a
    process of its own on the card at the reduced size."""
    import os
    import signal

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    dest = subprocess.Popen(cmd + ["--role", "destination", "--transport", "both", "--drain",
                                   "--port", "0"], cwd=root, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = Lines(dest.stdout), Lines(dest.stderr)
    try:
        rec = out.wait_for("destination_listening", 300)
        check(rec["transport"] == "both" and rec["port"] > 0,
              f"destination role listening on TCP port {rec['port']} with the SHM doorbell")
        host = subprocess.run(cmd + ["--role", "host", "--connect", f"127.0.0.1:{rec['port']}",
                                     "--requests", "8"], cwd=root, env=env, text=True,
                              capture_output=True, timeout=300)
        check(host.returncode == 0, f"host role exits 0 (rc {host.returncode}; "
              f"stderr tail {host.stderr[-2000:]!r})")
        ev = events(host.stdout)
        hs, done = ev.get("handshake", {}), ev.get("offload_complete", {})
        check(hs.get("runtime") == "PipelinedHostRuntime",
              f"host role: handshake negotiated {hs.get('runtime')}")
        check(done.get("requests") == 8 and sum(done.get("assigned", {}).values()) == 8,
              f"host role: offload_complete, 8 requests at {done.get('req_per_s', 0):.1f} req/s")
        dest.send_signal(signal.SIGINT)
        dest.wait(timeout=120)
        ev = events(out.text())
        check(dest.returncode == 0 and "drain_end" in ev,
              f"destination role drained on SIGINT and exits 0 (rc {dest.returncode}, "
              f"drain_end {ev.get('drain_end')}; stderr tail {err.text()[-2000:]!r})")
    finally:
        if dest.poll() is None:
            dest.kill()
            dest.wait()
    local = subprocess.run(cmd + ["--role", "local", "--requests", "8"], cwd=root, env=env,
                           text=True, capture_output=True, timeout=300)
    ev = events(local.stdout).get("engine_complete", {})
    check(local.returncode == 0 and ev.get("tokens") == 8 * 16,
          f"local role exits 0: engine_complete, {ev.get('tokens')} tokens in "
          f"{ev.get('engine_ticks')} ticks, {ev.get('tok_per_s', 0):.1f} tokens/s "
          f"(rc {local.returncode}; stderr tail {local.stderr[-2000:]!r})")
    print(f"  9e: three roles in {time.perf_counter() - t0:.1f} s", flush=True)


def frontdoor_path(seed: int, dev, served: dict, profile: bool = False) -> dict:
    """Phase 9: granite-3-2b at full width through the front door, then
    continuous batching on the card, then the serving entry point."""
    from repro_torch import avec
    from repro_torch.configs import get_arch
    from repro_torch.core.executor import DestinationExecutor, PipelinedHostRuntime
    from repro_torch.core.library import make_model_library
    from repro_torch.core.shm import SharedMemoryChannel, SharedMemoryServer
    from repro_torch.core.transport import TCPChannel, TCPServer
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.obs.config import global_config
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.utils import to_numpy_tree

    cfg = get_arch("granite-3-2b")
    L, V = cfg.num_layers, cfg.vocab_size
    print(f"phase 9: the front door, {cfg.name} at full width ({L} layers, d_model "
          f"{cfg.d_model}), avec.connect to two destinations (edge: TCP + SHM, cloud: TCP)",
          flush=True)
    total: dict = {}
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (MAIN_B, MAIN_S)).astype(np.int32)     # phase 5's prompt

    # 9a: two destinations as launch/serve --role destination builds them
    execs, servers = [], []
    client = None
    try:
        for name, shm in (("edge", True), ("cloud", False)):
            ex = DestinationExecutor({"lm": make_model_library(cfg, CACHE_LEN, device=dev)},
                                     name=name, device=dev)
            execs.append(ex)
            servers.append(TCPServer(ex.handle).start())
            if shm:
                servers.append(SharedMemoryServer(ex.handle).start())
                ex.shm_address = servers[-1].address
        tcp_ports = [s.port for s in servers if isinstance(s, TCPServer)]
        client = avec.connect([f"tcp://127.0.0.1:{p}" for p in tcp_ports], timeout=900.0,
                              shadow_every=0)
        edge, cloud = client.destinations
        check(all(isinstance(client.runtime(n), PipelinedHostRuntime) for n in (edge, cloud)),
              "handshake: PipelinedHostRuntime on both destinations")
        check(isinstance(client.runtime(edge).channel, SharedMemoryChannel)
              and isinstance(client.runtime(cloud).channel, TCPChannel),
              f"edge re-dialed onto SharedMemoryChannel (same-host upgrade), cloud stayed on "
              f"TCPChannel")

        # 9b: phase 5's calls through a facade session
        t0 = time.perf_counter()
        params_host = to_numpy_tree(M.init_params(cfg, seed, device=dev))
        torch.cuda.empty_cache()
        print(f"  weights made on the card and brought to the host in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        sess = client.session(cfg, params_host, "lm", tenant="acme")
        other = cloud if sess.destination == edge else edge
        label = {edge: "edge", cloud: "cloud"}
        print(f"  the scheduler placed the session on {label[sess.destination]}", flush=True)
        print(put_model_line(sess, label[sess.destination]), flush=True)
        # warm through the destination's own server thread (its cuBLAS
        # handle, the allocator) before anything is timed or counted
        sess.call("prefill", {"tokens": tokens})
        ops.reset_launch_counts()
        logits, loss, cycles = facade_calls(sess, tokens, N_DECODE)
        counts = all_counts()
        add_counts(total, counts)
        for fn, comp, wire in cycles:
            print(f"  {fn:8s} compute_s {comp:.5f}  wire_s {wire:.5f}", flush=True)
        print(f"  launches through the facade: {counts}", flush=True)
        check(counts == expected_counts(cfg),
              f"launch counts match the model's structure: {expected_counts(cfg)}")
        check(len(logits) == len(served["logits"]) and all(
                  np.array_equal(a, b) for a, b in zip(logits, served["logits"])),
              f"prefill and {N_DECODE} decode logits bit-identical to phase 5's")
        check(loss == served["loss"], f"score loss bit-identical to phase 5's ({loss:.6f})")

        # the same prefill on the other destination: TCP and SHM side by side
        sess2 = client.session(cfg, params_host, "lm", tenant="acme", destination=other)
        print(put_model_line(sess2, label[other]), flush=True)
        sess2.call("prefill", {"tokens": tokens})                   # warm
        lg2 = np.array(sess2.call("prefill", {"tokens": tokens})["logits"])
        c2 = sess2.profiler.cycles[-1]
        print(f"  prefill on {label[sess.destination]} "
              f"({type(sess.runtime.channel).__name__}): compute_s {cycles[0][1]:.5f}  "
              f"wire_s {cycles[0][2]:.5f}; on {label[other]} "
              f"({type(sess2.runtime.channel).__name__}): compute_s {c2.gpu_s:.5f}  "
              f"wire_s {c2.comm_s:.5f}", flush=True)
        check(np.array_equal(lg2, served["logits"][0]),
              f"prefill on {label[other]} bit-identical to phase 5's")

        # 9c: one call sharded over both destinations, then a map
        htoks = rng.integers(0, V, (HIDDEN_B, MAIN_S)).astype(np.int32)
        global_config().set("shard_min_rows", HIDDEN_B // 2)   # the default floor is 256 rows
        try:
            ops.reset_launch_counts()
            whole = host_float(sess.call("hidden", {"tokens": htoks}, shard=False)["hidden"])
            split = host_float(sess.call("hidden", {"tokens": htoks}, shard=True)["hidden"])
            counts = all_counts()
        finally:
            global_config().unset("shard_min_rows")
        add_counts(total, counts)
        st = sess.last_shard_stats
        check(st is not None and len(st["shards"]) == 2 and not st["failed"]
              and set(st["destinations"]) == {edge, cloud},
              f"hidden (B {HIDDEN_B}) sharded over both destinations: {st and st['shards']}")
        check(counts["flash_attention"] == 3 * L and counts["rmsnorm"] == 3 * (2 * L + 1),
              f"three forwards' launches (one whole, two shards): {counts}")
        e, scale = max_err(split, whole), whole.abs().max().item()
        check(tuple(split.shape) == (HIDDEN_B, MAIN_S, cfg.d_model) and e <= 0.05 * scale,
              f"stitched hidden vs the unsharded call: max abs err {e:.4f} (bf16 tolerance "
              f"5% of max |h| {scale:.3f}); bit-identical: {torch.equal(split, whole)}")
        print(f"  sharded call: wall {st['wall_s']:.5f} s, shards {st['shards']}", flush=True)

        reqs = {}
        for i in range(MAP_REQS):
            t = rng.integers(0, V, (MAIN_B, MAIN_S)).astype(np.int32)
            reqs[f"m{i}"] = {"tokens": t, "targets": np.roll(t, -1, axis=1)}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = sess.map("score", reqs)
        wall = time.perf_counter() - t0
        counts = all_counts()
        add_counts(total, counts)
        assigned = sess.last_map_stats["assigned"]
        served = sess.last_map_stats["served_by"]
        check(set(assigned) == {edge, cloud} and all(n > 0 for n in assigned.values())
              and set(served) == set(reqs) and set(served.values()) == {edge, cloud},
              f"map of {MAP_REQS} scores spread over both destinations: "
              f"{ {rid: label[n] for rid, n in served.items()} } in {wall:.4f} s")
        check(counts["flash_attention"] == MAP_REQS * L, f"{MAP_REQS} forwards' launches: {counts}")
        # both destinations run in this process with the same weights and
        # kernels, so the values cannot tell them apart: the destination is
        # the one the map records as having answered the request
        direct = {sess.destination: sess, other: sess2}
        for rid, args in reqs.items():
            served_by = served[rid]
            want = float(np.asarray(direct[served_by].call("score", args)["loss"]))
            check(float(np.asarray(res[rid]["loss"])) == want,
                  f"map {rid}: bit-identical to a direct call on {label[served_by]} "
                  f"({want:.6f})")
    finally:
        if client is not None:
            client.close()
        for s in reversed(servers):
            s.stop()
        for ex in execs:
            ex.shutdown()
        torch.cuda.empty_cache()
    print(f"  device memory allocated after the destinations shut down: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    # 9d: continuous batching on the card, the weights on the card
    params = M.init_params(cfg, seed, device=dev)
    prompts = engine_prompts(seed, V)

    def requests(tag, new):
        return [Request(f"{tag}{i}", p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts[tag], new))]

    warm = ServingEngine(cfg, params, max_batch=ENGINE_B, max_len=ENGINE_LEN, device=dev)
    for r in requests("w", [2, 2]):
        warm.submit(r)
    warm.run()
    del warm
    eng = ServingEngine(cfg, params, max_batch=ENGINE_B, max_len=ENGINE_LEN, device=dev)
    reqs = requests("r", [ENGINE_NEW] * ENGINE_REQS)
    for r in reqs:
        eng.submit(r)
    print(f"  9d: ServingEngine max_batch {ENGINE_B}, cache {ENGINE_LEN} (fp32), "
          f"{ENGINE_REQS} requests of {ENGINE_NEW} tokens, prompts "
          f"{[len(r.prompt) for r in reqs]}", flush=True)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts()
    add_counts(total, counts)
    n_tok = sum(len(v) for v in out.values())
    print(f"  engine: {n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} tokens/s, "
          f"{eng.steps} steps; launches {counts}", flush=True)
    want = {name: 0 for name in counts} | {
        "rmsnorm": (2 * L + 1) * (ENGINE_REQS + eng.steps),
        "flash_attention": L * ENGINE_REQS, "decode_attention": L * eng.steps}
    check(counts == want, f"engine launch counts: flash L x {ENGINE_REQS} prefills, decode "
          f"L x {eng.steps} steps, rmsnorm (2L+1) per forward: {want}")
    check(all(len(r.generated) == ENGINE_NEW and all(0 <= t < V for t in r.generated)
              for r in reqs), f"every request generated {ENGINE_NEW} tokens in the vocab")
    engine_checks(cfg, params, reqs, dev)
    engine_decode_checks(eng, requests("c", ENGINE_CHECK_NEW))
    if profile:
        for r in requests("p", [8] * ENGINE_B):
            eng.submit(r)
        eng.tick()                                  # admit: four prefills
        profile_call("engine tick (4 slots)", eng.tick)
    del eng, params
    torch.cuda.empty_cache()

    # 9e: the entry point itself
    serve_roles()
    return total


def peak_and_reset() -> int:
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def make_step_timer(cfg, ocfg):
    """One synchronized train step -> its host wall time in seconds."""
    from repro_torch.train.steps import make_train_step

    step = make_train_step(cfg, ocfg)

    def run(params, opt, batch, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batch, i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    return run


def profile_call(name: str, fn, top: int = 10) -> None:
    """Where one call's time goes: host wall time against the sum of device
    kernel time (one stream, so kernels do not overlap), the launch count,
    the device time under the training step's profiler ranges (the
    plain-recompute backward, the optimizer update), and the kernels that
    take the most device time."""
    from repro_torch.kernels.autograd import BACKWARD_SPAN
    from repro_torch.train.steps import UPDATE_SPAN

    fn()                                            # warm: allocator, cuBLAS
    wall_ms, kernels, events = device_events(fn)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels)} device events", flush=True)
    for span in (BACKWARD_SPAN, UPDATE_SPAN):
        ranges = [e for e in events if e.name == span
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if ranges:
            span_ms = sum(e.device_time_total for e in ranges) / 1e3
            print(f"    {span_ms:9.3f} ms  {len(ranges):5d}x  kernels under {span} "
                  f"({100 * span_ms / busy_ms:.1f}% of device busy)", flush=True)
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"    {t:9.3f} ms  {n:5d}x  {kname[:100]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one prefill and one decode of each served model, one "
                         "training step, the OpenPose-lite forward at B 1 and B 64 and "
                         "one 4-slot engine tick (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_s:.1f} s)", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    granite_vocab = get_arch("granite-3-2b").vocab_size
    engine_lens = [len(p) for ps in engine_prompts(args.seed, granite_vocab).values() for p in ps]
    rows = kernel_times(gen, dev, kernel_checks(gen, dev, engine_lens))
    rows.update(quant_times(gen, dev, quant_checks(gen, dev)))
    grad_checks(gen, dev)
    small_model_check("4", "granite-3-2b", args.seed, dev)
    small_model_check("4b", "mamba2-130m", args.seed, dev)
    small_train_check("granite-3-2b", args.seed, dev)
    small_train_check("mamba2-130m", args.seed, dev)
    granite, served = main_path("5", "granite-3-2b", MAIN_S, args.seed, dev,
                                profile=args.profile)
    paths = [granite,
             main_path("6", "mamba2-130m", SSM_S, args.seed, dev, profile=args.profile)[0],
             train_path(args.seed, dev, profile=args.profile),
             openpose_path(args.seed, dev, profile=args.profile),
             frontdoor_path(args.seed, dev, served, profile=args.profile)]
    counts = {name: sum(p[name] for p in paths) for name in paths[0]}   # every main path's

    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:22",
                "flash_attention": "src/repro/kernels/flash_attention.py:72",
                "decode_attention": "src/repro/kernels/decode_attention.py:67",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:72",
                "quantize_int8": "src/repro/kernels/comm_quant.py:89",
                "dequantize_int8": "src/repro/kernels/comm_quant.py:112"}
    source = {name: name for name in replaces} | {"quantize_int8": "comm_quant",
                                                  "dequantize_int8": "comm_quant"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source[name]}.cu",
                "replaces": replaces[name], "launches": counts[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                **{key: r[key] for key in ("host_us", "at_other_shapes", "per_exchange",
                                           "per_exchange_fp32") if key in r},
                **({"launches_by_branch": {"tensor_cores": counts["ssd_scan_tc"],
                                           "cuda_cores": counts["ssd_scan_simt"]}}
                   if name == "ssd_scan" else {}),
                **({"launches_by_branch": {"vector": counts["quantize_int8_vec"],
                                           "scalar": counts["quantize_int8_scalar"]}}
                   if name == "quantize_int8" else {})}
               for name, r in rows.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
