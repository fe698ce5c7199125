#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card, at
   granite-3-2b's and mamba2-130m's shapes, head dims 16 and 128, ragged
   lengths, kv_len 1 and S, S < chunk and S = 1, float32 and bfloat16; time
   kernel, plain version and the PyTorch yardstick (``F.rms_norm``,
   ``F.scaled_dot_product_attention``, timed only, never called by the port;
   no single PyTorch call computes the SSD scan) at the main paths' shapes;
4. a reduced granite-3-2b in float32 through the kernels on the card against
   the plain versions on the CPU (the CPU tests hold those against the JAX
   package), and prefill + decode against forward;
4b. the same for a reduced mamba2-130m;
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
   score, through the SSD-scan and rmsnorm kernels.

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
SSM_S = 1024                          # mamba2-130m prompt: four chunks of 256
# mamba2-130m's scan: (B, S, H, P, G, N, chunk)
SSD_MAIN = (MAIN_B, SSM_S, 24, 64, 1, 128, 256)


class CheckFailed(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)
    print(f"  ok  {msg}", flush=True)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def device_events(fn):
    """Run ``fn`` under torch.profiler; -> (host wall ms, device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


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

    _, events = device_events(loop)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


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

def kernel_checks(gen, dev) -> dict:
    """-> each kernel's max abs error at the main path's shapes."""
    from repro_torch.kernels import ops

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    main_err = {}
    print("phase 3: kernels vs plain versions on the card", flush=True)
    # rmsnorm: f32 atol 1e-5 (test_kernels.py); bf16 within one output ulp (rtol 1e-2).
    # granite-3-2b's shapes, small ones, then mamba2-130m's as its path gives them:
    # mixer and final norms on bf16 x with the bf16 scale, the gated norm on
    # fp32 x (d_inner 1536) with the fp32 scale, prefill and decode
    for shape, dt, sdt in [((MAIN_B, MAIN_S, 2048), bf16, f32), ((MAIN_B, MAIN_S, 2048), f32, f32),
                           ((MAIN_B, 1, 2048), bf16, f32), ((37, 512), f32, f32),
                           ((5, 16), f32, f32), ((3, 128), bf16, f32),
                           ((MAIN_B, SSM_S, 768), bf16, bf16), ((MAIN_B, SSM_S, 1536), f32, f32),
                           ((MAIN_B, 1, 768), bf16, bf16), ((MAIN_B, 1, 1536), f32, f32)]:
        x, s = randn(*shape, dtype=dt), randn(shape[-1], dtype=sdt)
        got, want = ops.rmsnorm(x, s), ops.rmsnorm(x, s, impl="ref")
        e = max_err(got, want)
        tol = (got.float() - want.float()).abs() <= 1e-5 + (1e-2 if dt == bf16 else 0) * want.float().abs()
        check(bool(tol.all()), f"rmsnorm {shape} {dt} scale {sdt}: max abs err {e:.3e}")
        if shape == (MAIN_B, MAIN_S, 2048) and dt == bf16:
            main_err["rmsnorm"] = e
    # flash: atol 2e-5 in f32, 2e-2 in bf16 (test_kernels.py)
    for (B, H, K, Sq, Sk, D), dt, causal in [
            ((MAIN_B, 32, 8, MAIN_S, MAIN_S, 64), bf16, True),
            ((MAIN_B, 32, 8, MAIN_S, MAIN_S, 64), f32, True),
            ((1, 4, 2, 64, 64, 16), f32, True), ((1, 8, 2, 128, 128, 128), f32, True),
            ((1, 8, 2, 128, 128, 128), bf16, False), ((2, 4, 2, 77, 77, 64), f32, True),
            ((1, 4, 2, 37, 53, 64), f32, False), ((1, 4, 1, 19, 45, 16), bf16, True)]:
        q, k, v = randn(B, Sq, H, D, dtype=dt), randn(B, Sk, K, D, dtype=dt), randn(B, Sk, K, D, dtype=dt)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
        e = max_err(got, want)
        check(e <= (2e-2 if dt == bf16 else 2e-5),
              f"flash_attention B{B} H{H} K{K} Sq{Sq} Sk{Sk} D{D} {dt} causal={causal}: "
              f"max abs err {e:.3e}")
        if (B, H, Sq, D, dt, causal) == (MAIN_B, 32, MAIN_S, 64, bf16, True):
            main_err["flash_attention"] = e
    # decode: atol 2e-5 in f32, 2e-2 in bf16; kv_len random, 1 and S
    for (B, K, G, S, D), qdt, kdt in [((MAIN_B, 8, 4, CACHE_LEN, 64), bf16, bf16),
                                      ((MAIN_B, 8, 4, CACHE_LEN, 64), f32, f32),
                                      ((3, 2, 8, 40, 16), f32, f32),
                                      ((1, 4, 1, 128, 128), f32, f32),
                                      ((2, 2, 4, 100, 128), bf16, bf16),
                                      ((2, 2, 2, 64, 16), f32, bf16)]:
        q = randn(B, 1, K * G, D, dtype=qdt)
        kc, vc = randn(B, S, K, D, dtype=kdt), randn(B, S, K, D, dtype=kdt)
        for lens in (torch.randint(1, S + 1, (B,), generator=gen, device=dev),
                     torch.ones(B, device=dev), torch.full((B,), S, device=dev)):
            lens = lens.to(torch.int32)
            got = ops.decode_attention(q, kc, vc, lens)
            want = ops.decode_attention(q, kc, vc, lens, impl="ref")
            e = max_err(got, want)
            check(e <= (2e-2 if qdt == bf16 else 2e-5),
                  f"decode_attention B{B} K{K} G{G} S{S} D{D} q {qdt} kv {kdt} "
                  f"kv_len {lens.tolist()}: max abs err {e:.3e}")
            if (K, G, S, qdt) == (8, 4, CACHE_LEN, bf16):
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
    to bf16 and may land on neighbouring values."""
    from repro_torch.kernels import ops

    bf16, f32 = torch.bfloat16, torch.float32
    main = 0.0
    for shape, dt_ in [(SSD_MAIN, bf16), (SSD_MAIN, f32),
                       ((2, 512, 4, 64, 2, 128, 128), f32), ((1, 256, 2, 128, 1, 64, 256), f32),
                       ((2, 300, 4, 64, 4, 32, 128), f32), ((1, 128, 8, 32, 2, 64, 64), f32),
                       ((2, 37, 8, 16, 1, 16, 8), f32), ((2, 37, 8, 16, 1, 16, 8), bf16),
                       ((1, 5, 2, 16, 1, 16, 8), f32), ((1, 1, 24, 64, 1, 128, 256), bf16)]:
        B, S, H, P, G, N, L = shape
        args = ssd_inputs(gen, dev, B, S, H, P, G, N, dt_)
        y, st = ops.ssd_scan(*args, chunk=L)
        yr, sr = ops.ssd_scan(*args, chunk=L, impl="ref")
        torch.cuda.synchronize()
        ey, es = max_err(y, yr), max_err(st, sr)
        tol_y = 2e-4 * (yr.float().abs().max().item() + 1.0)
        tol_s = 2e-4 * (sr.abs().max().item() + 1.0)
        ok_y = (y.float() - yr.float()).abs() <= tol_y + (1e-2 if dt_ == bf16 else 0) * yr.float().abs()
        check(bool(ok_y.all()) and es <= tol_s and y.dtype == dt_ and st.dtype == f32,
              f"ssd_scan B{B} S{S} H{H} P{P} G{G} N{N} L{L} {dt_}: y max abs err {ey:.3e} "
              f"(tol {tol_y:.3e}), state {es:.3e} (tol {tol_s:.3e})")
        if shape == SSD_MAIN and dt_ == bf16:
            main = ey
    return main


def kernel_times(gen, dev, main_err: dict) -> dict:
    """Kernel, plain and yardstick times at the main paths' shapes
    (granite-3-2b and mamba2-130m, bf16), with each kernel's bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rk

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    x, s = randn(MAIN_B, MAIN_S, 2048, dtype=bf16), randn(2048)
    sb = s.to(bf16)
    b, why = bound_ms(nbytes(x, s) + nbytes(x), 4 * x.numel(), f32)
    rows["rmsnorm"] = dict(
        shape=f"x {tuple(x.shape)} bf16", ms=time_ms(lambda: rk.rmsnorm_cuda(x, s)),
        plain_ms=time_ms(lambda: ref.rmsnorm(x, s)),
        library_ms=time_ms(lambda: F.rms_norm(x, (2048,), sb, 1e-6)), bound_ms=b, bound_by=why)
    q = randn(MAIN_B, MAIN_S, 32, 64, dtype=bf16)
    k, v = randn(MAIN_B, MAIN_S, 8, 64, dtype=bf16), randn(MAIN_B, MAIN_S, 8, 64, dtype=bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = MAIN_S * (MAIN_S + 1) // 2
    b, why = bound_ms(nbytes(q, k, v) + nbytes(q), 4 * MAIN_B * 32 * 64 * pairs, bf16)
    rows["flash_attention"] = dict(
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
        ms=time_ms(lambda: ops.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: ops.flash_attention(q, k, v, impl="ref")),
        library_ms=time_ms(lambda: sdpa_gqa(qt, kt, vt, is_causal=True)),
        bound_ms=b, bound_by=why)
    kv_len = MAIN_S + N_DECODE
    qd = randn(MAIN_B, 1, 32, 64, dtype=bf16)
    kc, vc = randn(MAIN_B, CACHE_LEN, 8, 64, dtype=bf16), randn(MAIN_B, CACHE_LEN, 8, 64, dtype=bf16)
    lens = torch.full((MAIN_B,), kv_len, dtype=torch.int32, device=dev)
    read = 2 * MAIN_B * 8 * kv_len * 64 * 2
    b, why = bound_ms(nbytes(qd, lens) + read + nbytes(qd), 4 * MAIN_B * 32 * 64 * kv_len, bf16)
    qdt, kct, vct = qd.transpose(1, 2), kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
    rows["decode_attention"] = dict(
        shape=f"q {tuple(qd.shape)} cache {tuple(kc.shape)} kv_len {kv_len} bf16",
        ms=time_ms(lambda: ops.decode_attention(qd, kc, vc, lens)),
        plain_ms=time_ms(lambda: ops.decode_attention(qd, kc, vc, lens, impl="ref")),
        library_ms=time_ms(lambda: sdpa_gqa(qdt, kct, vct)), bound_ms=b, bound_by=why)
    B, S, H, P, G, N, L = SSD_MAIN
    args = ssd_inputs(gen, dev, B, S, H, P, G, N, bf16)
    x, dtt, A, Bm, Cm = args
    nc = -(-S // L)
    flops = 2 * B * nc * (G * L * L * N + H * (L * L * P + 2 * L * N * P))
    b, why = bound_ms(B * S * (H * P + 2 * G * N) * 2 + nbytes(dtt, A)       # inputs read once
                      + B * S * H * P * 2 + B * H * P * N * 4, flops, bf16)  # y, state written once
    rows["ssd_scan"] = dict(
        shape=f"x {tuple(x.shape)} B/C {tuple(Bm.shape)} bf16 (strided views), chunk {L}",
        ms=time_ms(lambda: ops.ssd_scan(*args, chunk=L), iters=20),
        plain_ms=time_ms(lambda: ops.ssd_scan(*args, chunk=L, impl="ref"), iters=20),
        library_ms=None, bound_ms=b, bound_by=why)   # no single PyTorch call computes SSD
    ops.reset_launch_counts()        # timing launches are not the main path's
    for name, r in rows.items():
        r["max_abs_err"] = main_err[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"yardstick {lib}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), main-shape max abs err {r['max_abs_err']:.3e}", flush=True)
    return rows


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


# ---------------------------------------------------------------------------
# phases 5 and 6: the main paths at full width
# ---------------------------------------------------------------------------

def expected_counts(cfg) -> dict:
    """Kernel launches of one prefill, N_DECODE decodes and one score: an
    rmsnorm per mixer norm, per FFN norm (dense) or gated norm (SSM), and
    the final norm; attention or the SSD scan once per layer per prefill
    or score; decode attention once per layer per step (an SSM decode step
    is one plain ``ssd_step``)."""
    L, n_fwd = cfg.num_layers, 1 + N_DECODE + 1
    if cfg.family == "ssm":
        return {"rmsnorm": (2 * L + 1) * n_fwd, "flash_attention": 0, "decode_attention": 0,
                "ssd_scan": 2 * L}
    return {"rmsnorm": (2 * L + 1) * n_fwd, "flash_attention": 2 * L,
            "decode_attention": L * N_DECODE, "ssd_scan": 0}


def main_path(phase: str, arch: str, seq: int, seed: int, dev, profile: bool = False) -> dict:
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
        counts = ops.launch_counts()
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
        return counts
    finally:
        host.close()
        server.stop()
        dest.shutdown()


def profile_call(name: str, fn, top: int = 10) -> None:
    """Where one library call's time goes: host wall time against the sum of
    device kernel time (one stream, so kernels do not overlap), the launch
    count, and the kernels that take the most device time."""
    fn()                                            # warm: allocator, cuBLAS
    wall_ms, kernels = device_events(fn)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels)} device events", flush=True)
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"    {t:9.3f} ms  {n:5d}x  {kname[:100]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one prefill and one decode of the main path (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
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
    rows = kernel_times(gen, dev, kernel_checks(gen, dev))
    small_model_check("4", "granite-3-2b", args.seed, dev)
    small_model_check("4b", "mamba2-130m", args.seed, dev)
    dense = main_path("5", "granite-3-2b", MAIN_S, args.seed, dev, profile=args.profile)
    ssm = main_path("6", "mamba2-130m", SSM_S, args.seed, dev, profile=args.profile)
    counts = {name: dense[name] + ssm[name] for name in dense}   # both main paths' launches

    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:22",
                "flash_attention": "src/repro/kernels/flash_attention.py:72",
                "decode_attention": "src/repro/kernels/decode_attention.py:67",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:72"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces[name], "launches": counts[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]} for name, r in rows.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
