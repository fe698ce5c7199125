#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card, at
   granite-3-2b's shapes, head dims 16 and 128, ragged lengths, kv_len 1 and
   S, float32 and bfloat16; time kernel, plain version and the PyTorch
   yardstick (``F.rms_norm``, ``F.scaled_dot_product_attention``, timed only,
   never called by the port) at the main path's shapes;
4. a reduced granite-3-2b in float32 through the kernels on the card against
   the plain versions on the CPU (the CPU tests hold those against the JAX
   package), and prefill + decode against forward;
5. the main path at full width: a port ``DestinationExecutor`` serving
   ``make_model_library(granite-3-2b)`` behind the port's ``TCPServer`` on
   127.0.0.1, driven by a port ``HostRuntime`` over ``TCPChannel``: ping,
   put_model of the full bf16 weights (made on the card from ``--seed``),
   prefill (B 2, S 128), 8 decodes and a score.  The launch counters are
   zeroed just before and read just after, and must match the model's
   structure; the prefill logits are compared with the same call through the
   plain versions.

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
    # rmsnorm: f32 atol 1e-5 (test_kernels.py); bf16 within one output ulp (rtol 1e-2)
    for shape, dt in [((MAIN_B, MAIN_S, 2048), bf16), ((MAIN_B, MAIN_S, 2048), f32),
                      ((MAIN_B, 1, 2048), bf16), ((37, 512), f32), ((5, 16), f32),
                      ((3, 128), bf16)]:
        x, s = randn(*shape, dtype=dt), randn(shape[-1])
        got, want = ops.rmsnorm(x, s), ops.rmsnorm(x, s, impl="ref")
        e = max_err(got, want)
        tol = (got.float() - want.float()).abs() <= 1e-5 + (1e-2 if dt == bf16 else 0) * want.float().abs()
        check(bool(tol.all()), f"rmsnorm {shape} {dt}: max abs err {e:.3e}")
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

    return main_err


def kernel_times(gen, dev, main_err: dict) -> dict:
    """Kernel, plain and yardstick times at the main path's shapes
    (granite-3-2b, bf16), with each kernel's bound."""
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
    ops.reset_launch_counts()        # timing launches are not the main path's
    for name, r in rows.items():
        r["max_abs_err"] = main_err[name]
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"yardstick {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), main-shape max abs err {r['max_abs_err']:.3e}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: small model on the card against the plain versions on the CPU
# ---------------------------------------------------------------------------

def small_model_check(seed: int, dev) -> None:
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map

    print("phase 4: reduced granite-3-2b (float32), kernels on the card vs plain on the CPU",
          flush=True)
    cfg = reduced(get_arch("granite-3-2b"))
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
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def main_path(seed: int, dev, profile: bool = False) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.core.cache import model_fingerprint
    from repro_torch.core.executor import DestinationExecutor, HostRuntime
    from repro_torch.core.library import make_model_library
    from repro_torch.core.transport import TCPChannel, TCPServer
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.utils import to_numpy_tree, tree_leaves

    cfg = get_arch("granite-3-2b")
    L = cfg.num_layers
    print(f"phase 5: main path, {cfg.name} at full width ({L} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
          f"{cfg.padded_vocab}), served over TCP", flush=True)
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
        tokens = rng.integers(0, cfg.vocab_size, (MAIN_B, MAIN_S)).astype(np.int32)
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

        n_fwd = 1 + N_DECODE + 1                       # prefill, decodes, score
        check(counts == {"rmsnorm": (2 * L + 1) * n_fwd, "flash_attention": L * 2,
                         "decode_attention": L * N_DECODE},
              f"launch counts match the model: rmsnorm {2 * L + 1}/forward, flash "
              f"{L}/prefill or score, decode {L}/step")
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
              f"(bf16 tolerance 5% of max |logit| {scale:.3f})")
        if profile:
            lib = dest.libraries["lm"]
            toks = torch.from_numpy(tokens).to(dev)
            profile_call("prefill", lambda: lib["prefill"](entry["params"], entry["state"],
                                                           {"tokens": toks}))
            profile_call("decode", lambda: lib["decode"](entry["params"], entry["state"],
                                                         {"tokens": toks[:, :1]}))
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
    small_model_check(args.seed, dev)
    counts = main_path(args.seed, dev, profile=args.profile)

    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:22",
                "flash_attention": "src/repro/kernels/flash_attention.py:72",
                "decode_attention": "src/repro/kernels/decode_attention.py:67"}
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
