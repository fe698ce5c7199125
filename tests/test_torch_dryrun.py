"""The port's dry-run and roofline on the CPU: the H100 roofline's arithmetic,
``model_flops_6nd`` against the JAX package's for every arch x shape, the
collective tally, and mini dry-runs in subprocesses on fake ranks (the
twin of the reference's ``test_mini_dryrun_subprocess``).

A process group is process-wide, so everything that starts one runs in a
subprocess of its own.  The counts there are exact: ``argument_bytes`` is
held equal to the sum of the local shards' bytes computed here from the
partition specs, independently of the DTensors the dry-run places.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

from repro.configs import ARCH_IDS, SHAPES, get_arch
from repro.launch import roofline as RR
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as TR

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF_KEYS = {"arch", "shape", "mesh", "profile", "overrides", "tag", "chips", "ok",
            "compile_s", "memory_analysis", "cost_compile_s", "cost_method",
            "cost_analysis", "collectives", "roofline"}


def _run(script: str, *args, timeout: int = 600) -> dict:
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(script)
        path = f.name
    try:
        out = subprocess.run([sys.executable, path, SRC, *args], capture_output=True,
                             text=True, timeout=timeout)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        os.unlink(path)


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,nbytes,coll,mf,chips", [
    (989e12, 3.35e12, 450e9, 6e14, 256),       # 1 s each: compute wins the tie
    (1e12, 6.7e12, 0.0, 5e11, 1),               # memory
    (1e9, 1e9, 9e11, 1e12, 512),                # collective
    (0.0, 0.0, 0.0, 1e9, 8),                    # nothing counted
])
def test_analyze_is_the_h100_roofline(flops, nbytes, coll, mf, chips):
    r = TR.analyze(flops, nbytes, coll, mf, chips)
    assert r.compute_s == flops / 989e12
    assert r.memory_s == nbytes / 3.35e12
    assert r.collective_s == coll / 450e9
    terms = {"compute": r.compute_s, "memory": r.memory_s, "collective": r.collective_s}
    assert r.dominant == max(terms, key=terms.get) and r.bound_s == terms[r.dominant]
    assert r.useful_ratio == (mf / (flops * chips) if flops else 0.0)
    ref = RR.analyze(flops, nbytes, coll, mf, chips)      # the same arithmetic, TPU peaks
    assert r.useful_ratio == ref.useful_ratio
    assert r.to_dict().keys() == ref.to_dict().keys()
    assert (r.flops_per_device, r.bytes_per_device, r.coll_bytes_per_device, r.model_flops) == \
        (flops, nbytes, coll, mf)


def test_hw_is_the_h100_datasheet():
    assert TR.HW["peak_flops"] == 989e12 and TR.HW["hbm_bw"] == 3.35e12
    assert TR.HW["nvlink_bw"] == 450e9 and TR.HW["chip_mem"] == 80e9
    assert "H100" in TR.HW["name"]
    assert "TPU" not in TR.__doc__ and "v5e" not in TR.__doc__


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_6nd_equals_reference(arch, shape):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    got = TR.model_flops_6nd(tcfg, tconfigs.SHAPES[shape])
    assert got == RR.model_flops_6nd(cfg, SHAPES[shape])
    s = SHAPES[shape]
    tokens = s.global_batch if s.kind == "decode" else s.global_batch * s.seq_len
    assert got == 6.0 * tcfg.param_count(active_only=True) * tokens


def test_tally_collectives():
    total, by_type = TR.tally_collectives([("all_reduce", 8), ("all_gather_into_tensor", 32),
                                           ("all_reduce", 4), ("reduce_scatter_tensor", 2),
                                           ("all_to_all_single", 1)])
    assert total == 47
    assert by_type == {"all-reduce": {"bytes": 12, "count": 2},
                       "all-gather": {"bytes": 32, "count": 1},
                       "reduce-scatter": {"bytes": 2, "count": 1},
                       "all-to-all": {"bytes": 1, "count": 1}}


# ---------------------------------------------------------------------------
# mini dry-runs on fake ranks
# ---------------------------------------------------------------------------

MINI_DRYRUN = r"""
import sys, json, dataclasses, math
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.mesh import start_fake_world, make_mesh
start_fake_world(8)                      # the process group first
from repro_torch.configs import get_arch, reduced, SHAPES
from repro_torch.launch.dryrun import build_cell, count_cell
from repro_torch.utils import tree_leaves

arch, shape_name, data, kv = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
cfg = dataclasses.replace(reduced(get_arch(arch)), num_heads=4, num_kv_heads=kv)
shape = dataclasses.replace(SHAPES[shape_name], seq_len=64, global_batch=8)
mesh = make_mesh((data, 8 // data), ("data", "model"))
costs = count_cell(cfg, shape, mesh, "dp_tp")

# one device's bytes from the partition specs' arithmetic (no DTensor)
_, args, shardings = build_cell(cfg, shape, mesh, "dp_tp")
want = 0
for a, sh in zip(args, shardings):
    for t, s in zip(tree_leaves(a), tree_leaves(sh)):
        names = [n for e in s.spec if e for n in (e if isinstance(e, tuple) else (e,))]
        want += t.numel() // math.prod(mesh.shape[n] for n in names) * t.element_size()
print(json.dumps({"flops": costs["flops"], "bytes": costs["bytes"], "ops": sorted(costs["by_type"]),
                  "argument_bytes": costs["memory_analysis"]["argument_bytes"], "want": want}))
"""


@pytest.mark.parametrize("arch,shape,data,kv", [
    ("granite-3-2b", "train_4k", 4, 4), ("granite-3-2b", "prefill_32k", 4, 4),
    ("granite-3-2b", "decode_32k", 4, 4),
    # 2 kv heads over model 4: k and v repeated to the query heads per shard
    ("granite-3-2b", "train_4k", 2, 2), ("granite-3-2b", "decode_32k", 2, 2),
    ("moonshot-v1-16b-a3b", "train_4k", 4, 4), ("moonshot-v1-16b-a3b", "prefill_32k", 4, 4),
    ("moonshot-v1-16b-a3b", "decode_32k", 4, 4), ("whisper-medium", "prefill_32k", 4, 4),
    # the SSM mixer per shard: its conv, scan and decode step (heads split 2 ways)
    ("mamba2-130m", "train_4k", 4, 4), ("mamba2-130m", "prefill_32k", 4, 4),
    ("mamba2-130m", "decode_32k", 4, 4), ("jamba-1.5-large-398b", "train_4k", 4, 4),
    ("jamba-1.5-large-398b", "prefill_32k", 4, 4), ("jamba-1.5-large-398b", "decode_32k", 4, 4)])
def test_mini_dryrun_subprocess(arch, shape, data, kv):
    rec = _run(MINI_DRYRUN, arch, shape, str(data), str(kv))
    assert rec["flops"] > 0 and rec["bytes"] > 0
    # data-parallel training must reduce gradients -> all-reduce present;
    # tensor-parallel layers reduce their partial sums in a prefill or decode
    assert "all-reduce" in rec["ops"], rec
    assert rec["argument_bytes"] == rec["want"]


CLI_DRYRUN = r"""
import sys, json, os, glob
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun
out = sys.argv[2]
dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--mesh", "host",
             "--device", "cpu", "--out", out, "--attn-impl", "blocked", "--exact"])
rec = json.load(open(glob.glob(os.path.join(out, "*.json"))[0]))
# a cell that fails is recorded and the sweep goes on (the chunk divides no vocab)
bad = dryrun.run_cell("granite-3-2b", "train_4k", "host", "dp_tp",
                      {"xent_impl": "chunked", "xent_chunk": 3}, out, tag="bad", device="cpu")
print(json.dumps({"rec": rec, "bad": {k: bad[k] for k in ("ok", "error")},
                  "files": sorted(os.listdir(out))}))
"""


def test_cli_host_mesh_records_the_reference_keys(tmp_path):
    """``--mesh host`` on one real rank (gloo, CPU): granite-3-2b's train_4k
    counted whole on meta tensors; a failing cell records ``ok: false``."""
    out = _run(CLI_DRYRUN, str(tmp_path))
    rec = out["rec"]
    assert rec["ok"] and REF_KEYS <= set(rec), sorted(rec)
    assert rec["mesh"] == "host" and rec["chips"] == 1 and rec["cost_method"] == "counted"
    # the ops that move the most bytes, largest first, a share of the count
    by_op = [r["bytes"] for r in rec["bytes_by_op"]]
    assert len(by_op) == 10 and by_op == sorted(by_op, reverse=True)
    assert 0 < sum(by_op) <= rec["cost_analysis"]["bytes_accessed"]
    assert rec["overrides"] == {"attn_impl": "blocked"}
    ma = rec["memory_analysis"]
    cfg = tconfigs.get_arch("granite-3-2b")
    n = cfg.param_count()
    # one rank holds everything: bf16 params (fp32 norms), fp32 AdamW m and v, the batch
    assert 10 * n <= ma["argument_bytes"] <= 10 * n + 10 * 1e6 + 2 * 256 * 4096 * 4
    assert ma["temp_bytes"] is None
    roof = rec["roofline"]
    # a step does at least 6ND (8ND under remat) and attention's S x S products
    assert roof["flops_per_device"] >= roof["model_flops"]
    assert rec["collectives"] == {} or all(v["count"] >= 0 for v in rec["collectives"].values())
    assert out["bad"]["ok"] is False and "AssertionError" in out["bad"]["error"]
    assert out["files"] == ["granite-3-2b__train_4k__host.json",
                            "granite-3-2b__train_4k__host__bad.json"]


CONSTRAIN = r"""
import sys, json
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.mesh import start_fake_world, make_mesh
start_fake_world(8)
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.models.moe import _constrain
mesh = make_mesh((4, 2), ("data", "model"))
x = DTensor.from_local(torch.empty(8, 4, 8, 16, device="meta"), mesh.device_mesh,
                       [Replicate(), Replicate()], run_check=False)
y = _constrain(x, "data", "model", None, None)
z = _constrain(x, "pod", "model", None, None)          # no such axis: unchanged
p = torch.ones(3)
print(json.dumps({"y": [str(pl) for pl in y.placements], "local": list(y.to_local().shape),
                  "z": z is x, "plain": _constrain(p, "data") is p}))
"""


def test_moe_constrain_redistributes_dtensors_only():
    out = _run(CONSTRAIN)
    assert out["y"] == ["S(0)", "S(1)"] and out["local"] == [2, 2, 8, 16]
    assert out["z"] and out["plain"]


SHARD_DISPATCH = r"""
import sys, json
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh("cpu").device_mesh
rng = np.random.default_rng(0)
def t(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
q, k, v = t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16)
qd, kd, vd = t(2, 1, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16)
kv_len = torch.tensor([3, 8], dtype=torch.int32)
dt = lambda x: DTensor.from_local(x, mesh, [Shard(0), Shard(2)], run_check=False)
seen = []
use_kernel = ops._use_kernel
def spy(x, impl):
    seen.append([type(x).__name__, x.device.type])
    return use_kernel(x, impl)
ops._use_kernel = spy
flash = ops.flash_attention(dt(q), dt(k), dt(v)).full_tensor()
dec = ops.decode_attention(dt(qd), dt(kd), dt(vd), kv_len).full_tensor()
ops._use_kernel = use_kernel
refused = []
for call in (lambda: ops.flash_attention(dt(q), dt(k), dt(v), impl="cuda"),
             lambda: ops.decode_attention(dt(qd), dt(kd), dt(vd), kv_len, impl="cuda")):
    try:
        call()
        refused.append(None)
    except RuntimeError as e:
        refused.append(str(e))
print(json.dumps({
    "seen": seen, "refused": refused,
    "flash": (flash - ops.flash_attention(q, k, v)).abs().max().item(),
    "decode": (dec - ops.decode_attention(qd, kd, vd, kv_len)).abs().max().item()}))
"""


def test_dtensor_shards_take_the_ops_device_dispatch():
    """Attention on a DTensor runs each local shard through ``ops``' own
    dispatch: CPU shards take the plain version (equal to the plain call on
    the whole tensors), and ``impl="cuda"`` on them raises as it does on
    any CPU tensor, so CUDA shards cannot fall back to the plain version."""
    out = _run(SHARD_DISPATCH)
    assert out["seen"] == [["Tensor", "cpu"], ["Tensor", "cpu"]]
    assert out["flash"] == 0.0 and out["decode"] == 0.0
    assert all(r and "needs CUDA tensors" in r for r in out["refused"]), out["refused"]


SSM_PER_SHARD = r"""
import sys, json, os, dataclasses
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import mamba as mb
from repro_torch.models.params import init_params
from repro_torch.utils import tree_map

B, S = 2, 13                    # a ragged last chunk (chunk 8)


def run(rank, world, shape, groups, head_dim, dtype, store_path, out_path):
    if world == 1:
        mesh = make_host_mesh("cpu")
    else:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        mesh = make_mesh(shape, ("data", "model"))
    base = reduced(get_arch("mamba2-130m"))
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm, n_groups=groups,
                                                           head_dim=head_dim or base.ssm.head_dim))
    specs = mb.mamba_specs(cfg)
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    p = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g, dtype=dt),
                 init_params(specs, 0, dt, device="cpu"))
    x = torch.randn(B, S, cfg.d_model, generator=g, dtype=dt)
    x1 = torch.randn(B, 1, cfg.d_model, generator=g, dtype=dt)

    # plain tensors: prefill, one decode step, and the gradients of a loss
    pp = tree_map(lambda t: t.clone().requires_grad_(), p)
    out, cache = mb.mamba_forward(cfg, pp, x, return_cache=True)
    # a plain decode writes the cache it is given in place: it takes a copy,
    # so the prefill's cache stays to be compared
    dec, new = mb.mamba_decode(cfg, pp, x1, {k: v.clone() for k, v in cache.items()})
    (out.pow(2).sum() + dec.pow(2).sum()).backward()
    plain = {"out": out, "conv": cache["conv"], "ssm": cache["ssm"], "dec": dec,
             "new_conv": new["conv"], "new_ssm": new["ssm"]}
    plain_grads = tree_map(lambda t: t.grad, pp)

    # DTensors placed by the sharding rules; the batch over "data"
    dm = mesh.device_mesh
    pd = tree_map(lambda t, s: distribute_tensor(t.detach(), dm, s.placements).requires_grad_(),
                  p, sh.specs_to_shardings(mesh, specs, "dp_tp"))
    xd = distribute_tensor(x, dm, [Shard(0), Replicate()])
    x1d = distribute_tensor(x1, dm, [Shard(0), Replicate()])
    out, cache = mb.mamba_forward(cfg, pd, xd, return_cache=True)
    # the decode cache as the dry-run places it (channels over "model")
    conv = cache["conv"].redistribute(dm, [Shard(0), Shard(2)])
    dec, new = mb.mamba_decode(cfg, pd, x1d, {"conv": conv, "ssm": cache["ssm"]})
    (out.full_tensor().pow(2).sum() + dec.full_tensor().pow(2).sum()).backward()
    got = {"out": out, "conv": cache["conv"], "ssm": cache["ssm"], "dec": dec,
           "new_conv": new["conv"], "new_ssm": new["ssm"]}
    errs = {k: (got[k].full_tensor() - v).abs().max().item() for k, v in plain.items()}
    grads = {k: (pd[k].grad.full_tensor() - plain_grads[k]).abs().max().item()
             / plain_grads[k].abs().max().item() for k in p}
    split = [str(pl) for pl in pd["A_log"].placements]
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"errs": errs, "grads": grads, "split": split,
                       "y": [str(pl) for pl in out.placements],
                       "state": [str(pl) for pl in cache["ssm"].placements]}, f)
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    data, model, groups, tmp = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    head_dim = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    dtype = sys.argv[7] if len(sys.argv) > 7 else "float32"
    world, out_path = data * model, os.path.join(tmp, "out.json")
    if world == 1:
        run(0, 1, (1, 1), groups, head_dim, dtype, None, out_path)
    else:
        import torch.multiprocessing as mp
        mp.spawn(run, args=(world, (data, model), groups, head_dim, dtype, os.path.join(tmp, "store"),
                            out_path), nprocs=world)
    print(open(out_path).read())
"""


@pytest.mark.parametrize("data,model,groups", [(1, 1, 1), (2, 2, 1), (2, 2, 2), (1, 4, 1)])
def test_ssm_mixer_per_shard_equals_plain_tensors(tmp_path, data, model, groups):
    """The mamba mixer on DTensors (its causal conv, SSD scan and decode
    step per shard) against the same weights and inputs as plain tensors:
    on the host mesh (one gloo rank), and on 4 CPU ranks of gloo with the
    batch over "data" and the heads over "model" (B's and C's channels with
    them when there are two groups, replicated when there is one).  The
    prefill output and cache, the decode step and the weights' gradients
    (partial sums over the batch) equal the plain ones."""
    out = _run(SSM_PER_SHARD, str(data), str(model), str(groups), str(tmp_path))
    if model > 1:       # heads split: the output projection leaves a partial sum
        assert out["split"] == ["R", "S(0)"] and out["y"] == ["S(0)", "P(sum)"]
    # one rank: the same ops on the same tensors; four: fp32 sums in another order
    tol = 0.0 if data * model == 1 else 1e-5
    assert all(e <= tol for e in out["errs"].values()), out["errs"]
    assert all(e <= tol for e in out["grads"].values()), out["grads"]


def test_ssm_mixer_per_shard_whole_heads_split_the_batch(tmp_path):
    """One head of 128 (it cannot split over "model" 2, so the rules leave
    it whole) and x whole over "model": the conv and scan take the batch
    over "model" too, so no two ranks scan the same rows, and the values
    and gradients still equal the plain tensors'.  In float64: with one
    head, D's gradient is a single sum over every batch row, position and
    channel, which cancels so far that fp32 sums in another order on two
    ranks land 2e-5 to 1.2e-4 of its value apart (two PyTorch versions);
    in float64 only the scan's fp32 internals differ (about 7e-8)."""
    out = _run(SSM_PER_SHARD, "1", "2", "1", str(tmp_path), "128", "float64")
    assert out["split"] == ["R", "R"] and out["state"] == ["S(0)", "S(0)"]
    assert all(e <= 1e-6 for e in out["errs"].values()), out["errs"]
    assert all(e <= 1e-6 for e in out["grads"].values()), out["grads"]
