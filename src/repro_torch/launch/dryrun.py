"""Production dry-run: run every (arch x shape x mesh) cell once on meta
tensors placed on the production mesh, and count what one device would do.

The process group comes first: ``main`` starts it before it builds
anything (the ``fake`` backend's 512 ranks for the production meshes, a
one-rank group for ``--mesh host``), as the reference sets its XLA flag
before it imports JAX.

Per cell this script:
  1. builds params, optimizer state and inputs (and caches) as ``meta``
     tensors: shapes and dtypes, no storage;
  2. derives each one's placements from the logical-axis rules
     (``distributed/sharding.py``) and makes it a DTensor on the mesh;
  3. runs the step once on them under ``implicit_replication()``,
     ``CommDebugMode`` and a per-device cost counter: train = forward,
     backward (remat's recompute included) and the optimizer update; or
     prefill; or one decode step;
  4. records the memory and cost analyses, the collectives and the three
     roofline terms (``launch/roofline.py``), and writes one JSON record
     under ``--out``.

What the counts are:
  * ``memory_analysis``: ``argument_bytes`` and ``output_bytes`` are the
    exact sums of the local shards' bytes on one device; ``temp_bytes`` is
    not tracked (null), nor is ``code_bytes`` (there is no compiled code).
  * ``cost_analysis`` is per device.  Each op is counted at the DTensor
    level (global shapes) and divided by the product of the mesh sizes over
    which its output is ``Shard`` or ``Partial``; a ``Replicate`` output's
    work is done on every rank.  What the model runs per shard
    (``local_map``: attention, the embedding lookup, the decode cache
    write) counts as it runs, on one device's shards.  FLOPs are those of the matmuls,
    convolutions and attention ops in ``torch.utils.flop_counter``'s table;
    bytes are per op, each input read once and each output written once
    (views and allocations move none).  That is an eager, unfused count,
    larger than XLA's fused one.  On meta tensors the ops dispatch to the
    plain versions (a CUDA kernel is not called), so attention counts the
    full S x S products, as the reference's naive ``sdpa`` does.
  * ``cost_method`` is ``"counted"``: every op of every block runs once,
    so the reference's k = 1, 2, 4 extrapolation has nothing to do;
    ``--exact`` is accepted and changes nothing.
  * ``--attn-impl``, ``--attn-mixed`` and ``--attn-block-q`` are accepted
    and recorded in ``overrides``; this package's attention always goes
    through ``kernels.ops``.
  * ``bytes_by_op``: the ten kinds of op that move the most of those
    bytes (name, output placements or "per shard", output shape), each
    with its calls and bytes, to tell where two PyTorch versions' eager
    plans part.
  * ``compile_s`` is the time to build and place the cell, and
    ``cost_compile_s`` the time of the counted step.

Usage (no card; fake ranks):
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every applicable cell
  python -m repro_torch.launch.dryrun --all --mesh multi
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \\
      --mesh host [--device cpu]                       # one real rank
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \
      --mesh host --global-batch 8 --seq-len 256       # a cut shape
  ... [--profile fsdp_tp] [--xent-impl chunked] [--tag x] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, shape_applicable
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, start_fake_world
from repro_torch.launch.roofline import (COLLECTIVE_KINDS, analyze, model_flops_6nd,
                                        tally_collectives)
from repro_torch.models import model as M
from repro_torch.models import params as pm
from repro_torch.optim.optimizer import OptimizerConfig, opt_state_specs
from repro_torch.train.steps import make_train_step
from repro_torch.utils import tree_leaves, tree_map

DEFAULT_OUT = "chipwork/dryrun"


def _ocfg_for(cfg) -> OptimizerConfig:
    return OptimizerConfig(name=cfg.optimizer)


# ---------------------------------------------------------------------------
# Cell builders: (fn, meta args, shardings of the args)
# ---------------------------------------------------------------------------

def build_cell(cfg, shape, mesh, profile: str):
    pspecs = M.param_specs(cfg)
    params_abs = pm.abstract_params(pspecs, getattr(torch, cfg.param_dtype))
    params_sh = sh.specs_to_shardings(mesh, pspecs, profile)
    batch_abs = M.input_specs(cfg, shape)
    batch_sh = sh.input_shardings(mesh, cfg, batch_abs)

    if shape.kind == "train":
        ocfg = _ocfg_for(cfg)
        ospecs = opt_state_specs(ocfg, pspecs)
        opt_abs = pm.abstract_params(ospecs, torch.float32)
        opt_sh = sh.specs_to_shardings(mesh, ospecs, profile)
        step = make_train_step(cfg, ocfg)

        def train_fn(params, opt_state, batch):
            return step(params, opt_state, batch, 0)

        return train_fn, (params_abs, opt_abs, batch_abs), (params_sh, opt_sh, batch_sh)

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return M.prefill(cfg, params, batch, shape.seq_len)

        return prefill_fn, (params_abs, batch_abs), (params_sh, batch_sh)

    # decode
    cache_abs = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cache_sh = sh.cache_shardings(mesh, cfg, cache_abs, shape.global_batch, profile)

    def decode_fn(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch)

    return decode_fn, (params_abs, cache_abs, batch_abs), (params_sh, cache_sh, batch_sh)


# ---------------------------------------------------------------------------
# Placement and counting
# ---------------------------------------------------------------------------

def local_shape(shape, placements, mesh) -> tuple:
    """The shape of one device's shard (the rules shard only on exact
    divisibility)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for size, p in zip(mesh.shape.values(), placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide by {size}")
            out[p.dim] //= size
    return tuple(out)


def place(tree, shardings):
    """Meta tensors -> DTensors on the mesh, each with its placements; the
    local tensor is the shard's ``meta`` stand-in."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t, s):
        # a mesh axis of size 1 splits nothing: Replicate there is the same
        # layout, and DTensor then needs no rule for views of that dim
        placements = tuple(Replicate() if size == 1 else p
                           for size, p in zip(s.mesh.shape.values(), s.placements))
        local = torch.empty(local_shape(t.shape, placements, s.mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, s.mesh.device_mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_map(one, tree, shardings)


def local_bytes(tree) -> int:
    """Bytes of one device's shards of every tensor leaf (a plain tensor
    counts whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size"}


def _shard_factor(out) -> int:
    """Product of the mesh sizes over which the first DTensor of ``out`` is
    ``Shard`` or ``Partial`` (1 for a plain or replicated output)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    for t in torch.utils._pytree.tree_leaves(out):
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                             if isinstance(p, (Shard, Partial)))
    return 1


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _op_key(name: str, out) -> str:
    """An op's kind in ``bytes_by_op``: its name, its output's placements
    ("per shard" for a plain tensor) and shape."""
    from torch.distributed.tensor import DTensor

    t = next((t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)),
             None)
    if t is None:
        return name
    where = ("(" + ", ".join(str(p) for p in t.placements) + ")"
             if isinstance(t, DTensor) else "per shard")
    return f"{name} {where} {tuple(t.shape)}"


def _contiguous_shard(t):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local().contiguous(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


def _name_op(e: Exception, func, args) -> None:
    """Name the op that failed, with its tensors, in the record's trace."""
    e.add_note(f"dry-run op {func} on " + "; ".join(
        f"{tuple(t.shape)} {t.dtype} stride {t.stride()} {getattr(t, 'placements', 'plain')}"
        for t in torch.utils._pytree.tree_leaves(args) if isinstance(t, torch.Tensor)))


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs and bytes of every op, counted at the DTensor level
    and divided by the output's shard factor (module docstring).  Entered
    after ``CommDebugMode``, it sees each op before DTensor lowers it; the
    local ops DTensor issues, collectives included, go on to
    ``CommDebugMode``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if func is not torch.ops.aten.view.default or "view size is not" not in str(e):
                _name_op(e, func, args)
                raise
            # a DTensor whose shard is not contiguous, as a redistribution
            # over an inner dim leaves it in some PyTorch versions: the same
            # view of the same values, its shard made contiguous
            out = func(_contiguous_shard(args[0]), *args[1:], **kwargs)
        except Exception as e:
            _name_op(e, func, args)
            raise
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet.__name__ in _FREE_OPS or func.is_view:
            return out
        div = _shard_factor(out)
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out) / div
        nbytes = (_tensor_bytes((args, kwargs)) + _tensor_bytes(out)) / div
        self.bytes += nbytes
        self.ops += 1
        key = _op_key(packet.__name__, out)
        calls, total = self.by_op.get(key, (0, 0.0))
        self.by_op[key] = (calls + 1, total + nbytes)
        return out


def _collective_mode():
    """``CommDebugMode`` that also keeps each collective's result bytes."""
    from torch.distributed.tensor.debug import CommDebugMode

    class Collectives(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.calls: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if (out is not NotImplemented and not isinstance(func, torch._ops.HigherOrderOperator)
                    and func.namespace in ("_c10d_functional", "c10d_functional")
                    and func._overloadpacket.__name__ in COLLECTIVE_KINDS):
                self.calls.append((func._overloadpacket.__name__, _tensor_bytes(out)))
            return out

    return Collectives()


def count_cell(cfg, shape, mesh, profile: str) -> dict:
    """Build the cell on ``mesh``, run it once counted -> memory, costs,
    collectives and the two times."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    fn, args, shardings = build_cell(cfg, shape, mesh, profile)
    dargs = tuple(place(a, s) for a, s in zip(args, shardings))
    # before the step: a decode step converts a conv cache leaf in its dict
    arg_bytes = local_bytes(dargs)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with implicit_replication(), _collective_mode() as comm, CostCounter() as cost:
        out = fn(*dargs)
    count_s = time.perf_counter() - t0
    coll, by_type = tally_collectives(comm.calls)
    top = sorted(cost.by_op.items(), key=lambda kv: -kv[1][1])[:10]
    return {"compile_s": build_s, "cost_compile_s": count_s,
            "memory_analysis": {"argument_bytes": arg_bytes,
                                "output_bytes": local_bytes(out),
                                "temp_bytes": None, "code_bytes": None},
            "flops": cost.flops, "bytes": cost.bytes, "coll": coll, "by_type": by_type,
            "ops": cost.ops,
            "bytes_by_op": [{"op": k, "calls": n, "bytes": b} for k, (n, b) in top]}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

MESH_CHIPS = {"single": 256, "multi": 512, "host": 1}


def run_cell(arch: str, shape_name: str, mesh_name: str, profile: str, overrides: dict,
             out_dir: str, tag: str = "", exact: bool = False, device="cuda",
             shape_overrides: dict | None = None) -> dict:
    """One cell -> its record.  ``shape_overrides`` cuts the shape
    (``seq_len``, ``global_batch``) and is recorded when given."""
    del exact   # every op is counted: nothing to extrapolate
    cfg = dataclasses.replace(get_arch(arch), **overrides)
    shape = dataclasses.replace(SHAPES[shape_name], **(shape_overrides or {}))
    chips = MESH_CHIPS[mesh_name]
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "profile": profile, "overrides": overrides, "tag": tag,
                    "chips": chips}
    if shape_overrides:
        record["shape_overrides"] = shape_overrides
    if not shape_applicable(cfg, shape):
        record["ok"] = False
        record["skipped"] = ("long_500k requires a sub-quadratic decode path; "
                             f"{arch} is full-attention")
        _write(record, out_dir)
        return record
    try:
        mesh = (make_host_mesh(device) if mesh_name == "host"
                else make_production_mesh(multi_pod=mesh_name == "multi"))
        costs = count_cell(cfg, shape, mesh, profile)
        record["compile_s"] = costs["compile_s"]
        record["memory_analysis"] = costs["memory_analysis"]
        record["cost_compile_s"] = costs["cost_compile_s"]
        record["cost_method"] = "counted"
        record["cost_analysis"] = {"flops": costs["flops"], "bytes_accessed": costs["bytes"]}
        record["collectives"] = costs["by_type"]
        record["bytes_by_op"] = costs["bytes_by_op"]
        mf = model_flops_6nd(cfg, shape)
        roof = analyze(costs["flops"], costs["bytes"], costs["coll"], mf, chips)
        record["roofline"] = roof.to_dict()
        record["ok"] = True
        args_gb = record["memory_analysis"]["argument_bytes"] / 1e9
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({profile}"
              f"{'+' + tag if tag else ''}): OK  "
              f"compute={roof.compute_s*1e3:.2f}ms mem={roof.memory_s*1e3:.2f}ms "
              f"coll={roof.collective_s*1e3:.2f}ms dominant={roof.dominant} "
              f"args/dev={args_gb:.2f}GB build={record['compile_s']:.1f}s "
              f"count={record['cost_compile_s']:.1f}s ({costs['ops']} ops)", flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["trace"] = traceback.format_exc()[-6000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED {record['error'][:300]}",
              flush=True)
    _write(record, out_dir)
    return record


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{record['tag']}" if record.get("tag") else ""
    prof = f"__{record['profile']}" if record.get("profile", "dp_tp") != "dp_tp" else ""
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{prof}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "host"])
    ap.add_argument("--device", default="cuda",
                    help="the host mesh's device (--mesh host only)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--profile", default="dp_tp",
                    choices=["dp_tp", "fsdp_tp", "dp_tp_hd", "fsdp_tp_hd"])
    ap.add_argument("--attn-impl", default=None, choices=["naive", "blocked"])
    ap.add_argument("--xent-impl", default=None, choices=["full", "chunked"])
    ap.add_argument("--attn-block-q", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["on", "off"])
    ap.add_argument("--attn-mixed", action="store_true")
    ap.add_argument("--moe-sharded", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="accepted for the reference's CLI; every op is counted anyway")
    ap.add_argument("--seq-len", type=int, default=None, help="cut the shape's sequence")
    ap.add_argument("--global-batch", type=int, default=None, help="cut the shape's batch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --arch and --shape, or --all")

    # the process group before anything is built
    if args.mesh == "host":
        make_host_mesh(args.device)
    else:
        start_fake_world()

    overrides: dict = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if args.xent_impl:
        overrides["xent_impl"] = args.xent_impl
    if args.attn_block_q:
        overrides["attn_block_q"] = args.attn_block_q
    if args.remat:
        overrides["remat"] = args.remat == "on"
    if args.attn_mixed:
        overrides["attn_mixed"] = True
    if args.moe_sharded:
        overrides["moe_sharded_dispatch"] = True

    shape_overrides = {k: v for k, v in (("seq_len", args.seq_len),
                                         ("global_batch", args.global_batch)) if v}
    # the assigned architectures: granite-4.0-h-small's dropless MoE has no
    # per-shard rule on the dry-run's DTensors
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"],
              "host": ["host"]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for mesh_name in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mesh_name, args.profile, overrides, args.out,
                               args.tag, exact=args.exact, device=args.device,
                               shape_overrides=shape_overrides)
                if rec.get("skipped"):
                    n_skip += 1
                elif rec["ok"]:
                    n_ok += 1
                else:
                    n_fail += 1
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
