"""Mixture-of-Experts layer: top-k routing with capacity-bounded sort
dispatch, or dropless dispatch (``MoEConfig.dropless``).

The JAX package's algorithm (``repro/models/moe.py``), with the same
arithmetic: routing in fp32, the top-k probabilities renormalised, the
Switch load-balancing aux loss over all tokens; assignments stably sorted
by expert id, each given a position-in-expert by a cumulative-count
subtraction; assignments beyond the per-expert ``capacity`` dropped; rows
written into an (G, E, C, d) buffer that feeds batched per-expert SwiGLU
GEMMs; the combine weighted by the kept, renormalised probabilities.

Two dispatch scopes, selected by ``cfg.moe_sharded_dispatch``: ``False``,
one global group over all B*S tokens (G = 1; the rows of a batch compete
for capacity), and ``True``, one group per batch row (G = B, capacity per
row).  Under grouped dispatch the reference's sharding hints
(``_constrain``: groups over "data", experts over "model") redistribute the
buffers when they are DTensors (the dry-run) and pass anything else.

Two steps are written so that they give the same result on every call:

* dispatch: each kept assignment owns its slot, so the kept rows are
  written with a plain indexed write; dropped ones go to a scratch row past
  the buffer (the reference adds them, zeroed, at slot 0 of their expert,
  which changes no value);
* combine: the reference scatter-adds each assignment's output into its
  token.  A CUDA ``index_add_`` sums in no fixed order, so two identical
  calls could differ in the last bit; here the outputs are gathered back
  into (G, T, k, d) through the inverse of the sort and summed over k.

The dropless dispatch (granite-4.0-h) has no capacity and drops nothing:
the T*k assignments, stably sorted by expert, are the rows of one (T*k, d)
buffer, each expert's end row found on the device, and ``ops.moe_experts``
computes each expert's SwiGLU over its rows only.  Nothing is read back to
the host, so a decode step through it can be captured as a CUDA graph, and a
B-1 decode reads its k experts' weights alone.  The combine is the capacity
path's: each output weighted by its renormalised probability, put back in
(token, j) order, summed over k, then the shared expert's output added.  A
call whose T*k assignments the routing kernel sorts (``moe_route.MAX_ROWS``:
every decode) routes and combines through ``ops.moe_route`` and
``ops.moe_combine``, one launch each on the card; a larger call (a prefill)
runs their plain versions, a chain of small ops whose cost its tokens share.

The Switch aux loss is computed in training (``mode`` "train") and where no
``mode`` is given; a prefill or a decode returns 0.0 in its place, since no
caller reads it.  Training and mode-less calls take the chain: the kernels
keep no router probabilities for the aux loss and have no backward.

In a traced call (``obs.trace``) each MoE layer books three stages inside
the layer's ``ffn``: ``route`` (the router, the top-k and the dispatch into
the expert-ordered buffer), ``experts`` (the routed experts and the
combine) and ``shared`` (the dense residual FFN, where the config has one).
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.moe_route import MAX_ROWS as ROUTE_MAX_ROWS
from repro_torch.models.mlp import apply_mlp, mlp_specs
from repro_torch.models.params import ParamSpec
from repro_torch.obs import trace as _trace

#: profiler range around each MoE layer (routing, dispatch, experts, combine)
MOE_SPAN = "apply_moe"


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff
    specs = {
        "router": ParamSpec((d, E), ("embed", None), "normal", d ** -0.5,
                            dtype=torch.float32),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"),
                            "normal", d ** -0.5),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"),
                          "normal", d ** -0.5),
        "w_down": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"),
                            "normal", f ** -0.5),
    }
    if m.dense_residual:
        specs["dense"] = mlp_specs(cfg)
    return specs


def _capacity(cfg, n_tokens: int) -> int:
    """Rows per expert per group: the reference's rule, rounded up to 8
    with a floor of 8.  It truncates before rounding, so it can fall below
    the balanced load (t 17, e 2, k 1, cf 1.0 gives 8 < 8.5); the port keeps
    that, since a larger C changes which assignments drop."""
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _constrain(x, *entries):
    """The reference's sharding hint: a DTensor is redistributed to
    ``PartitionSpec(*entries)`` on its own mesh; a plain tensor, or a spec
    naming an axis the mesh lacks, passes unchanged (the reference's
    fallback outside a mesh)."""
    if not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import P, to_placements

    mesh = x.device_mesh
    try:
        placements = to_placements(mesh, P(*entries))
    except ValueError:
        return x
    return x.redistribute(mesh, placements)


def route(cfg, xg, router):
    """fp32 routing of xg (G,T,d) -> (probs (G,T,E), top_p (G,T,k)
    renormalised, top_e (G,T,k))."""
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def apply_moe(cfg, p, x, mode: str | None = None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss fp32 scalar, 0.0 unless
    ``mode`` is "train" or None)."""
    with torch.profiler.record_function(MOE_SPAN):
        stages = _trace.CURRENT.stages
        t = time.perf_counter_ns() if stages is not None else 0
        with_aux = mode in (None, "train")
        y, aux = (_apply_dropless if cfg.moe.dropless else _apply_moe)(cfg, p, x, stages, t,
                                                                      with_aux)
        return y.reshape(x.shape), aux


def _aux_loss(cfg, probs, counts, n_assign: int):
    """The Switch load-balancing term over all tokens: E * sum over experts
    of (share of assignments) * (mean router probability)."""
    m = cfg.moe
    me = probs.mean(dim=(0, 1))                                  # (E,)
    fe = counts.sum(dim=0).float() / n_assign
    return m.router_aux_weight * m.num_experts * torch.sum(fe * me)


def _shared(cfg, p, xt, stages, t):
    """The shared expert's output on the tokens xt, or None where the config
    has none -> (it, the next stage's start)."""
    if not cfg.moe.dense_residual:
        return None, t
    y = apply_mlp(cfg, p["dense"], xt)
    return y, (stages.stage("shared", t) if stages is not None else t)


def _apply_dropless(cfg, p, x, stages, t, with_aux):
    """The dropless dispatch over all B*S tokens -> (the routed experts' sum
    plus the shared expert's output (B*S, d), aux)."""
    k = cfg.moe.top_k
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    aux = 0.0
    if with_aux or T * k > ROUTE_MAX_ROWS:
        probs = torch.softmax(xt[None].float() @ p["router"].float(), dim=-1)
        rows, ends, w, order = ref.moe_dispatch(xt, probs[0], k)
        if with_aux:
            counts = torch.diff(ends, prepend=ends.new_zeros(1))
            aux = _aux_loss(cfg, probs, counts[None], T * k)
        combine = ref.moe_combine
    else:
        rows, ends, w, order = ops.moe_route(xt, p["router"], k)
        combine = ops.moe_combine
    if stages is not None:
        t = stages.stage("route", t)
    shared, t = _shared(cfg, p, xt, stages, t)
    dt = x.dtype
    out = ops.moe_experts(rows, p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt), ends)
    y = combine(out, w, order, k, shared)
    if stages is not None:
        stages.stage("experts", t)
    return y, aux


def _apply_moe(cfg, p, x, stages, t, with_aux):
    """The capacity-bounded dispatch -> (the routed experts' sum plus the
    shared expert's output (G, T, d), aux)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    G = B if cfg.moe_sharded_dispatch else 1     # dispatch groups
    T = S if cfg.moe_sharded_dispatch else B * S  # tokens per group
    xg = x.reshape(G, T, d)
    dev = x.device

    # --- routing (fp32) ----------------------------------------------------
    probs, top_p, top_e = route(cfg, xg, p["router"])
    flat_e = top_e.reshape(G, T * k)
    # assignments per (group, expert); one_hot with the class count given
    # (unlike bincount) reads no value back to the host
    counts = F.one_hot(flat_e, E).sum(dim=1)                     # (G,E)
    # load-balancing aux loss (Switch), computed over ALL tokens
    aux = _aux_loss(cfg, probs, counts, G * T * k) if with_aux else 0.0

    # --- capacity-bounded sort dispatch --------------------------------------
    C = _capacity(cfg, T)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, sort_idx)
    # exclusive; kept int64 (a DTensor cumsum reports a float dtype)
    starts = (torch.cumsum(counts, dim=-1) - counts).long()
    pos_in_e = torch.arange(T * k, device=dev)[None] - starts.gather(-1, sorted_e)
    keep = pos_in_e < C
    dest = sorted_e * C + torch.where(keep, pos_in_e, 0)         # (G,TK)
    src_tok = sort_idx // k

    rows = xg.gather(1, src_tok[..., None].expand(-1, -1, d))    # (G,TK,d)
    group = torch.arange(G, device=dev)[:, None] * (E * C)
    slot = torch.where(keep, group + dest, G * E * C)            # drops -> scratch row
    buf = xg.new_zeros(G * E * C + 1, d).index_put((slot.reshape(-1),), rows.reshape(-1, d))
    buf = buf[:-1].reshape(G, E, C, d)
    if cfg.moe_sharded_dispatch:
        buf = _constrain(buf, "data", "model", None, None)
    if stages is not None:
        t = stages.stage("route", t)

    # --- per-expert SwiGLU (batched GEMMs over experts) ----------------------
    dt = buf.dtype
    be = buf.transpose(0, 1).reshape(E, G * C, d)                # (E, G*C, d)
    h = F.silu(torch.bmm(be, p["w_gate"].to(dt))) * torch.bmm(be, p["w_up"].to(dt))
    out = torch.bmm(h, p["w_down"].to(dt)).reshape(E, G, C, d).transpose(0, 1)
    if cfg.moe_sharded_dispatch:
        out = _constrain(out, "data", "model", None, None)
    out_flat = out.reshape(G, E * C, d)

    # --- combine: back to token order, summed over k -------------------------
    w = (top_p.reshape(G, T * k).gather(-1, sort_idx) * keep).to(dt)   # (G,TK)
    contrib = out_flat.gather(1, dest[..., None].expand(-1, -1, d)) * w[..., None]
    inv = torch.argsort(sort_idx, dim=-1)                        # sorted -> (t, j) order
    y = contrib.gather(1, inv[..., None].expand(-1, -1, d)).reshape(G, T, k, d).sum(dim=2)
    if stages is not None:
        t = stages.stage("experts", t)
    shared, _ = _shared(cfg, p, xg, stages, t)
    return (y if shared is None else y + shared), aux
