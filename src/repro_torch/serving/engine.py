"""Continuous-batching serving engine.

Decode-centric design (the AVEC destination's serving loop):
* a fixed pool of B cache *slots* with per-slot positions (the decode step
  scatters each row's new KV at its own index);
* arriving requests are prefilled individually at their exact prompt length
  (no pad pollution of SSM state) and spliced into a free slot of the batched
  cache along axis 1;
* every engine tick decodes ALL active slots in one batched step (greedy over
  the real vocab — pad logits are -inf by construction);
* finished slots (max_new_tokens or eos) free immediately and the next queued
  request is admitted — continuous batching, not static batching.

The engine is transport-agnostic: run it locally, or behind a
DestinationExecutor so AVEC hosts stream requests to it.
``PipelinedOffloadFrontend`` (below) is the host half of that pairing: it
fans independent requests out over one pipelined AVEC channel so transfer
overlaps destination compute, and a coalescing destination micro-batches
them into stacked dispatches.
"""
from __future__ import annotations

import collections
import itertools
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.executor import (DestinationDraining, TenantThrottled,
                                       _throttle_backoff)
from repro_torch.core.memory import detach_tree
from repro_torch.models import model as M
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.serving.shardplan import ShardPlanner
from repro_torch.utils import resolve_device, tree_leaves


@dataclass
class Request:
    rid: str
    prompt: list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    generated: list = field(default_factory=list)
    done: bool = False


def _as_device(x, device) -> torch.Tensor:
    """A context row (tensor or host array) as a tensor on ``device``."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)


class ServingEngine:
    """Continuous batching on one device.  ``params`` is a tree of tensors
    or host arrays (the JAX package's numpy tree loads as it is); it is
    moved to ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``,
    and no quiet fallback).  ``context_fn``, for a VLM: request id -> its
    vision rows (Tv, d), attended by the request's prefill and carried by
    each decode as the reference's does (empty slots get zeros).

    Every slot decodes in one batched step, the empty ones at their stale
    positions, so where rows share a computation (a MoE's global dispatch,
    whose capacity the batch's tokens compete for) a row's output depends
    on its neighbours, as it does in the reference's engine."""

    def __init__(self, cfg, params, *, max_batch: int = 4, max_len: int = 256,
                 context_fn=None, device="cuda") -> None:
        assert cfg.family != "encdec", "engine currently targets decoder LMs"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = from_numpy_tree(params, self.device)
        self.B = max_batch
        self.max_len = max_len
        self.context_fn = context_fn  # optional: rid -> vision context row
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)
        self.last_token = np.zeros(max_batch, np.int32)
        # the batched cache is fp32 whatever the compute dtype, as in the
        # reference; decode writes into it in place
        self.cache = M.init_cache(cfg, max_batch, max_len, torch.float32,
                                  device=self.device)
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _context(self, rid):
        return _as_device(self.context_fn(rid), self.device)

    @torch.inference_mode()
    def _decode(self, params, cache, tokens, pos, context=None):
        batch = {"tokens": tokens, "pos": pos}
        if context is not None:
            batch["vision"] = context
        return M.decode_step(self.cfg, params, cache, batch)

    @torch.inference_mode()
    def _prefill(self, params, tokens, context=None):
        batch = {"tokens": tokens}
        if context is not None:
            batch["vision"] = context
        return M.prefill(self.cfg, params, batch, self.max_len, cache_dtype=torch.float32)

    def _prefill_fn(self, plen: int):
        """The prefill for a prompt of ``plen`` tokens.  Eager calls need no
        per-length compile, so every length shares one function."""
        del plen
        return self._prefill

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.B):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            tokens = torch.tensor(np.array(req.prompt, np.int32)[None],
                                  device=self.device)
            ctx = self._context(req.rid)[None] if self.context_fn else None
            logits, cache1 = self._prefill(self.params, tokens, ctx)
            # splice the single-row cache (compute dtype) into the batched
            # cache at `slot` on axis 1, cast to the batched cache's dtype:
            # every leaf of every layer, KV, conv/ssm and cross_k/cross_v
            for big, one in zip(tree_leaves(self.cache), tree_leaves(cache1)):
                big[:, slot].copy_(one[:, 0])
            nxt = int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))
            self.slots[slot] = req
            self.pos[slot] = len(req.prompt)
            self.last_token[slot] = nxt
            req.generated.append(nxt)
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and req.generated[-1] == req.eos_id)):
            req.done = True
            self.slots[slot] = None

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Admit + one batched decode step.  Returns #active slots.  Empty
        slots decode too, at their stale positions: their rows are
        overwritten by the next admission's splice."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        tokens = torch.tensor(self.last_token[:, None], device=self.device)
        pos = torch.tensor(self.pos, device=self.device)
        ctx = None
        if self.context_fn:
            rows = [self._context(r.rid) if r else None for r in self.slots]
            zeros = torch.zeros_like(rows[active[0]])
            ctx = torch.stack([zeros if row is None else row for row in rows])
        logits, self.cache = self._decode(self.params, self.cache, tokens, pos, ctx)
        nxt = torch.argmax(logits[:, 0, :self.cfg.vocab_size], dim=-1).cpu().numpy()
        for i in active:
            self.pos[i] += 1
            self.last_token[i] = nxt[i]
            self.slots[i].generated.append(int(nxt[i]))
            self._maybe_finish(i)
        self.steps += 1
        return len(active)

    def run(self, max_ticks: int = 10_000) -> dict:
        """Drain queue + slots; returns {rid: generated tokens}."""
        done: dict[str, list] = {}
        reqs = list(self.queue)
        for _ in range(max_ticks):
            self._admit()
            if all(r is None for r in self.slots) and not self.queue:
                break
            self.tick()
        for r in reqs:
            done[r.rid] = r.generated
        return done


# ---------------------------------------------------------------------------
# Pipelined AVEC serving frontend (host side)
# ---------------------------------------------------------------------------

class PipelinedOffloadFrontend:
    """Streams independent serving requests to a remote engine/library over a
    :class:`~repro_torch.core.executor.PipelinedHostRuntime`.

    Up to the runtime's ``max_in_flight`` requests are on the wire at once
    (request k+1 serializes while request k computes at the destination).
    Only stateless per-request ops belong here (score/prefill of independent
    prompts, vision encoders) — stateful decode streams must stay ordered on
    one session.

    ``batchable=True`` lets a coalescing
    :class:`~repro_torch.core.executor.DestinationExecutor` stack compatible
    requests into one device dispatch — but coalescing happens across
    *concurrent* server-side calls, and a single TCP connection is served
    serially, so it only pays off when several frontends/connections hit the
    same destination; over one connection it just adds the coalescing window
    to each request's latency.  Hence the default is False.

    ``tenant``/``qos`` ride in every request's frame metadata: the
    destination drains tenants fairly (weighted deficit-round-robin with
    priority classes) and may answer ``TenantThrottled`` at its per-tenant
    admission cap.  The sync-runtime fallback retries that with jitter
    inside ``HostRuntime.run``; on the pipelined path a raw :meth:`submit`
    future surfaces it, and :meth:`map`'s gather owns the jittered
    re-submit loop (bounded by the runtime's ``throttle_retries``) so a
    fan-out over a capped tenant degrades to backoff, not failure.

    ``detach_results=True`` hands gathered results back as owning copies,
    releasing recv-pool lease pins at materialization time — the frontend
    analogue of the session-layer knob (a serving caller that buffers many
    responses must not pin the runtime's recv slabs; zero-copy views are
    the default)."""

    def __init__(self, runtime, fp: str, fn: str, *,
                 batchable: bool = False, tenant: Optional[str] = None,
                 qos: Optional[dict] = None,
                 detach_results: bool = False) -> None:
        self.runtime = runtime
        self.fp = fp
        self.fn = fn
        self.batchable = batchable
        self.tenant = tenant
        self.qos = qos
        self.detach_results = detach_results
        self._lock = _sanitize.make_lock("PipelinedOffloadFrontend._lock")
        self.submitted = 0                              # guarded-by: _lock
        self._pool: Optional[ThreadPoolExecutor] = None  # guarded-by: _lock

    def submit(self, args: Any, *, call_id: Optional[str] = None,
               trace: Any = None) -> Future:
        """Async submit; Future resolves to the output tree (waiting on it
        pumps the channel — the pipelined runtime has no reader thread).

        ``call_id``/``trace`` ride through to the runtime so a sharded
        sub-call keeps its range-keyed replay-dedup identity and stamps
        its spans into the parent trace's child record.

        A synchronous runtime (no ``run_async``: a negotiated-down peer or
        a request-only channel) degrades to one worker thread per frontend:
        requests on THIS destination serialize, but shards on other
        destinations still overlap — the facade's multi-destination ``map``
        stays concurrent end to end."""
        with self._lock:
            self.submitted += 1
        if hasattr(self.runtime, "run_async"):
            inner = self.runtime.run_async(self.fp, self.fn, args,
                                           batchable=self.batchable,
                                           tenant=self.tenant, qos=self.qos,
                                           call_id=call_id, trace=trace)
            return self.runtime.chain(inner, self._materialize)
        with self._lock:    # lazy worker: don't double-create under racers
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1)
            pool = self._pool
        return pool.submit(self._run_sync, args, call_id, trace)

    def _materialize(self, meta: dict, tree: Any) -> Any:
        return detach_tree(tree) if self.detach_results else tree

    def _run_sync(self, args: Any, call_id: Optional[str] = None,
                  trace: Any = None) -> Any:
        out = self.runtime.run(self.fp, self.fn, args,
                               batchable=self.batchable,
                               tenant=self.tenant, qos=self.qos,
                               call_id=call_id, trace=trace)
        return self._materialize({}, out)

    def map(self, requests: dict) -> dict:
        """Submit ``{rid: args}`` keeping the pipeline full; gather all.
        A request bounced by ``TenantThrottled`` is re-submitted with
        jittered backoff (the pipelined path's retry loop — run_async is
        single-attempt by design)."""
        futs = {rid: self.submit(args) for rid, args in requests.items()}
        return {rid: self.gather(fut, requests[rid])
                for rid, fut in futs.items()}

    def gather(self, fut: Future, args: Any, *,
               call_id: Optional[str] = None, trace: Any = None) -> Any:
        """Resolve one :meth:`submit` future, re-submitting on
        ``TenantThrottled`` with jittered backoff.  Only the pipelined path
        retries here — the sync-runtime fallback already retried inside
        ``HostRuntime.run``, and stacking a second loop on top would square
        the attempt count.  A retried submit keeps the original ``call_id``
        (a throttled request was never admitted, so there is no replay
        entry to collide with — and a shard retry MUST keep its id for
        at-least-once dedup)."""
        retries = (getattr(self.runtime, "throttle_retries", 0)
                   if hasattr(self.runtime, "run_async") else 0)
        attempt = 0
        while True:
            try:
                return fut.result()
            except TenantThrottled as e:
                if attempt >= retries:
                    raise
                time.sleep(_throttle_backoff(attempt, e.retry_after_s))
                attempt += 1
                fut = self.submit(args, call_id=call_id, trace=trace)

    def stats(self) -> dict:
        """Frontend + data-plane counters: the runtime's adaptive window,
        backpressure stalls, and byte totals (see
        ``repro_torch.core.executor`` module docstring), plus ``submitted``."""
        rt_stats = (self.runtime.stats()
                    if hasattr(self.runtime, "stats") else {})
        return {"submitted": self.submitted, **rt_stats}

    def bind_metrics(self, reg: "_obs_metrics.MetricsRegistry",
                     **labels) -> None:
        """Expose this frontend on ``reg`` as scrape-time metric views:
        ``avec_frontend_submitted_total`` plus the underlying runtime's
        window/stall/byte gauges (when the runtime has a ``stats()``
        surface).  Reads happen at scrape, not on the submit path."""
        reg.counter("avec_frontend_submitted_total",
                    "Requests submitted through an offload frontend.").bind(
            lambda: float(self.submitted), op=self.fn, **labels)
        if hasattr(self.runtime, "stats"):
            _obs_metrics.bind_runtime(reg, self.runtime, **labels)

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)


class ShardedOffloadFrontend:
    """Fans independent requests across several destination frontends (the
    ROADMAP's *sharded destinations* step): one
    :class:`PipelinedOffloadFrontend` per destination, requests assigned
    round-robin, every shard's pipeline kept full concurrently.

    The shard router needs no new wire format — vectored frames are already
    per-request, so sharding is purely a host-side assignment problem.
    Results gather back under their request ids regardless of which shard
    (or in what order) served them.

    Drain-aware: a shard that bounces a request with
    :class:`~repro_torch.core.executor.DestinationDraining` (zero-downtime exit)
    is retired from the rotation and the bounced request re-routes to a
    remaining shard — the fan-out completes with zero dropped requests as
    long as one shard stays admitting.

    With a :class:`~repro_torch.serving.shardplan.ShardPlanner` attached,
    :meth:`map` additionally row-splits any single oversized request
    across the shards (intra-call sharding) and stitches its sub-results
    back in range order.  A request whose leading axis does not clear the
    planner's per-shard row floor passes through whole — never as
    degenerate slivers — and unsplittable trees (rank-0 or row-misaligned
    leaves) always pass through."""

    def __init__(self, frontends: list, names: Optional[list] = None,
                 planner: Optional["ShardPlanner"] = None) -> None:
        if not frontends:
            raise ValueError("sharded frontend needs at least one shard")
        self.frontends = list(frontends)
        self.names = list(names) if names is not None else [
            f"shard{i}" for i in range(len(frontends))]
        self.planner = planner
        self._lock = _sanitize.make_lock("ShardedOffloadFrontend._lock")
        self.assigned = [0] * len(self.frontends)  # guarded-by: _lock
        self.served_by: dict = {}   # guarded-by: _lock (last map: rid -> shard(s) that answered)
        self.drained: set = set()   # guarded-by: _lock (shards retired by a drain)
        self.rerouted = 0           # guarded-by: _lock (moved off a draining shard)
        self.split_calls = 0        # guarded-by: _lock (requests row-split)
        self.passthrough_calls = 0  # guarded-by: _lock (too small / unsplittable)

    def _active(self) -> list:  # callers hold _lock
        return [i for i in range(len(self.frontends))
                if i not in self.drained]

    def _route(self) -> int:
        """Pick the least-loaded admitting shard and count the assignment
        (one atomic route decision — concurrent submitters must not both
        pick the momentarily-least-loaded shard)."""
        with self._lock:
            active = self._active()
            if not active:
                raise DestinationDraining(
                    "all shards are draining", destination="*")
            i = min(active, key=lambda j: self.assigned[j])
            self.assigned[i] += 1
            return i

    def submit(self, args: Any) -> Future:
        """Route one request to the least-loaded admitting shard."""
        return self.frontends[self._route()].submit(args)

    def _gather_one(self, i: int, fut: Future, args: Any):
        """Resolve one shard future; a draining bounce retires the shard
        and re-submits on the least-loaded remaining one.  -> (index of
        the shard that answered, result)."""
        while True:
            try:
                if hasattr(self.frontends[i], "gather"):
                    return i, self.frontends[i].gather(fut, args)
                return i, fut.result()
            except DestinationDraining:
                with self._lock:
                    self.drained.add(i)
                i = self._route()   # raises when nowhere left to re-route
                with self._lock:
                    self.rerouted += 1
                fut = self.frontends[i].submit(args)

    def _plan(self, args: Any):
        """Intra-call plan for one request, or ``None`` to pass it through
        whole (no planner, too few rows for the per-shard floor, or an
        unsplittable tree).  A 1-row-sliver "split" is never produced —
        the planner's floor (``shard_min_rows``) sees to that."""
        if self.planner is None:
            return None
        weights = [1.0] * max(len(self.frontends) - len(self.drained), 1)
        plan = self.planner.plan_tree(args, weights)
        with self._lock:
            if plan is None:
                self.passthrough_calls += 1
            else:
                self.split_calls += 1
        return plan

    def map(self, requests: dict) -> dict:
        """Round-robin ``{rid: args}`` over the shards, gather all results.
        Submission interleaves shards so every destination's pipeline fills
        before any result is awaited.  TenantThrottled bounces retry on the
        shard that served them (each frontend's own jittered gather);
        DestinationDraining bounces re-route to a remaining shard.

        When a planner is attached, an oversized request is row-split so
        its ranges compute on different destinations concurrently, then
        stitched back in range order — the caller still sees one result
        per rid, bit-identical to the unsharded tree for row-aligned
        functions.  ``stats()["served_by"]`` names, for each rid of the
        last map, the shard that answered it (after any re-route), or the
        shards of its ranges in range order."""
        rr = itertools.cycle(range(len(self.frontends)))
        futs = {}
        with self._lock:
            self.served_by = {}
        for rid, args in requests.items():
            plan = self._plan(args)
            if plan is not None:
                subs = []
                for part in plan.split(args):
                    i = self._route()   # least-loaded: ranges spread out
                    subs.append((i, self.frontends[i].submit(part), part))
                futs[rid] = (plan, subs)
                continue
            with self._lock:
                i = next(rr)
                while i in self.drained \
                        and len(self.drained) < len(self.frontends):
                    i = next(rr)    # skip shards already known draining
                self.assigned[i] += 1
            futs[rid] = (None, [(i, self.frontends[i].submit(args), args)])
        out = {}
        for rid, (plan, subs) in futs.items():
            done = [self._gather_one(i, fut, part)
                    for (i, fut, part) in subs]
            parts = [r for _, r in done]
            names = [self.names[i] for i, _ in done]
            with self._lock:
                self.served_by[rid] = names[0] if plan is None else names
            out[rid] = parts[0] if plan is None else plan.stitch(parts)
        return out

    def stats(self) -> dict:
        """Per-shard frontend/data-plane counters keyed by shard name."""
        return {"assigned": dict(zip(self.names, self.assigned)),
                "served_by": dict(self.served_by),
                "drained": sorted(self.names[i] for i in self.drained),
                "rerouted": self.rerouted,
                "split_calls": self.split_calls,
                "passthrough_calls": self.passthrough_calls,
                "shards": {n: fe.stats()
                           for n, fe in zip(self.names, self.frontends)}}


# ---------------------------------------------------------------------------
# Reference: sequential (unbatched) greedy generation, for equivalence tests
# ---------------------------------------------------------------------------


@torch.inference_mode()
def generate_sequential(cfg, params, prompt: list, max_new_tokens: int,
                        max_len: int = 256, context=None, device="cuda") -> list:
    """Greedy tokens of one request, prefilled and decoded alone.
    ``context``: a VLM request's vision rows (Tv, d)."""
    dev = resolve_device(device)
    params = from_numpy_tree(params, dev)
    tokens = torch.tensor(np.array(prompt, np.int32)[None], device=dev)
    batch = {"tokens": tokens}
    if context is not None:
        context = _as_device(context, dev)[None]
        batch["vision"] = context
    logits, cache = M.prefill(cfg, params, batch, max_len, cache_dtype=torch.float32)
    out = [int(torch.argmax(logits[0, -1, :cfg.vocab_size]))]
    pos = len(prompt)
    for _ in range(max_new_tokens - 1):
        db = {"tokens": torch.tensor([[out[-1]]], dtype=torch.int32, device=dev),
              "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}
        if context is not None:
            db["vision"] = context
        logits, cache = M.decode_step(cfg, params, cache, db)
        out.append(int(torch.argmax(logits[0, 0, :cfg.vocab_size])))
        pos += 1
    return out
