"""API interception: the paper's LD_PRELOAD mechanism, Pythonically.

``InterceptionLibrary`` monkey-patches named functions of a target module so
that an *unmodified* application calling e.g. ``repro_torch.models.openpose.
op_forward(...)`` is transparently rerouted to a destination accelerator —
the application source never changes (paper Q1/motivation 4).

``AvecSession`` is the host-side state of one offloaded model: fingerprint,
send-once weight transfer (core.cache semantics), profiled execution cycles,
and the rerouting dispatcher used by the interceptor.
"""
from __future__ import annotations

import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.cache import model_fingerprint
from repro_torch.core.executor import HostRuntime
from repro_torch.core.memory import detach_tree
from repro_torch.core.profiler import AvecProfiler
from repro_torch.obs import trace as _trace
from repro_torch.core.serialization import tree_wire_bytes
from repro_torch.utils import to_numpy_tree


class ArgExtractionError(TypeError):
    """An intercepted call did not match its :class:`ArgSpec` — raised
    instead of silently forwarding the wrong data tree to the destination."""


@dataclass(frozen=True)
class ArgSpec:
    """Explicit extraction of the offloaded data tree from an intercepted
    call's ``(*args, **kwargs)``.

    Exactly one of the three forms applies (checked in order):

    * ``position=i``       — the data tree is ``args[i]``
    * ``keywords=(k, ...)``— the data tree is ``{k: kwargs[k], ...}``
    * ``extract=fn``       — fully custom: ``fn(args, kwargs) -> tree``

    This replaces the old positional convention (``args[2] if len(args) > 2
    else kwargs``) which silently forwarded ``kwargs`` — usually ``{}`` —
    when a caller passed its data positionally but the arity check missed.
    An ArgSpec that doesn't match the actual call raises
    :class:`ArgExtractionError` naming the function and the mismatch."""

    position: Optional[int] = None
    keywords: tuple = ()
    extract: Optional[Callable[[tuple, dict], Any]] = None

    def __call__(self, fn_name: str, args: tuple, kwargs: dict) -> Any:
        if self.position is not None:
            if self.position >= len(args):
                raise ArgExtractionError(
                    f"intercepted call {fn_name}(...) has "
                    f"{len(args)} positional argument(s) but its ArgSpec "
                    f"expects the data tree at position {self.position}; "
                    f"pass the data positionally or fix the ArgSpec "
                    f"(kwargs are never silently substituted)")
            return args[self.position]
        if self.keywords:
            missing = [k for k in self.keywords if k not in kwargs]
            if missing:
                raise ArgExtractionError(
                    f"intercepted call {fn_name}(...) is missing keyword "
                    f"argument(s) {missing} required by its ArgSpec "
                    f"(got {sorted(kwargs)})")
            return {k: kwargs[k] for k in self.keywords}
        if self.extract is not None:
            return self.extract(args, kwargs)
        raise ArgExtractionError(
            f"ArgSpec for {fn_name} is empty: set position=, keywords=, "
            f"or extract=")


class InterceptionLibrary:
    """Replaces ``module.fn_name`` with ``dispatcher(fn_name, orig, *a, **k)``
    for each listed function.  Context-manager; nestable; restores originals
    on exit."""

    def __init__(self, module, fn_names: list[str],
                 dispatcher: Callable[..., Any]) -> None:
        self.module = module
        self.fn_names = list(fn_names)
        self.dispatcher = dispatcher
        self._originals: dict[str, Callable] = {}
        self.installed = False

    def install(self) -> "InterceptionLibrary":
        assert not self.installed
        for name in self.fn_names:
            orig = getattr(self.module, name)
            self._originals[name] = orig

            def make_wrapper(fn_name, original):
                def wrapper(*args, **kwargs):
                    return self.dispatcher(fn_name, original, *args, **kwargs)
                wrapper.__name__ = fn_name
                wrapper.__wrapped__ = original
                return wrapper

            setattr(self.module, name, make_wrapper(name, orig))
        self.installed = True
        return self

    def uninstall(self) -> None:
        for name, orig in self._originals.items():
            setattr(self.module, name, orig)
        self._originals.clear()
        self.installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


class AvecSession:
    """Host-side session against one destination executor.

    * ``ensure_model`` — send-once weight transfer (returns cached=True on a
      fingerprint hit at the destination; the paper's Table III cost happens
      exactly once per (model, destination)).
    * ``call``        — one profiled execution cycle: serialize → send →
      destination compute → return → deserialize, recorded in the profiler's
      GPU/communication buckets.

    ``tenant``/``qos`` (set by the facade's tenant-scoped sessions) ride in
    every ``run`` frame's metadata, driving the destination's fair-share
    drain and per-tenant admission control.

    Result-buffer lifetime: with a pooled transport, zero-copy results alias
    recv-pool slab memory, which the pool keeps pinned as long as the
    application references the arrays — correct, but an application
    hoarding many results pins many slabs.  ``detach_results=True`` hands
    back owning copies *after* the cycle is profiled (releasing the lease
    pins eagerly), the session-layer analogue of the runtime's
    ``copy_results`` (which detaches at unpack instead).
    """

    def __init__(self, cfg: Any, params: Any, runtime: HostRuntime,
                 lib: str, profiler: Optional[AvecProfiler] = None,
                 name: str = "session", detach_results: bool = False) -> None:
        self.cfg = cfg
        self.params = params
        self.runtime = runtime
        self.lib = lib
        self.name = name
        self.fp = model_fingerprint(cfg, params)
        self.profiler = profiler or AvecProfiler()
        self.model_transfer_s: Optional[float] = None
        self.tenant: Optional[str] = None
        self.qos: Optional[dict] = None
        self.detach_results = detach_results
        self._ready = False

    # ------------------------------------------------------------------
    def ensure_model(self) -> bool:
        """Returns True if the model was already resident (cache hit)."""
        if self.runtime.has_model(self.fp):
            self._ready = True
            return True
        t0 = time.perf_counter()
        self.runtime.put_model(self.fp, self.lib, self.params)
        self.model_transfer_s = time.perf_counter() - t0
        self.profiler.record_model_transfer(self.model_transfer_s)
        self._ready = True
        return False

    # ------------------------------------------------------------------
    def call(self, fn: str, args: Any, *, call_id: str | None = None) -> Any:
        if not self._ready:
            self.ensure_model()
        sent0 = self.runtime.bytes_sent
        recv0 = self.runtime.bytes_received
        # facade trace entry point: mint the request-scoped trace id here;
        # the runtime carries it in frame meta and every hop stamps a span
        trace = _trace.start_trace(fn=fn, call_id=call_id)
        t0 = time.perf_counter()
        out = self.runtime.run(self.fp, fn, args,
                               tenant=self.tenant, qos=self.qos,
                               call_id=call_id, trace=trace)
        wall = time.perf_counter() - t0
        _trace.finish_trace(trace, wall)
        compute = self.runtime.last_compute_s
        self.profiler.record_cycle(
            gpu_s=compute,
            comm_s=max(wall - compute, 0.0),
            bytes_sent=self.runtime.bytes_sent - sent0,
            bytes_received=self.runtime.bytes_received - recv0,
            fn=fn)
        # result materialization is the session's lease-release point: the
        # cycle is profiled, so detach (if asked) before the app sees it
        return detach_tree(out) if self.detach_results else out

    # ------------------------------------------------------------------
    def call_async(self, fn: str, args: Any, batchable: bool = False) -> Future:
        """Pipelined execution cycle: submit without waiting, so the next
        frame serializes/transmits while this one computes at the destination
        (requires a :class:`~repro_torch.core.executor.PipelinedHostRuntime`).

        The returned Future resolves to the output tree; the profiler cycle
        is recorded at completion (bytes are payload-tree sizes, since
        concurrent in-flight frames make runtime byte-counter deltas
        unattributable per call)."""
        if not self._ready:
            self.ensure_model()
        args = to_numpy_tree(args)      # host arrays: counted and sent as they go out
        sent = tree_wire_bytes(args)
        t0 = time.perf_counter()
        inner = self.runtime.run_async(self.fp, fn, args, batchable=batchable,
                                       tenant=self.tenant, qos=self.qos)

        def _record(meta: dict, out: Any) -> Any:
            wall = time.perf_counter() - t0
            compute = meta.get("compute_s", 0.0)
            self.profiler.record_cycle(
                gpu_s=compute, comm_s=max(wall - compute, 0.0),
                bytes_sent=sent, bytes_received=tree_wire_bytes(out), fn=fn)
            return detach_tree(out) if self.detach_results else out

        # runtime.chain yields a pump-aware future: waiting on it drives the
        # channel (the pipelined runtime has no reader thread)
        return self.runtime.chain(inner, _record)

    # ------------------------------------------------------------------
    def make_dispatcher(self, offload_fns: dict[str, str]):
        """DEPRECATED positional-convention dispatcher — prefer
        :meth:`make_argspec_dispatcher` with an explicit :class:`ArgSpec`
        per function.

        Functions named in ``offload_fns`` (module fn -> destination lib fn)
        are forwarded assuming the data tree is ``args[2]`` (after the
        library API's (net/cfg, params) leading arguments); all others run
        locally.  A call that matches neither form — fewer than three
        positional arguments and no keywords — raises
        :class:`ArgExtractionError` instead of silently forwarding an empty
        kwargs dict as the data tree (the old behaviour)."""
        warnings.warn(
            "AvecSession.make_dispatcher's positional convention is "
            "deprecated; use make_argspec_dispatcher with an explicit "
            "ArgSpec per function", DeprecationWarning, stacklevel=2)

        def dispatcher(fn_name, original, *args, **kwargs):
            if fn_name in offload_fns:
                # convention: the intercepted call's *data* arguments follow
                # the (net/cfg, params) leading arguments of the library API.
                if len(args) > 2:
                    data_args = args[2]
                elif kwargs:
                    data_args = kwargs
                else:
                    raise ArgExtractionError(
                        f"intercepted call {fn_name}(...) carries no "
                        f"extractable data tree ({len(args)} positional "
                        f"args, no kwargs); the positional convention "
                        f"expects the data at args[2] — use "
                        f"make_argspec_dispatcher with an explicit ArgSpec")
                return self.call(offload_fns[fn_name], data_args)
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            self.profiler.record_other(time.perf_counter() - t0)
            return out
        return dispatcher

    def make_argspec_dispatcher(self, fn_map: dict[str, tuple[str, ArgSpec]]):
        """Dispatcher with per-function explicit extraction: ``fn_map`` maps
        an intercepted module function to ``(destination fn, ArgSpec)``.
        Functions not in the map run locally (host-side kernels), timed into
        the profiler's "Other" bucket.  A call that doesn't match its
        ArgSpec raises :class:`ArgExtractionError` — never a silent
        wrong-tree forward."""
        for name, (remote_fn, spec) in fn_map.items():
            if not isinstance(spec, ArgSpec):
                raise TypeError(
                    f"fn_map[{name!r}] must be (remote_fn, ArgSpec); "
                    f"got {spec!r}")

        def dispatcher(fn_name, original, *args, **kwargs):
            if fn_name in fn_map:
                remote_fn, spec = fn_map[fn_name]
                return self.call(remote_fn, spec(fn_name, args, kwargs))
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            self.profiler.record_other(time.perf_counter() - t0)
            return out
        return dispatcher
