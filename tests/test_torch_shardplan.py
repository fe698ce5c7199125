"""The port's intra-call sharding against the JAX package's: the planner's
plans (row ranges for every floor, cap and weight skew), the split/stitch
algebra (bit-identical round trips of fp32, int32 and bf16 leaves, stitches
equal to the reference's, torch tensors split as views), the aggregate-
output guard, the sharded frontend's map, and the facade's ``shard=True``
call with its trace (the parent record books the slowest shard's spans and
a stitch span, and sums to its own wall)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serving import shardplan as ref_plan
from repro_torch import avec
from repro_torch.core.executor import DestinationExecutor, HostRuntime
from repro_torch.core.transport import DirectChannel
from repro_torch.obs import trace as trace_mod
from repro_torch.serving.engine import PipelinedOffloadFrontend, ShardedOffloadFrontend
from repro_torch.serving.shardplan import (RowRange, ShardPlan, ShardPlanner, ShardStitchError,
                                           leading_rows)
from repro_torch.utils import BF16Array, to_numpy_tree


# ---------------------------------------------------------------------------
# plans and leading rows against the reference's
# ---------------------------------------------------------------------------

CASES = [(4096, 256, 4, None), (511, 256, 4, None), (512, 256, 4, None),
         (300, 4, 2, [3.0, 1.0]), (400, 100, 4, [1.0, 1e-9, 1e-9, 1e-9]),
         (4096, 4, 0, None), (4096, 4, 1, None), (400, 4, 4, [1.0, 1.0]),
         (1000, 7, 8, [5.0, 0.5, 2.0, 1.0, 1.0]), (8, 4, 4, [1.0, 1.0]),
         (97, 3, 16, [0.1, 9.0, 0.3]), (1 << 20, 256, 4, [2.0, 1.0, 1.0, 0.5])]


@pytest.mark.parametrize("rows,min_rows,max_shards,weights", CASES)
def test_plans_equal_reference(rows, min_rows, max_shards, weights):
    port = ShardPlanner(min_rows=min_rows, max_shards=max_shards)
    ref = ref_plan.ShardPlanner(min_rows=min_rows, max_shards=max_shards)
    assert port.should_split(rows) == ref.should_split(rows)
    assert port.plan(rows, weights).describe() == ref.plan(rows, weights).describe()
    tree = {"x": np.zeros((rows, 1), np.int8)}
    got, want = port.plan_tree(tree, weights), ref.plan_tree(tree, weights)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.describe() == want.describe()


@pytest.mark.parametrize("tree", [
    {"x": np.zeros((8, 4)), "m": np.zeros((8,), np.int32)},
    {"x": np.zeros((8, 4)), "s": np.float32(1.0)},
    {"x": np.zeros((8, 4)), "y": np.zeros((4, 4))},
    {}, [np.zeros((3, 2)), (np.zeros(3), None)]], ids=["aligned", "rank0", "misaligned",
                                                       "empty", "nested"])
def test_leading_rows_equals_reference(tree):
    assert leading_rows(tree) == ref_plan.leading_rows(tree)


def test_leading_rows_of_tensors_and_bf16():
    assert leading_rows({"x": torch.zeros(6, 3), "h": np.zeros((6, 2), np.uint16)
                         .view(BF16Array)}) == 6
    assert leading_rows({"x": torch.zeros(6, 3), "s": torch.zeros(())}) is None


# ---------------------------------------------------------------------------
# split / stitch
# ---------------------------------------------------------------------------

def _bits(n, cols, seed):
    return np.random.default_rng(seed).integers(0, 1 << 15, (n, cols)).astype(np.uint16)


@pytest.mark.parametrize("min_rows,max_shards", [(2, 3), (3, 2), (1, 4)])
def test_split_stitch_bit_identical_and_equal_reference(min_rows, max_shards):
    bits = _bits(10, 3, min_rows)
    x = {"a": np.arange(40.0, dtype=np.float32).reshape(10, 4), "b": np.arange(10),
         "h": bits.view(BF16Array)}
    rx = {**x, "h": bits.view(ml_dtypes.bfloat16)}
    plan = ShardPlanner(min_rows=min_rows, max_shards=max_shards).plan_tree(x)
    rplan = ref_plan.ShardPlanner(min_rows=min_rows, max_shards=max_shards).plan_tree(rx)
    assert plan.describe() == rplan.describe()
    parts, rparts = plan.split(x), rplan.split(rx)
    assert [leading_rows(p) for p in parts] == [r.rows for r in plan.ranges]
    assert all(isinstance(p["h"], BF16Array) for p in parts)
    out, rout = plan.stitch(parts), rplan.stitch(rparts)
    assert isinstance(out["h"], BF16Array)
    for k in ("a", "b"):
        assert np.array_equal(out[k], x[k]) and out[k].dtype == x[k].dtype
        assert np.array_equal(out[k], rout[k])
    assert np.array_equal(out["h"].view(np.uint16), bits)
    assert np.array_equal(np.asarray(rout["h"]).view(np.uint16), bits)


def test_split_of_tensors_is_views_and_results_stitch():
    """A caller's tensors split as views; the shards' results come back
    from the wire as host arrays and stitch to the whole."""
    x = {"t": torch.arange(24.0).reshape(8, 3), "i": torch.arange(8, dtype=torch.int32)}
    plan = ShardPlanner(min_rows=2, max_shards=3).plan_tree(x)
    parts = plan.split(x)
    assert all(p["t"].data_ptr() == x["t"][r.start].data_ptr()
               for p, r in zip(parts, plan.ranges))
    out = plan.stitch([to_numpy_tree(p) for p in parts])
    assert np.array_equal(out["t"], x["t"].numpy()) and np.array_equal(out["i"], x["i"].numpy())


def test_stitch_rejects_aggregate_outputs():
    plan = ShardPlan(8, [RowRange(0, 0, 4), RowRange(1, 4, 8)])
    with pytest.raises(ShardStitchError):
        plan.stitch([{"loss": np.zeros(())}, {"loss": np.zeros(())}])
    with pytest.raises(ShardStitchError):
        plan.stitch([{"y": np.zeros((4, 2))}, {"y": np.zeros((3, 2))}])
    with pytest.raises(ShardStitchError):
        plan.stitch([{"y": np.zeros((4, 2))}])


# ---------------------------------------------------------------------------
# the sharded frontend and the facade
# ---------------------------------------------------------------------------

def _double(params, state, args):
    return {"y": np.asarray(args["x"]) * 2.0}


def _tiny(work, name):
    return DestinationExecutor({"tiny": {"work": work}}, name=name, device="cpu")


def _frontend(ex, fp="fp"):
    rt = HostRuntime(DirectChannel(ex))
    rt.put_model(fp, "tiny", {"w": np.zeros(1, np.float32)})
    return PipelinedOffloadFrontend(rt, fp, "work")


@pytest.mark.parametrize("planner", [True, False], ids=["planner", "no_planner"])
def test_sharded_map_splits_large_and_passes_small_through(planner):
    exs = [_tiny(_double, f"d{i}") for i in range(2)]
    try:
        fe = ShardedOffloadFrontend([_frontend(ex) for ex in exs],
                                    planner=ShardPlanner(min_rows=4, max_shards=2)
                                    if planner else None)
        big = {"x": np.arange(32.0).reshape(16, 2)}
        small = {"x": np.arange(6.0).reshape(3, 2)}
        out = fe.map({"big": big, "small": small})
        assert np.array_equal(out["big"]["y"], big["x"] * 2.0)
        assert np.array_equal(out["small"]["y"], small["x"] * 2.0)
        st = fe.stats()
        assert (st["split_calls"], st["passthrough_calls"]) == ((1, 1) if planner else (0, 0))
        assert all(v > 0 for v in st["assigned"].values())
    finally:
        for ex in exs:
            ex.shutdown()


_PARAMS = {"w1": np.float32(1.5), "b1": np.float32(-3.0), "w2": np.float32(0.5)}


def _mlp_pool(n, record=None):
    def work(params, state, args):
        x = np.asarray(args["x"])
        if record is not None:
            record.append(int(x.shape[0]))
        return {"y": np.maximum(x * np.asarray(params["w1"]) + np.asarray(params["b1"]), 0.0)
                * np.asarray(params["w2"])}
    return [_tiny(work, f"d{i}") for i in range(n)]


def test_facade_sharded_call_bit_identical_and_spread():
    rows = []
    exs = _mlp_pool(3, record=rows)
    x = {"x": np.arange(1024.0 * 4, dtype=np.float32).reshape(1024, 4)}
    with avec.connect(exs) as client:
        sess = client.session({"a": 1}, _PARAMS, "tiny", destination="d0")
        ref = sess.call("work", x)
        rows.clear()
        out = sess.call("work", x, shard=True)
        assert np.array_equal(np.asarray(ref["y"]), np.asarray(out["y"]))
        st = sess.last_shard_stats
        assert len(st["shards"]) >= 2 and st["failed"] == [] and st["retry_rounds"] == 0
        assert all(r < 1024 for r in rows) and sum(rows) == 1024
    for ex in exs:
        ex.shutdown()


@pytest.mark.parametrize("n_dest,rows", [(2, 8), (1, 2048)], ids=["under_floor", "one_dest"])
def test_facade_sharded_call_falls_through(n_dest, rows):
    seen = []
    exs = _mlp_pool(n_dest, record=seen)
    x = {"x": np.zeros((rows, 2), np.float32)}
    with avec.connect(exs) as client:
        sess = client.session({"a": 1}, _PARAMS, "tiny", destination="d0")
        out = sess.call("work", x, shard=True)
        assert seen == [rows] and np.asarray(out["y"]).shape == (rows, 2)
        assert sess.last_shard_stats is None
    for ex in exs:
        ex.shutdown()


def test_shard_calls_knob_opts_in_by_default(monkeypatch):
    rows = []
    exs = _mlp_pool(2, record=rows)
    monkeypatch.setenv("AVEC_SHARD_CALLS", "1")
    with avec.connect(exs) as client:
        sess = client.session({"a": 1}, _PARAMS, "tiny", destination="d0")
        sess.call("work", {"x": np.zeros((1024, 2), np.float32)})
        assert sess.last_shard_stats is not None and all(r < 1024 for r in rows)
    for ex in exs:
        ex.shutdown()


def test_sharded_trace_books_slowest_shard_and_stitch():
    exs = _mlp_pool(2)
    x = {"x": np.zeros((2048, 4), np.float32)}
    with avec.connect(exs) as client:
        sess = client.session({"a": 1}, _PARAMS, "tiny", destination="d0")
        sess.call("work", x, shard=True)            # warm the sibling frontends
        trace_mod.get_sink().clear()
        sess.call("work", x, shard=True)
        cid = sess.last_shard_stats["call_id"]
        sink = trace_mod.get_sink().recent(16)
        parent = next(t for t in sink if t.call_id == cid)
        kids = [t for t in sink if t.trace_id == parent.trace_id and t is not parent]
        assert len(kids) == len(sess.last_shard_stats["shards"])
        assert all(k.fn.startswith("work[") and k.call_id.startswith(cid + "/r") for k in kids)
        slowest = max(kids, key=lambda k: k.wall_s)
        names = parent.span_names()
        assert "stitch" in names and names[:len(slowest.spans)] == slowest.span_names()
        # finished against its own wall: the spans sum to it, the slowest
        # shard's wall fits inside it
        assert parent.total_span_s() == pytest.approx(parent.wall_s, rel=1e-9, abs=1e-9)
        assert slowest.wall_s <= parent.wall_s
    for ex in exs:
        ex.shutdown()
