"""The port's cluster layer against the JAX package's: consistent-hash
placement and preference lists (a mixed fleet must agree on primaries),
membership sync, warm replica groups, and, through the port's facade at
reduced granite-3-2b (float32, on the CPU), sticky hash placement,
zero-downtime drain with a warm re-home, a sharded map routed around a
draining shard, and the chaos schedules: a killed ack and a blackhole under
warm failover, and per-shard failover that re-executes only the lost range.

Weights come from ``repro.models.model.init_params``, fed as numpy."""
import dataclasses
import threading

import jax
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.core import AcceleratorRegistry as RefRegistry
from repro.core.cluster import ClusterMembership as RefMembership
from repro.core.cluster import ConsistentHashRing as RefRing
from repro.core.virtualization import JETSON_TX2 as REF_TX2
from repro.models import model as RM
from repro_torch import avec
from repro_torch import configs as tconfigs
from repro_torch.core import AcceleratorRegistry, HostRuntime
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.cluster import ClusterMembership, ConsistentHashRing, ReplicaGroup
from repro_torch.core.executor import DestinationDraining, DestinationExecutor
from repro_torch.core.interception import AvecSession
from repro_torch.core.library import make_model_library
from repro_torch.core.transport import (ChannelClosed, DirectChannel, FaultyChannel,
                                        TCPChannel, TCPServer)
from repro_torch.core.virtualization import JETSON_TX2
from repro_torch.serving.engine import generate_sequential
from repro_torch.utils import tree_leaves

SEED = 0


@pytest.fixture(scope="module")
def lm():
    cfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_params(reduced(get_arch("granite-3-2b")), jax.random.PRNGKey(0)))
    return cfg, params, make_model_library(cfg, max_cache_len=32, device="cpu")


def _dest(libs, name, cls=DestinationExecutor, **kw):
    return cls(libs, name=name, device="cpu", **kw)


def _counting_lib(lib, hits):
    out = {}
    for name, fn in lib.items():
        def wrap(fn=fn, name=name):
            def g(p, s, a):
                hits[name] = hits.get(name, 0) + 1
                return fn(p, s, a)
            return g
        out[name] = wrap()
    return out


def _greedy(out, cfg) -> int:
    return int(np.argmax(np.asarray(out["logits"])[0, 0, :cfg.vocab_size]))


# ---------------------------------------------------------------------------
# the ring against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members,vnodes", [
    (["a", "b", "c"], 64), (["edge-a", "edge-b"], 32),
    ([f"ep{i}-127.0.0.1:{9000 + i}" for i in range(5)], 16), (["solo"], 8)])
def test_ring_placement_and_preference_equal_reference(members, vnodes):
    ring, ref = ConsistentHashRing(members, vnodes=vnodes), RefRing(members, vnodes=vnodes)
    keys = [f"tenant{i}:{i * 7919:016x}" for i in range(200)]
    assert [ring.primary(k) for k in keys] == [ref.primary(k) for k in keys]
    for k in keys[:50]:
        assert ring.preference(k) == ref.preference(k)
        assert ring.preference(k, n=2) == ref.preference(k, n=2)
        first = ref.primary(k)
        assert ring.preference(k, exclude=(first,)) == ref.preference(k, exclude=(first,))
    ring.add("late")
    ref.add("late")
    ring.remove(members[0])
    ref.remove(members[0])
    assert [ring.primary(k) for k in keys] == [ref.primary(k) for k in keys]


def test_hash_ring_membership_change_moves_only_affected_arc():
    ring = ConsistentHashRing(["a", "b", "c"], vnodes=64)
    keys = [f"tenant{i}:model{i % 7}" for i in range(200)]
    before = {k: ring.primary(k) for k in keys}
    ring.remove("c")
    after = {k: ring.primary(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert moved and all(before[k] == "c" for k in moved)
    assert all(after[k] in ("a", "b") for k in moved)
    ring.add("d")
    after2 = {k: ring.primary(k) for k in keys}
    moved2 = [k for k in keys if after[k] != after2[k]]
    assert moved2 and all(after2[k] == "d" for k in moved2)
    assert {after2[k] for k in keys} == {"a", "b", "d"}
    assert ConsistentHashRing([]).primary("x") is None
    assert ConsistentHashRing([]).preference("x") == []


def test_cluster_membership_sync_equals_reference():
    """The same membership history on both packages' registries: the same
    placements, and the same deltas on drain and rejoin."""
    views = []
    for reg, cm_cls, spec in ((AcceleratorRegistry(), ClusterMembership, JETSON_TX2),
                              (RefRegistry(), RefMembership, REF_TX2)):
        for n in ("a", "b", "c"):
            reg.register(dataclasses.replace(spec, name=n))
        views.append((reg, cm_cls(reg)))
    keys = [f"t{i}" for i in range(100)]
    (reg, cm), (rreg, rcm) = views
    assert [cm.place(k) for k in keys] == [rcm.place(k) for k in keys]
    reg.mark_draining("b")
    rreg.mark_draining("b")
    delta, rdelta = cm.sync(), rcm.sync()
    assert delta == rdelta and delta["removed"] == ["b"] and delta["moved"]
    assert all(old == "b" for old, new in delta["moved"].values())
    reg.mark_draining("b", False)
    rreg.mark_draining("b", False)
    assert cm.sync() == rcm.sync()
    assert [cm.placement(k) for k in keys] == [rcm.placement(k) for k in keys]
    assert cm.stats() == rcm.stats()


def test_replica_group_replicates_promotes_and_degrades():
    class _RT:
        def __init__(self):
            self.fail = False
            self.restored = []

        def restore(self, fp, state):
            if self.fail:
                raise ChannelClosed("standby died")
            self.restored.append((fp, state))

    rt = _RT()
    picks = iter(["b", None])
    g = ReplicaGroup("k", "a", pick_standby=lambda p: next(picks),
                     runtime_for=lambda n: rt, prepare=lambda n: None)
    assert g.replicate("fp", {"s": 1}, 3)
    assert g.standby == "b" and g.standby_step == 3 and g.replicated == 1
    rt.fail = True
    assert not g.replicate("fp", {"s": 2}, 4)
    assert g.standby is None and g.replication_failures == 1
    assert not g.replicate("fp", {"s": 3}, 5)
    assert g.promote() is None
    rt2 = _RT()
    g2 = ReplicaGroup("k", "a", pick_standby=lambda p: "c", runtime_for=lambda n: rt2)
    assert g2.replicate("fp", {"s": 9}, 7)
    assert g2.promote() == ("c", 7)
    assert g2.primary == "c" and g2.standby is None and g2.promotions == 1


# ---------------------------------------------------------------------------
# through the facade
# ---------------------------------------------------------------------------

def test_facade_hash_placement_is_sticky_and_arc_bounded(lm):
    cfg, params, lib = lm
    executors = [_dest({"lm": lib}, n) for n in ("ha", "hb", "hc")]
    with avec.connect(executors, placement="hash", shadow_every=0) as client:
        s1 = client.session(cfg, params, "lm", tenant="acme")
        key = f"acme:{model_fingerprint(cfg, params)}"
        assert s1.destination == client.cluster.placement(key)
        # the JAX package's ring places the same key on the same member
        assert RefRing(client.destinations).primary(key) == \
            ConsistentHashRing(client.destinations).primary(key)
        assert client.session(cfg, params, "lm", tenant="acme").destination == s1.destination
        dests = {t: client.session(cfg, params, "lm", tenant=t).destination
                 for t in (f"t{i}" for i in range(20))}
        other = next(t for t, d in dests.items() if d != s1.destination)
        client.registry.mark_draining(s1.destination)
        assert client.session(cfg, params, "lm", tenant="acme").destination != s1.destination
        assert client.session(cfg, params, "lm", tenant=other).destination == dests[other]
        assert client.cluster.stats()["moves"] >= 1


def test_drain_control_op_gates_admission_and_advertises(lm):
    cfg, params, lib = lm
    rt = HostRuntime(DirectChannel(_dest({"lm": lib}, "solo")))
    sess = AvecSession(cfg, params, rt, "lm")
    sess.ensure_model()
    reply = rt.ping()
    assert reply["draining"] is False and reply["replay_dedup"] is True
    assert rt.drain()["draining"] is True
    with pytest.raises(DestinationDraining) as ei:
        rt.run(sess.fp, "prefill", {"tokens": np.zeros((1, 4), np.int32)})
    assert ei.value.destination == "solo"
    assert avec.Capabilities.from_ping(rt.ping()).draining is True
    rt.snapshot(sess.fp)
    assert rt.drain(enable=False)["draining"] is False
    rt.run(sess.fp, "prefill", {"tokens": np.zeros((1, 4), np.int32)})


def test_drain_rehomes_midstream_to_warm_standby_zero_loss(lm):
    """The drained node bounces the next call; the session promotes its warm
    standby and the greedy stream equals the port's own sequential one."""
    cfg, params, lib = lm
    hits = {n: {} for n in ("edge-a", "edge-b")}
    executors = {n: _dest({"lm": _counting_lib(lib, hits[n])}, n) for n in hits}
    targets = [(dataclasses.replace(JETSON_TX2, name=n), ex) for n, ex in executors.items()]
    prompt = [5, 17, 3, 99, 42, 7]
    want = generate_sequential(cfg, params, prompt, 6, max_len=32, device="cpu")
    with avec.connect(targets) as client:
        sess = client.session(cfg, params, "lm", destination="edge-a")
        sess.call("prefill", {"tokens": np.asarray([prompt], np.int32)})
        got = [want[0]]
        for step in range(1, 6):
            if step == 3:
                assert sess._replica.standby == "edge-b"
                assert client.runtime("edge-a").drain()["draining"] is True
            got.append(_greedy(sess.call("decode", {"tokens": np.asarray([[got[-1]]], np.int32)}),
                               cfg))
        assert got == want
        assert sess.destination == "edge-b" and sess.rehomes == 1
        assert sess.last_rehome["reason"] == "drain" and sess.last_rehome["warm"] is True
        assert hits["edge-b"].get("prefill", 0) == 0
        va = client.registry.get("edge-a")
        assert va.healthy and va.draining
        assert [v.name for v in client.registry.routable()] == ["edge-b"]
        assert executors["edge-a"].drain(timeout_s=0.5)["drained"] is True


def test_drain_bleeds_coalesced_queue_without_dropping_inflight(lm):
    cfg, params, lib = lm
    started, release = threading.Event(), threading.Event()
    gated = dict(lib)

    def slow_score(p, s, a):
        started.set()
        release.wait(5.0)
        return lib["score"](p, s, a)

    gated["score"] = slow_score
    ex = _dest({"lm": gated}, "co", coalesce=True, coalesce_window_s=0.001)
    try:
        sess = AvecSession(cfg, params, HostRuntime(DirectChannel(ex)), "lm")
        sess.ensure_model()
        args = {"tokens": np.zeros((1, 8), np.int32), "targets": np.zeros((1, 8), np.int32)}
        results, errors = {}, {}

        def worker(key):
            try:
                results[key] = HostRuntime(DirectChannel(ex)).run(sess.fp, "score", args,
                                                                  batchable=True)
            except Exception as e:  # noqa: BLE001 — recorded for asserts
                errors[key] = e

        t1 = threading.Thread(target=worker, args=("pre",))
        t1.start()
        assert started.wait(5.0)
        ex.draining = True
        t2 = threading.Thread(target=worker, args=("post",))
        t2.start()
        t2.join(5.0)
        assert isinstance(errors.get("post"), DestinationDraining)
        drained = {}
        t3 = threading.Thread(target=lambda: drained.update(ex.drain(timeout_s=5.0)))
        t3.start()
        release.set()
        t1.join(5.0)
        t3.join(5.0)
        assert "pre" in results and drained == {"drained": True, "pending": 0}
    finally:
        release.set()
        ex.shutdown()


def test_sharded_map_reroutes_around_draining_shard(lm):
    cfg, params, lib = lm
    executors = {n: _dest({"lm": lib}, n) for n in ("sh-a", "sh-b")}
    targets = [(dataclasses.replace(JETSON_TX2, name=n), ex) for n, ex in executors.items()]
    rng = np.random.default_rng(SEED + 3)
    reqs = {f"r{i}": {"tokens": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32),
                      "targets": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)}
            for i in range(6)}
    with avec.connect(targets, shadow_every=0) as client:
        sess = client.session(cfg, params, "lm", destination="sh-a")
        ref = sess.map("score", reqs)
        executors["sh-b"].draining = True
        out = sess.map("score", reqs)
        st = sess.last_map_stats
        assert st["drained"] == ["sh-b"] and st["rerouted"] >= 1
        assert st["served_by"] == {rid: "sh-a" for rid in reqs}
        for rid in reqs:
            for x, y in zip(tree_leaves(ref[rid]), tree_leaves(out[rid])):
                assert np.array_equal(np.asarray(x), np.asarray(y))


def _tagging_lib(lib, seen):
    """``lib`` whose score records the first token of every row it computes."""
    def score(p, s, a):
        seen.extend(int(t) for t in np.asarray(a["tokens"])[:, 0])
        return lib["score"](p, s, a)
    return {**lib, "score": score}


@pytest.mark.parametrize("n_reqs", [4, 7])
def test_map_records_the_destination_that_served_each_request(lm, n_reqs):
    cfg, params, lib = lm
    seen = {n: [] for n in ("sv-a", "sv-b")}
    targets = [(dataclasses.replace(JETSON_TX2, name=n), _dest({"lm": _tagging_lib(lib, seen[n])}, n))
               for n in seen]
    rng = np.random.default_rng(SEED + 4)
    reqs = {}
    for i in range(n_reqs):
        toks = rng.integers(n_reqs, cfg.vocab_size, (1, 8)).astype(np.int32)
        toks[0, 0] = i                              # the request's tag
        reqs[f"r{i}"] = {"tokens": toks, "targets": toks}
    with avec.connect(targets, shadow_every=0) as client:
        sess = client.session(cfg, params, "lm", destination="sv-a")
        sess.map("score", reqs)
        st = sess.last_map_stats
    served = {f"r{t}": n for n, ts in seen.items() for t in ts}
    assert st["served_by"] == served and len(served) == n_reqs
    assert {n: sum(v == n for v in served.values()) for n in seen} == st["assigned"]


# ---------------------------------------------------------------------------
# chaos: warm failover on the pipelined TCP path, per-shard failover
# ---------------------------------------------------------------------------

def _tcp_pair(lib, hits):
    """Two TCP destinations; edge-a dialed through a FaultyChannel the test
    mutates mid-stream."""
    servers = {n: TCPServer(_dest({"lm": _counting_lib(lib, hits[n])}, n).handle).start()
               for n in ("edge-a", "edge-b")}
    chans = []

    def dial_a():
        ch = FaultyChannel(TCPChannel.connect("127.0.0.1", servers["edge-a"].port), seed=SEED)
        chans.append(ch)
        return ch

    targets = [(dataclasses.replace(JETSON_TX2, name="edge-a"), dial_a),
               (dataclasses.replace(JETSON_TX2, name="edge-b"),
                lambda: TCPChannel.connect("127.0.0.1", servers["edge-b"].port))]
    return servers, targets, chans


@pytest.mark.parametrize("fault", ["killed_ack", "blackhole"])
def test_chaos_warm_failover_loses_no_acked_results(lm, fault):
    """killed_ack: the primary executes a call, its ack is dropped and the
    probe dies mid-frame, so that one call runs twice cluster-wide;
    blackhole: the request never lands, so every call runs exactly once.
    Either way the greedy stream is unchanged and the re-home is warm."""
    cfg, params, lib = lm
    hits = {n: {} for n in ("edge-a", "edge-b")}
    servers, targets, chans = _tcp_pair(lib, hits)
    prompt = [5, 17, 3, 99, 42, 7]
    want = generate_sequential(cfg, params, prompt, 7, max_len=32, device="cpu")
    try:
        with avec.connect(targets, timeout=1.5 if fault == "killed_ack" else 0.75) as client:
            sess = client.session(cfg, params, "lm", destination="edge-a")
            sess.call("prefill", {"tokens": np.asarray([prompt], np.int32)})
            got = [want[0]]
            ch = chans[0]
            for step in range(1, 7):
                if step == 4:
                    assert sess._replica.standby == "edge-b"
                    assert sess._replica.standby_step == sess._shadow.snapshot_step == sess._steps
                    st = ch.stats()
                    if fault == "killed_ack":
                        ch.drop_recvs.add(st["recvs"] + 1)
                        ch.partial_send_at = st["sends"] + 2
                    else:
                        ch.blackhole_after = st["sends"] + 1
                got.append(_greedy(sess.call(
                    "decode", {"tokens": np.asarray([[got[-1]]], np.int32)}), cfg))
            assert got == want
            assert sess.destination == "edge-b" and sess.last_rehome["warm"] is True
            a, b = hits["edge-a"]["decode"], hits["edge-b"]["decode"]
            assert (a, b) == ((4, 3) if fault == "killed_ack" else (3, 3))
            assert hits["edge-b"].get("prefill", 0) == 0
            if fault == "killed_ack":
                assert ch.stats()["partial"] == 1 and ch.stats()["dropped"] >= 1
                va = client.registry.get("edge-a")
                assert not va.healthy and va.quarantined
            else:
                assert ch.stats()["blackholed"] >= 2
    finally:
        for s in servers.values():
            s.stop()


class _MortalExecutor(DestinationExecutor):
    """Once ``dead`` is set every frame raises ChannelClosed, so a
    DirectChannel peer looks exactly like a crashed node."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dead = False

    def handle(self, raw):
        if self.dead:
            raise ChannelClosed(f"{self.name} crashed")
        return super().handle(raw)


@pytest.mark.parametrize("victim", ["d0", "d1", "d2"])
def test_chaos_shard_failover_reexecutes_only_lost_range(victim):
    """Kill one destination mid-sharded-call: every range is re-sent under
    its original call_id, survivors answer from their replay caches, and
    only the victim's range re-executes, on exactly one survivor."""
    names = ["d0", "d1", "d2"]
    executed, state, executors = [], {"armed": False, "failed": False}, {}

    def make_work(name):
        def work(params, state_, args):
            x = np.asarray(args["x"])
            executed.append((name, float(x[0, 0]), int(x.shape[0])))
            if name == victim and state["armed"] and not state["failed"]:
                state["failed"] = True
                executors[victim].dead = True
                raise RuntimeError("injected shard death")
            return {"y": x * 2.0 + 1.0}
        return work

    for n in names:
        executors[n] = _dest({"tiny": {"work": make_work(n)}}, n, cls=_MortalExecutor)
    rows = 768                                      # 3 shards at the 256-row floor
    x = {"x": np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)}
    with avec.connect(list(executors.values())) as client:
        sess = client.session({"a": 1}, {"w": np.zeros(1, np.float32)}, "tiny",
                              destination="d0")
        state["armed"] = True
        out = sess.call("work", x, shard=True)
        assert np.array_equal(np.asarray(out["y"]), x["x"] * 2.0 + 1.0)
        st = sess.last_shard_stats
        assert st["failed"] == [victim] and st["retry_rounds"] == 1
        by_range = {}
        for name, v0, r in executed:
            by_range.setdefault((v0, r), []).append(name)
        lost = [k for k, v in by_range.items() if victim in v]
        assert len(lost) == 1
        runs = by_range[lost[0]]
        assert runs[0] == victim and len(runs) == 2 and runs[1] != victim
        assert all(len(v) == 1 for k, v in by_range.items() if k != lost[0])
        survivors = [n for n in names if n != victim]
        assert all(executors[n].replay_hits >= 1 for n in survivors)
        entry = client.migration.migrations[-1]
        assert entry["reason"] == "shard-failover" and entry["from"] == victim
        va = client.registry.get(victim)
        assert not va.healthy and va.quarantined
    for ex in executors.values():
        ex.shutdown()
