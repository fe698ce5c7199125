"""avecheck in the port: the static analyzer (``repro_torch.analysis``)
against the JAX package's on the reference's own fixtures and on the source
trees, its CLI's exit codes, the lazy exports, and the protocol validator
(``ValidatingChannel``) over the port's TCP and shared-memory channels.

Findings are compared whole (path, line, rule, message, suppressed); the
one message that names a file names each package's own serialization
module, so ``repro_torch/`` is read as ``repro/`` there."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.analysis import checker as RC
from repro.analysis import protocol as RP
from repro.analysis import rules as RR
from repro.core.serialization import pack_message as r_pack
from repro_torch import analysis as TA
from repro_torch.analysis import checker as TC
from repro_torch.analysis import protocol as TP
from repro_torch.analysis import rules as TR
from repro_torch.core.executor import DestinationExecutor, HostRuntime
from repro_torch.core.memory import release_buffer
from repro_torch.core.serialization import pack_message
from repro_torch.core.shm import SharedMemoryChannel, SharedMemoryServer
from repro_torch.core.transport import TCPChannel, TCPServer

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _norm(f) -> tuple:
    return (f.path, f.line, f.rule, f.message.replace("repro_torch/", "repro/"), f.suppressed)


# ---------------------------------------------------------------------------
# the reference's fixtures (tests/test_analysis.py), each run by both rules
# ---------------------------------------------------------------------------

_LOCKED_CLASS = """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0      # guarded-by: _lock

    def good(self):
        with self._lock:
            self.count += 1

    def bad(self):
        self.count += 1
"""

# (rule, source, active findings, suppressed findings)
RULE_CASES = {
    "lease_unbalanced": ("lease", """
    def f(pool):
        lease = pool.acquire(64)
        lease.view[0] = 1
    """, 1, 0),
    "lease_exception_unsafe": ("lease", """
    def f(pool, ch):
        lease = pool.acquire(64)
        ch.process(lease)
        lease.release()
    """, 1, 0),
    "lease_good_patterns": ("lease", """
    def via_finally(pool):
        lease = pool.acquire(64)
        try:
            use(lease)
        finally:
            lease.release()

    def via_return(pool):
        lease = pool.acquire(64)
        return lease

    def via_both_paths(pool):
        lease = pool.acquire(64)
        try:
            out = decode(lease)
            lease.release()
        except Exception:
            lease.release()
            raise
        return out

    def via_helper(pool):
        lease = pool.acquire(64)
        try:
            use(lease)
        finally:
            release_buffer(lease)
    """, 0, 0),
    "lease_handoff": ("lease", """
    def f(pool, q):
        lease = pool.acquire(64)
        q.put(lease)    # avecheck: handoff
    """, 0, 0),
    "lease_retain": ("lease", """
    def f(lease):
        lease.retain()
        use(lease)
    """, 1, 0),
    "lease_suppressed": ("lease", """
    def f(pool):
        lease = pool.acquire(64)    # avecheck: ignore[lease] -- test fixture
        stash(lease)
    """, 0, 1),
    "lock_outside": ("lock", _LOCKED_CLASS, 1, 0),
    "lock_mutating_call": ("lock", """
    class C:
        def __init__(self):
            self._lock = object()
            self.items = []     # guarded-by: _lock

        def bad(self):
            self.items.append(1)
    """, 1, 0),
    "lock_def_line_suppression": ("lock", """
    class C:
        def __init__(self):
            self._lock = object()
            self.n = 0      # guarded-by: _lock

        def helper(self):  # avecheck: ignore[lock] -- caller holds _lock
            self.n += 1
            self.n += 2
    """, 0, 2),
    "block_io_under_state_lock": ("block", """
    class C:
        def __init__(self, sock):
            self._lock = object()
            self.n = 0      # guarded-by: _lock
            self.sock = sock

        def bad(self):
            with self._lock:
                self.sock.sendall(b"x")
    """, 1, 0),
    "block_cv_wait": ("block", """
    class C:
        def __init__(self):
            self._cv = object()
            self.n = 0      # guarded-by: _cv

        def ok(self):
            with self._cv:
                while not self.n:
                    self._cv.wait(0.1)
    """, 0, 0),
    "block_io_mutex": ("block", """
    class C:
        def __init__(self, sock):
            self._lock = object()
            self.sock = sock

        def ok(self):
            with self._lock:
                self.sock.sendall(b"x")
    """, 0, 0),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rules_equal_reference_on_its_fixtures(case):
    rule, code, n_active, n_suppressed = RULE_CASES[case]
    src = textwrap.dedent(code)
    ref_sf, sf = RC.SourceFile("mod.py", src), TC.SourceFile("mod.py", src)
    ref = getattr(RR, f"{rule}_rule")(ref_sf, RC.Project([ref_sf]))
    got = getattr(TR, f"{rule}_rule")(sf, TC.Project([sf]))
    assert [_norm(f) for f in got] == [_norm(f) for f in ref]
    assert sum(not f.suppressed for f in got) == n_active
    assert sum(f.suppressed for f in got) == n_suppressed
    assert [s.used for s in sf.suppressions.values()] == \
        [s.used for s in ref_sf.suppressions.values()]


_ERRORS = """
class RemoteError(Exception):
    pass

class {name}(RemoteError):
    pass
"""
_CLIENT = """

def _remote_exception(rmeta):
    return rmeta.get("error")

def client():
    try:
        pass
    except RemoteError:
        raise
"""

# each: files of one project -> (source, path); and a message every analyzer must give
WIRE_CASES = {
    "missing_table_entry": ([(_ERRORS.format(name="NewTyped"), "errors.py"), ("""
WIRE_ERRORS = {
    "RemoteError": {"flag": "error", "disposition": "reraise"},
}
""" + _CLIENT, "serialization.py")], "NewTyped missing from the WIRE_ERRORS"),
    "unmapped_flag_missing_handler": ([(_ERRORS.format(name="Typed"), "errors.py"), ("""
WIRE_ERRORS = {
    "RemoteError": {"flag": "error", "disposition": "reraise"},
    "Typed": {"flag": "special", "disposition": "retry"},
}
""" + _CLIENT, "serialization.py")], "not mapped by executor._remote_exception"),
    "tuple_aliases": ([("""
class RemoteError(Exception):
    pass

_FAILOVER = (RemoteError, OSError)

WIRE_ERRORS = {
    "RemoteError": {"flag": "error", "disposition": "reraise"},
}

def _remote_exception(rmeta):
    return rmeta.get("error")

class S:
    def client(self):
        try:
            pass
        except _FAILOVER:
            raise
""", "serialization.py")], None),
    "no_table": ([(_ERRORS.format(name="Typed"), "errors.py")],
                 "no literal WIRE_ERRORS table found"),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_rule_equals_reference_on_its_fixtures(case):
    files, needle = WIRE_CASES[case]
    ref = RR.wire_rule(RC.Project([RC.SourceFile(p, textwrap.dedent(s)) for s, p in files]))
    got = TR.wire_rule(TC.Project([TC.SourceFile(p, textwrap.dedent(s)) for s, p in files]))
    assert [_norm(f) for f in got] == [_norm(f) for f in ref]
    if needle is None:
        assert got == []
    else:
        assert any(needle in f.message for f in got)
    if case == "no_table":      # the port's message names the port's file
        assert "repro_torch/core/serialization.py" in got[0].message


_META_TREE = """
    def f(pool):
        lease = pool.acquire(4)     # avecheck: ignore[lease]
        stash(lease)

    def g():                        # avecheck: ignore[lock] -- unused here
        pass

    def h():    # avecheck: ignore[bogusrule] -- no such rule
        pass
"""


def test_run_paths_meta_findings_equal_reference(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent(_META_TREE))
    got = TC.run_paths([str(tmp_path)])
    assert [_norm(f) for f in got] == [_norm(f) for f in RC.run_paths([str(tmp_path)])]
    msgs = [f.message for f in got if not f.suppressed]
    assert any("without justification" in m for m in msgs)
    assert any("unused suppression" in m for m in msgs)
    assert any("unknown rule" in m for m in msgs)


@pytest.mark.parametrize("tree", ["repro", "repro_torch", ""])
def test_source_trees_findings_equal_reference_and_none_active(tree):
    path = os.path.join(SRC, tree)
    got = TC.run_paths([path])
    assert [_norm(f) for f in got] == [_norm(f) for f in RC.run_paths([path])]
    assert [str(f) for f in got if not f.suppressed] == []
    assert got, "the suppressed audit trail is there"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(module: str, *args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("which,args,rc", [
    ("clean", ["src/repro_torch"], 0),
    ("clean", ["src/repro_torch", "--show-suppressed"], 0),
    ("default", [], 0),                                  # src/, from the repo root
    ("dirty", ["--show-suppressed"], 1),
])
def test_cli_exit_codes_and_output_equal_reference(tmp_path, which, args, rc):
    if which == "dirty":
        bad = tmp_path / "bad.py"
        bad.write_text(textwrap.dedent(RULE_CASES["lease_unbalanced"][1]))
        args = [str(bad), *args]
    got, ref = _cli("repro_torch.analysis", *args), _cli("repro.analysis", *args)
    assert got.returncode == rc == ref.returncode, got.stderr
    assert got.stdout == ref.stdout         # no message here names a package's file
    assert got.stderr == ref.stderr
    assert got.stderr.startswith(f"avecheck: {rc} finding(s)")


def test_lazy_exports_point_at_the_port():
    names = ["LeaseTracker", "LeaseLeak", "LockOrderRecorder", "LockOrderCycle",
             "ValidatingChannel", "ProtocolViolation", "run_paths"]
    assert TA.__all__ == names
    for n in names:
        assert getattr(TA, n).__module__.startswith("repro_torch.analysis."), n
    assert TA.run_paths is TC.run_paths and TA.ValidatingChannel is TP.ValidatingChannel
    with pytest.raises(AttributeError, match="repro_torch.analysis"):
        TA.nothing_here   # noqa: B018


# ---------------------------------------------------------------------------
# the protocol validator over the port's TCP and shared-memory channels
# ---------------------------------------------------------------------------

def test_known_ops_equal_reference():
    assert TP.known_ops() == RP.known_ops()
    assert {"ping", "run", "put_model", "drain"} <= TP.known_ops()


def _tiny(params, state, args):
    return {"y": np.asarray(args["x"]) + 1.0}


@pytest.fixture(params=["tcp", "shm"])
def channel(request):
    """(connect, server) for a port destination executor behind TCP or SHM."""
    ex = DestinationExecutor({"tiny": {"fn": _tiny}}, device="cpu")
    if request.param == "tcp":
        srv = TCPServer(ex.handle).start()
        connect = lambda: TCPChannel.connect("127.0.0.1", srv.port)  # noqa: E731
    else:
        srv = SharedMemoryServer(ex.handle).start()
        connect = lambda: SharedMemoryChannel.connect(srv.address, timeout=5)  # noqa: E731
    yield connect
    srv.stop()
    ex.shutdown()


def test_validating_channel_passes_clean_traffic(channel):
    vc = TP.ValidatingChannel(channel(), side="client")
    try:
        rt = HostRuntime(vc)
        assert rt.ping()["ok"]
        rt.put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
        out = rt.run("fp", "fn", {"x": np.zeros((1, 2), np.float32)})
        np.testing.assert_array_equal(out["y"], np.ones((1, 2), np.float32))
        st = vc.stats()
        assert st["violations"] == 0 and st["outstanding"] == 0
        assert st["frames_validated"] >= 6          # 3 requests, 3 responses
    finally:
        vc.close()


def _violation(cls, fn) -> str:
    with pytest.raises(cls) as e:
        fn()
    return str(e.value)


def test_validating_channel_flags_the_reference_violations(channel):
    """Unknown op, a response to no request, and a reused rid: each raised
    with the reference validator's message (its own frames over its own
    loopback), the frames crossing the port's real channel."""
    from repro.core.transport import LoopbackChannel

    inner = channel()
    try:
        # an unknown op is refused before it is sent
        vc = TP.ValidatingChannel(inner, side="client")
        ref = RP.ValidatingChannel(LoopbackChannel.pair()[0], side="client")
        got = _violation(TP.ProtocolViolation,
                         lambda: vc.send(pack_message({"op": "bogus"}, request_id=1)))
        want = _violation(RP.ProtocolViolation,
                          lambda: ref.send(r_pack({"op": "bogus"}, request_id=1)))
        assert got == want and "bogus" in got

        # a response that answers no outstanding request: the request went
        # around the validator, straight onto the channel
        inner.send(pack_message({"op": "ping"}, request_id=99))
        got = _violation(TP.ProtocolViolation, lambda: vc.recv(5.0))
        a, b = LoopbackChannel.pair()
        b.send(r_pack({"ok": True}, request_id=99))
        want = _violation(RP.ProtocolViolation,
                          lambda: RP.ValidatingChannel(a, side="client").recv(1.0))
        assert got == want and "no outstanding request" in got

        # a request id reused while in flight
        vc.send(pack_message({"op": "ping"}, request_id=5))
        got = _violation(TP.ProtocolViolation,
                         lambda: vc.send(pack_message({"op": "ping"}, request_id=5)))
        ref.send(r_pack({"op": "ping"}, request_id=5))
        want = _violation(RP.ProtocolViolation,
                          lambda: ref.send(r_pack({"op": "ping"}, request_id=5)))
        assert got == want and "reuses in-flight rid" in got
        assert vc.stats()["violations"] == 3
        release_buffer(vc.recv(5.0))                          # rid 5's answer, matched
        assert vc.stats()["outstanding"] == 0
    finally:
        inner.close()
