"""avecheck rules — the four repo-specific invariants, as AST checks.

``lease``  — lease balance: a BufferLease acquired via ``.acquire()`` /
             ``.recv()`` / ``.request()`` / ``_recv_frame()`` (or pinned via
             a bare ``x.retain()``) must be released, returned, or handed
             off on *all* paths, exceptions included.
``lock``   — lock discipline: ``# guarded-by: <lock>``-annotated attributes
             mutate only inside ``with self.<lock>:`` (the unlocked
             ``bytes_sent`` counter's bug class; the message keeps the
             reference analyzer's wording).
``block``  — no blocking call (socket I/O, ``wait_io``, ``time.sleep``,
             ``future.result()``, ``select``) while holding a *state* lock
             — a lock with guarded-by registrations.  Pure I/O mutexes
             (e.g. ``TCPChannel._lock``, which exists to serialize sends)
             are exempt by construction: blocking is their job.
``wire``   — wire-error completeness: every typed error class the executor
             can raise over the wire appears in serialization's
             ``WIRE_ERRORS`` table with a client disposition, its meta flag
             is mapped by ``_remote_exception``, and a client-side
             ``except`` handler exists somewhere in ``src/``.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.checker import (
    Finding, Project, SourceFile, functions, local_nodes,
)

# ----------------------------------------------------------------------
# lease balance
# ----------------------------------------------------------------------

LEASE_ACQUIRE_ATTRS = {"acquire", "recv", "request"}
LEASE_ACQUIRE_FUNCS = {"_recv_frame"}
LEASE_RELEASE_FUNCS = {"release_buffer", "detach_tree"}


def _calls_in(expr: ast.AST):
    return [n for n in ast.walk(expr) if isinstance(n, ast.Call)]


def _is_acquiring_call(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in LEASE_ACQUIRE_ATTRS:
        return True
    return isinstance(f, ast.Name) and f.id in LEASE_ACQUIRE_FUNCS


def _references(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def lease_rule(sf: SourceFile, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for fn in functions(sf.tree):
        acquisitions: list[tuple[str, ast.stmt]] = []
        for node in local_nodes(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and any(_is_acquiring_call(c)
                            for c in _calls_in(node.value))):
                acquisitions.append((node.targets[0].id, node))
            elif (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "retain"
                    and isinstance(node.value.func.value, ast.Name)):
                acquisitions.append((node.value.func.value.id, node))
        if not acquisitions:
            continue
        for name, acq in acquisitions:
            if sf.is_handoff(acq.lineno):
                continue        # ownership transferred at the acquisition
            kinds = _lease_consumptions(sf, fn, name, acq)
            ok = ("finally" in kinds["release"] or kinds["handoff"]
                  or kinds["return"]
                  or ("normal" in kinds["release"]
                      and "except" in kinds["release"]))
            if ok:
                continue
            if not (kinds["release"] or kinds["return"] or kinds["handoff"]):
                msg = (f"lease {name!r} acquired here is never released, "
                       f"returned, or handed off in this function "
                       f"(memory.py lease rule 1)")
            else:
                msg = (f"lease {name!r} acquired here is not balanced on "
                       f"exception paths: release it in a finally/except, "
                       f"or mark the ownership transfer with "
                       f"`# avecheck: handoff`")
            if not sf.suppressed("lease", acq):
                findings.append(Finding(sf.path, acq.lineno, "lease", msg))
            else:
                findings.append(Finding(sf.path, acq.lineno, "lease", msg,
                                        suppressed=True))
    return findings


def _lease_consumptions(sf: SourceFile, fn: ast.AST, name: str,
                        acq: ast.stmt) -> dict:
    kinds = {"release": set(), "return": False, "handoff": False}
    for node in local_nodes(fn):
        if node is acq:
            continue
        if isinstance(node, ast.stmt) and sf.is_handoff(node.lineno) \
                and _references(node, name):
            kinds["handoff"] = True
        if isinstance(node, ast.Return) and node.value is not None \
                and _references(node.value, name):
            kinds["return"] = True
        if isinstance(node, ast.Call):
            f = node.func
            releasing = (
                (isinstance(f, ast.Attribute) and f.attr == "release"
                 and isinstance(f.value, ast.Name) and f.value.id == name)
                or (isinstance(f, ast.Name)
                    and f.id in LEASE_RELEASE_FUNCS and node.args
                    and _references(node.args[0], name)))
            if releasing:
                kinds["release"].add(sf.exception_context(node, fn))
    return kinds


# ----------------------------------------------------------------------
# lock discipline
# ----------------------------------------------------------------------

MUTATING_METHODS = {
    "append", "appendleft", "add", "clear", "discard", "extend", "insert",
    "pop", "popleft", "popitem", "remove", "update", "setdefault", "sort",
    "reverse", "push",
}


def _guard_registrations(sf: SourceFile, cls: ast.ClassDef) -> dict:
    """attr name -> lock name, from guarded-by comments on assignment
    lines inside the class (methods or class body)."""
    guards: dict[str, str] = {}
    for node in ast.walk(cls):
        lock = sf.guard_lines.get(getattr(node, "lineno", -1))
        if lock is None:
            continue
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            target = node.target
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            guards[target.attr] = lock
        elif isinstance(target, ast.Name):
            guards[target.id] = lock    # dataclass field at class level
    return guards


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _mutated_attrs(node: ast.AST):
    """Yield (attr, kind) for mutations of ``self.<attr>`` in this node."""
    targets: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATING_METHODS:
        attr = _self_attr(node.func.value)
        if attr:
            yield attr, f".{node.func.attr}()"
        return
    for t in targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        for e in elts:
            attr = _self_attr(e)
            if attr:
                yield attr, "assignment"
            elif isinstance(e, ast.Subscript):
                attr = _self_attr(e.value)
                if attr:
                    yield attr, "subscript assignment"


def lock_rule(sf: SourceFile, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(sf.tree) if isinstance(n, ast.ClassDef)]:
        guards = _guard_registrations(sf, cls)
        if not guards:
            continue
        for node in ast.walk(cls):
            for attr, kind in _mutated_attrs(node):
                lock = guards.get(attr)
                if lock is None:
                    continue
                fn = sf.enclosing_function(node)
                if fn is not None and fn.name == "__init__":
                    continue    # construction precedes sharing
                if f"self.{lock}" in sf.held_locks(node):
                    continue
                msg = (f"{kind} of self.{attr} (guarded-by {lock}) outside "
                       f"`with self.{lock}:` — the PR-2 bytes_sent bug "
                       f"class")
                findings.append(Finding(
                    sf.path, node.lineno, "lock", msg,
                    suppressed=sf.suppressed("lock", node)))
    return findings


# ----------------------------------------------------------------------
# blocking under a state lock
# ----------------------------------------------------------------------

BLOCKING_ATTRS = {
    "send", "sendall", "sendmsg", "sendto", "recv", "recv_into", "recvfrom",
    "accept", "connect", "wait_io", "sleep", "result", "select", "request",
}
#: repo-local framing primitives that block on the socket
BLOCKING_FUNCS = {"_send_frame", "_sendmsg_all", "_recv_into_exact",
                  "_recv_frame"}


def block_rule(sf: SourceFile, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(sf.tree) if isinstance(n, ast.ClassDef)]:
        state_locks = set(_guard_registrations(sf, cls).values())
        if not state_locks:
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            held = [h for h in sf.held_locks(node)
                    if h in {f"self.{lk}" for lk in state_locks}]
            if not held:
                continue
            f = node.func
            blocking = None
            if isinstance(f, ast.Attribute) and f.attr in BLOCKING_ATTRS:
                # <state lock>.wait()/.notify() are the cv working as
                # designed, not blocking-under-lock; Attribute receivers
                # that are themselves the held lock never match because
                # wait/notify aren't in BLOCKING_ATTRS.
                blocking = f".{f.attr}()"
            elif isinstance(f, ast.Name) and f.id in BLOCKING_FUNCS:
                blocking = f"{f.id}()"
            if blocking is None:
                continue
            msg = (f"blocking call {blocking} while holding state lock(s) "
                   f"{', '.join(held)} — release the lock around I/O/waits "
                   f"(cv.wait on the held cv is the sanctioned way to "
                   f"block)")
            findings.append(Finding(
                sf.path, node.lineno, "block", msg,
                suppressed=sf.suppressed("block", node)))
    return findings


# ----------------------------------------------------------------------
# wire-error completeness
# ----------------------------------------------------------------------

WIRE_ROOTS = {"RemoteError", "ChannelClosed"}
DISPOSITIONS = {"retry", "rehome", "reraise", "failover", "teardown"}


def _class_index(project: Project) -> dict:
    idx: dict[str, tuple[SourceFile, ast.ClassDef]] = {}
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                idx.setdefault(node.name, (sf, node))
    return idx


def _base_names(cls: ast.ClassDef) -> set:
    names = set()
    for b in cls.bases:
        if isinstance(b, ast.Name):
            names.add(b.id)
        elif isinstance(b, ast.Attribute):
            names.add(b.attr)
    return names


def wire_rule(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    classes = _class_index(project)
    # transitive descendants of the wire-error roots
    wire_classes: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, (_, cls) in classes.items():
            if name in wire_classes or name in WIRE_ROOTS:
                continue
            if _base_names(cls) & (WIRE_ROOTS | wire_classes):
                wire_classes.add(name)
                changed = True
    required = wire_classes | ({"RemoteError"} & set(classes))

    # locate the WIRE_ERRORS table
    table = None
    table_sf, table_line = None, 0
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "WIRE_ERRORS":
                try:
                    table = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    table = None
                table_sf, table_line = sf, node.lineno
    if table is None:
        if required:
            anchor = table_sf or project.files[0]
            findings.append(Finding(
                anchor.path, table_line or 1, "wire",
                "no literal WIRE_ERRORS table found (expected in "
                "repro_torch/core/serialization.py): typed wire errors "
                f"{sorted(required)} have no declared dispositions"))
        return findings

    # every meta flag _remote_exception understands
    mapper_consts: set[str] = set()
    for sf in project.files:
        for fn in functions(sf.tree):
            if fn.name == "_remote_exception":
                mapper_consts |= {
                    n.value for n in ast.walk(fn)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    # exception-tuple aliases (e.g. ``_FAILOVER_EXC = (RemoteError, ...)``
    # at class or module level) so ``except self._FAILOVER_EXC:`` counts as
    # a handler for each member
    aliases: dict[str, set[str]] = {}
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Tuple):
                members = {e.id if isinstance(e, ast.Name) else e.attr
                           for e in node.value.elts
                           if isinstance(e, (ast.Name, ast.Attribute))}
                if members and members & (required | WIRE_ROOTS):
                    aliases.setdefault(
                        node.targets[0].id, set()).update(members)
    handlers: set[str] = set()
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is not None:
                types = (node.type.elts
                         if isinstance(node.type, ast.Tuple) else [node.type])
                for t in types:
                    if isinstance(t, ast.Name):
                        handlers.add(t.id)
                        handlers |= aliases.get(t.id, set())
                    elif isinstance(t, ast.Attribute):
                        handlers.add(t.attr)
                        handlers |= aliases.get(t.attr, set())

    for name in sorted(required):
        sf, cls = classes[name]
        entry = table.get(name)
        if entry is None:
            findings.append(Finding(
                sf.path, cls.lineno, "wire",
                f"typed wire error {name} missing from the WIRE_ERRORS "
                f"table — declare its meta flag and client disposition"))
            continue
        if not isinstance(entry, dict) or "flag" not in entry \
                or entry.get("disposition") not in DISPOSITIONS:
            findings.append(Finding(
                table_sf.path, table_line, "wire",
                f"WIRE_ERRORS[{name!r}] must carry a 'flag' (meta key or "
                f"None) and a 'disposition' in {sorted(DISPOSITIONS)}"))
            continue
        flag = entry["flag"]
        if flag is not None and flag not in mapper_consts:
            findings.append(Finding(
                table_sf.path, table_line, "wire",
                f"WIRE_ERRORS[{name!r}] flag {flag!r} is not mapped by "
                f"executor._remote_exception — the client would see a "
                f"generic RemoteError"))
        if name not in handlers:
            findings.append(Finding(
                sf.path, cls.lineno, "wire",
                f"typed wire error {name} has no client-side `except` "
                f"handler anywhere under analysis — no retry/re-home/"
                f"re-raise disposition is actually implemented"))
    for name in sorted(set(table) - required):
        findings.append(Finding(
            table_sf.path, table_line, "wire",
            f"WIRE_ERRORS entry {name!r} matches no RemoteError/"
            f"ChannelClosed subclass under analysis — stale entry"))
    return findings
