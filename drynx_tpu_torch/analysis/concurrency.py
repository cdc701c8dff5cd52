"""Concurrency analysis: thread entries, lock sets, lock order, races.

The serving stack is genuinely concurrent — verify-worker pools, drain
threads, ``fan_out`` RPC workers, async proof-delivery threads, pooled
sockets — and every thread-safety claim so far was a hand audit. This
engine turns those claims into machine-checked facts over the
project graphs, in four stages:

1. **thread-entry discovery** — every concurrent entry point:
   ``threading.Thread(target=...)`` (name, ``self.method``, lambda and
   wrapper-factory forms), ``threading.Timer``, executor
   ``.submit``/``.map``, and the repo's ``fan_out(entries, mk, call)``
   dispatcher whose ``call`` argument (default ``call_entry``) runs on a
   pool of ``FAN_OUT_WORKERS`` threads. Entries spawned in a loop, from
   an executor or by ``fan_out`` are *multi-instance*: they race with
   themselves, not just with other entries.

2. **shared-state inference** — over everything reachable from the
   entries along the callgraph, mutations of module globals (``global``
   rebinds, aug-assigns, subscript stores), class attributes
   (``self.x = ...`` outside ``__init__``) and container mutators (the
   dataflow engine's mutator set). A state mutated from two different
   entries — or from one multi-instance entry — is *shared*.

3. **lock-set analysis** — flow-sensitive tracking of ``with lock:``
   regions and bare ``acquire()``/``release()`` pairs, joined by
   intersection across ``if``/``else`` and ``try`` branches, propagated
   interprocedurally (the held set at a call site flows into the
   callee). A shared mutation site whose lock set shares nothing with
   some other concurrent context's lock set for the same state is an
   ``unguarded-shared-mutation``.

4. **lock-order graph** — every nested acquisition records an edge
   (outer, inner) with its entry and call chain; a cycle across the
   union graph is the classic deadlock shape (``lock-order-inversion``),
   rendered as a SARIF codeFlow via the usual chain hops. Re-acquiring
   an ``RLock`` already held never forms a self-edge. Alongside, a
   blocking call (socket/frame I/O, ``time.sleep``, subprocess, bare
   ``join()``) reachable while any lock is held is a
   ``blocking-call-under-lock`` — the latency hazard that invisibly
   serializes the serving tier.

Lock identity: a lock built via ``resilience.policy.named_lock("name")``
is keyed on that literal — the same name the runtime recorder
(:mod:`.locktrace`) reports, which is what lets the chaos cross-check
assert observed acquisition order is a subgraph of this graph. Unnamed
locks get positional ids (``module:Class.attr`` / ``module:NAME``);
attribute chains that escape static reach (``self.cluster._proof_lock``)
fall back to a unique leaf-name match over the known lock definitions.

Known over-approximations (the reference's ANALYSIS.md documents them): per-instance
class locks alias by class, dynamically dispatched handlers are invisible
to the callgraph, and a loop body's acquisitions are assumed released by
loop exit. The engine errs toward flagging; dual-anchor ``noqa`` (at the
site or the entry) absorbs deliberate exceptions.

Still pure ``ast``, still no torch import. The whole run is memoized on
the project content fingerprint like the dataflow engine.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import ModuleInfo, _dotted, _local_bindings
from .dataflow import (RawFinding, _MUTATOR_LEAVES, project_fingerprint)
from .graph import FuncNode, ModuleGraph, _calls_with_scope, _own_returns
from .project import ProjectInfo, chain_hop

_MAX_DEPTH = 8

# Container mutators: the dataflow engine's plus the removal half.
_MUTATORS = _MUTATOR_LEAVES | {"pop", "popleft", "popitem", "clear",
                               "remove", "discard"}

_LOCK_CTORS = {"Lock", "RLock"}

# Blocking leaves. Full dotted names where the leaf alone is too generic
# (`subprocess.run` vs every other `run`); method/function leaves where
# the name is specific enough on its own.
_BLOCKING_DOTTED = {"time.sleep", "subprocess.run", "subprocess.call",
                    "subprocess.check_output", "subprocess.check_call",
                    "subprocess.Popen", "socket.create_connection",
                    "select.select"}
_BLOCKING_LEAVES = {"recv_frame", "send_frame", "recv_msg", "send_msg",
                    "sendall", "recv", "recv_into", "accept"}
_BLOCKING_DOTTED_LEAVES = {d.split(".")[-1] for d in _BLOCKING_DOTTED}
# `t.join()` / `q.join()` with no positional args blocks; `sep.join(xs)`
# does not — the argument count is the discriminator.
_BLOCKING_NOARG_METHODS = {"join"}


def _is_drynx_pkg(mod: ModuleInfo) -> bool:
    # same opt-in as rules.py (local copy: rules.py imports this module)
    return (mod.relpath.startswith("drynx_tpu_torch/")
            or "/drynx_tpu_torch/" in mod.relpath
            or "lintpkg" in mod.relpath)


@dataclasses.dataclass(frozen=True)
class LockDef:
    """One statically known lock object."""
    lock_id: str                 # diagnostic name or positional id
    reentrant: bool
    file: str
    line: int


@dataclasses.dataclass(frozen=True)
class ThreadEntry:
    """One concurrent entry point (a function some thread runs)."""
    fid: str
    kind: str                    # thread-target|timer|executor|fan-out
    file: str                    # spawn-site file
    line: int                    # spawn-site line
    multi: bool                  # may run >1 instance concurrently


@dataclasses.dataclass(frozen=True)
class EdgeWitness:
    entry: str                   # entry fid that exhibits the order
    file: str                    # inner acquisition site
    line: int
    chain: Tuple[str, ...]       # entry -> ... -> outer acq -> inner acq


def _lock_ctor(call: ast.AST) -> Optional[Tuple[str, bool]]:
    """(name_literal_or_None, reentrant) when ``call`` constructs a lock:
    ``threading.Lock()`` / ``RLock()`` / ``named_lock("x"[, reentrant=])``.
    Returned name is the named_lock literal, or "" for anonymous."""
    if not isinstance(call, ast.Call):
        return None
    d = _dotted(call.func) or ""
    leaf = d.split(".")[-1]
    if leaf in _LOCK_CTORS:
        return "", leaf == "RLock"
    if leaf == "named_lock":
        name = ""
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            name = call.args[0].value
        reentrant = any(
            kw.arg == "reentrant" and isinstance(kw.value, ast.Constant)
            and bool(kw.value.value) for kw in call.keywords)
        return name, reentrant
    return None


class Concurrency:
    """Whole-program concurrency facts over a :class:`ProjectInfo`.

    After :meth:`run`: ``entries`` (fid -> ThreadEntry), ``lock_defs``
    (lock_id -> LockDef), ``lock_order`` ((outer, inner) -> EdgeWitness)
    and the three raw finding lists the project rules consume."""

    def __init__(self, project: ProjectInfo):
        self.project = project
        self.entries: Dict[str, ThreadEntry] = {}
        self.lock_defs: Dict[str, LockDef] = {}
        # (module, name) -> lock_id for module-global locks
        self._module_locks: Dict[Tuple[str, str], str] = {}
        # (module, class, attr) -> lock_id for self-attribute locks
        self._attr_locks: Dict[Tuple[str, str, str], str] = {}
        # leaf attr/name -> {lock_id}: fallback for self.obj._leaf chains
        self._leaf_index: Dict[str, Set[str]] = {}
        # top-level class names per module (to read Class from fn.qual)
        self._classes: Dict[str, Set[str]] = {}
        # state -> entry fid -> [(file, line, held, chain)]
        self.mut_sites: Dict[str, Dict[str, List[
            Tuple[str, int, FrozenSet[str], Tuple[str, ...]]]]] = {}
        self.lock_order: Dict[Tuple[str, str], EdgeWitness] = {}
        # (file, line) -> (leaf, held, chain)
        self._blocking: Dict[Tuple[str, int],
                             Tuple[str, FrozenSet[str],
                                   Tuple[str, ...]]] = {}
        self.unguarded_raw: List[RawFinding] = []
        self.cycle_raw: List[RawFinding] = []
        self.blocking_raw: List[RawFinding] = []
        # fid -> (locals, global-decls, {id(call): callee}) — a function
        # is re-walked once per distinct held set, but its AST facts
        # never change
        self._fn_facts: Dict[str, Tuple[Set[str], Set[str],
                                        Dict[int, str]]] = {}

    # -- the run ----------------------------------------------------------

    def run(self) -> "Concurrency":
        self._collect_locks()
        self._collect_entries()
        self._record_muts = True
        for fid in sorted(self.entries):
            fn = self.project.calls.functions.get(fid)
            if fn is not None:
                self._walk_entry(self.entries[fid], fn)
        # Supplemental whole-program pass: every function is ALSO a
        # synchronous (caller-thread) context. Shared-state inference
        # stays entry-scoped (the main thread reaching everything would
        # drown the race rule), but lock-order edges and blocking calls
        # must cover code the entry walk can't resolve — method calls on
        # unknown receivers (`conn.call(...)`), dynamic handler dispatch
        # — or the runtime recorder would observe acquisition edges the
        # static graph lacks and the dynamic-subgraph cross-check would
        # be unsound.
        self._record_muts = False
        self._visited = set()
        for fid in sorted(self.project.calls.functions):
            fn = self.project.calls.functions[fid]
            mg = self.project.graphs[fn.module]
            if not _is_drynx_pkg(mg.info):
                continue
            # the held set stays empty until the root itself acquires,
            # and every acquirer is its own root — so only functions
            # whose body can acquire are worth walking
            if not _acquires_syntactically(fn.node):
                continue
            self._entry = ThreadEntry(fid, "sync", mg.info.relpath,
                                      fn.node.lineno, False)
            self._walk_fn(fn, frozenset(),
                          (chain_hop(mg.info.relpath, fn.node.lineno,
                                     fn.qual),), 0)
        self._emit_unguarded()
        self._emit_cycles()
        self._emit_blocking()
        return self

    # -- stage 0: lock definitions ----------------------------------------

    def _add_lock(self, lock_id: str, reentrant: bool, mg: ModuleGraph,
                  lineno: int, leaf: str) -> None:
        if lock_id not in self.lock_defs:
            self.lock_defs[lock_id] = LockDef(lock_id, reentrant,
                                              mg.info.relpath, lineno)
        self._leaf_index.setdefault(leaf, set()).add(lock_id)

    def _collect_locks(self) -> None:
        for dotted in sorted(self.project.graphs):
            mg = self.project.graphs[dotted]
            if not _is_drynx_pkg(mg.info):
                continue
            self._classes[dotted] = {
                n.name for n in mg.info.tree.body
                if isinstance(n, ast.ClassDef)}
            # module-level NAME = Lock()/named_lock()
            for name, assigns in mg.info.module_assigns.items():
                for a in assigns:
                    got = _lock_ctor(a.value)
                    if got is None:
                        continue
                    lit, reentrant = got
                    lock_id = lit or f"{dotted}:{name}"
                    self._module_locks[(dotted, name)] = lock_id
                    self._add_lock(lock_id, reentrant, mg, a.lineno, name)
            # self.attr = Lock()/named_lock() in any method of a class
            for qual, fn in mg.functions.items():
                cls = qual.split(".")[0]
                if cls not in self._classes[dotted] or "." not in qual:
                    continue
                for stmt in ast.walk(fn.node):
                    if not isinstance(stmt, ast.Assign):
                        continue
                    got = _lock_ctor(stmt.value)
                    if got is None:
                        continue
                    for t in stmt.targets:
                        d = _dotted(t)
                        if not d or not d.startswith("self.") \
                                or d.count(".") != 1:
                            continue
                        attr = d.split(".")[1]
                        lit, reentrant = got
                        lock_id = lit or f"{dotted}:{cls}.{attr}"
                        self._attr_locks[(dotted, cls, attr)] = lock_id
                        self._add_lock(lock_id, reentrant, mg,
                                       stmt.lineno, attr)

    # -- stage 1: thread entries ------------------------------------------

    def _note_entry(self, fn: Optional[FuncNode], kind: str,
                    mg: ModuleGraph, lineno: int, multi: bool) -> None:
        if fn is None:
            return
        prev = self.entries.get(fn.fid)
        if prev is None:
            self.entries[fn.fid] = ThreadEntry(
                fn.fid, kind, mg.info.relpath, lineno, multi)
        elif multi and not prev.multi:
            self.entries[fn.fid] = dataclasses.replace(prev, multi=True)

    def _callable_target(self, mg: ModuleGraph, scope: Sequence[str],
                         expr: ast.AST) -> List[FuncNode]:
        """FuncNodes a thread-target expression may run: a name, a
        ``self.method`` reference, a lambda's callees, or a wrapper
        factory call returning a nested worker function."""
        calls = self.project.calls
        if isinstance(expr, ast.Name):
            fn = calls._resolve_name(mg, scope, expr.id)
            return [fn] if fn is not None else []
        if isinstance(expr, ast.Attribute):
            fn = calls._resolve_attribute(mg, expr)
            return [fn] if fn is not None else []
        if isinstance(expr, ast.Lambda):
            out = []
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    got = calls.resolve_call(mg, scope, sub)
                    if got is not None:
                        out.append(got)
            return out
        if isinstance(expr, ast.Call):
            # wrapper factory: target=make_worker(cfg) — the entry is the
            # nested function make_worker returns
            factory = calls.resolve_call(mg, scope, expr)
            if factory is None:
                return []
            fmg = self.project.graphs[factory.module]
            out = []
            for ret in _own_returns(factory.node):
                if isinstance(ret.value, ast.Name):
                    qual = f"{factory.qual}.{ret.value.id}"
                    nested = fmg.functions.get(qual)
                    if nested is not None:
                        out.append(nested)
            return out
        return []

    _ENTRY_LEAVES = frozenset({"Thread", "Timer", "submit", "map",
                               "fan_out"})

    def _collect_entries(self) -> None:
        for dotted in sorted(self.project.graphs):
            mg = self.project.graphs[dotted]
            if not _is_drynx_pkg(mg.info):
                continue
            loops: Optional[Set[int]] = None  # computed on first match
            for scope, call in _calls_with_scope(mg):
                leaf = _leaf_of(call.func)
                if leaf not in self._ENTRY_LEAVES:
                    continue
                d = _dotted(call.func) or ""
                if loops is None:
                    loops = _loop_lines(mg.info.tree)
                in_loop = call.lineno in loops
                if leaf in ("Thread", "Timer") and (
                        d in ("Thread", "Timer")
                        or d.startswith("threading.")):
                    target = next((kw.value for kw in call.keywords
                                   if kw.arg in ("target", "function")),
                                  None)
                    if target is None and leaf == "Timer" \
                            and len(call.args) >= 2:
                        target = call.args[1]
                    for fn in self._callable_target(mg, scope, target) \
                            if target is not None else []:
                        self._note_entry(fn, "timer" if leaf == "Timer"
                                         else "thread-target",
                                         mg, call.lineno, in_loop)
                elif leaf in ("submit", "map") \
                        and isinstance(call.func, ast.Attribute) \
                        and call.args:
                    for fn in self._callable_target(mg, scope,
                                                    call.args[0]):
                        self._note_entry(fn, "executor", mg,
                                         call.lineno, True)
                elif leaf == "fan_out":
                    # fan_out(entries, make_msg, call=..., ...): the call
                    # argument runs on FAN_OUT_WORKERS pool threads;
                    # default is call_entry in the defining module
                    target = next((kw.value for kw in call.keywords
                                   if kw.arg == "call"), None)
                    if target is None and len(call.args) >= 3:
                        target = call.args[2]
                    if target is not None:
                        for fn in self._callable_target(mg, scope, target):
                            self._note_entry(fn, "fan-out", mg,
                                             call.lineno, True)
                    else:
                        fan = self.project.calls.resolve_call(mg, scope,
                                                              call)
                        if fan is not None:
                            fmg = self.project.graphs[fan.module]
                            self._note_entry(
                                fmg.lookup_function("call_entry"),
                                "fan-out", mg, call.lineno, True)

    # -- stage 2+3: the interprocedural walk ------------------------------

    def _walk_entry(self, entry: ThreadEntry, fn: FuncNode) -> None:
        mg = self.project.graphs[fn.module]
        chain = (chain_hop(entry.file, entry.line,
                           f"thread entry {fn.qual}"),)
        self._entry = entry
        self._visited: Set[Tuple[str, FrozenSet[str]]] = set()
        self._walk_fn(fn, frozenset(), chain, 0)

    def _walk_fn(self, fn: FuncNode, held: FrozenSet[str],
                 chain: Tuple[str, ...], depth: int) -> None:
        key = (fn.fid, held)
        if key in self._visited or depth > _MAX_DEPTH:
            return
        self._visited.add(key)
        mg = self.project.graphs[fn.module]
        ctx = _FnCtx(self, mg, fn, chain, depth)
        ctx.exec_stmts(fn.node.body, held)

    # -- recording (called from _FnCtx) -----------------------------------

    def _record_mutation(self, state: str, file: str, line: int,
                         held: FrozenSet[str],
                         chain: Tuple[str, ...]) -> None:
        if not self._record_muts:
            return
        guard = frozenset(l for l in held if not l.startswith("local:"))
        per_entry = self.mut_sites.setdefault(state, {})
        per_entry.setdefault(self._entry.fid, []).append(
            (file, line, guard, chain))

    def _record_edge(self, outer: str, inner: str, file: str, line: int,
                     chain: Tuple[str, ...]) -> None:
        if outer == inner:
            return  # RLock re-entry / idempotent with — never a self-edge
        self.lock_order.setdefault(
            (outer, inner),
            EdgeWitness(self._entry.fid, file, line, chain))

    def _record_blocking(self, leaf: str, file: str, line: int,
                         held: FrozenSet[str],
                         chain: Tuple[str, ...]) -> None:
        self._blocking.setdefault((file, line), (leaf, held, chain))

    # -- lock resolution ---------------------------------------------------

    def _resolve_lock(self, mg: ModuleGraph, fn: FuncNode,
                      aliases: Dict[str, str],
                      expr: ast.AST) -> Optional[str]:
        d = _dotted(expr)
        if not d:
            return None
        parts = d.split(".")
        cls = fn.qual.split(".")[0]
        if cls not in self._classes.get(mg.dotted, ()):
            cls = ""
        if len(parts) == 1:
            name = parts[0]
            if name in aliases:
                return aliases[name]
            dm, dn, _ = self.project.imports.resolve(mg.dotted, name)
            return self._module_locks.get((dm, dn))
        if parts[0] in ("self", "cls"):
            attr = parts[-1]
            if len(parts) == 2 and cls:
                got = self._attr_locks.get((mg.dotted, cls, attr))
                if got is not None:
                    return got
                if "lock" in attr.lower():
                    return f"{mg.dotted}:{cls}.{attr}"
                return None
            # longer chain (self.cluster._proof_device_lock): unique
            # leaf-name match over the known defs, else a leaf-keyed id
            ids = self._leaf_index.get(attr, ())
            if len(ids) == 1:
                return next(iter(ids))
            if "lock" in attr.lower():
                return f"attr:{attr}"
            return None
        if len(parts) == 2:
            target = self.project.imports.module_for_alias(mg.dotted,
                                                           parts[0])
            if target is not None:
                got = self._module_locks.get((target, parts[1]))
                if got is not None:
                    return got
        attr = parts[-1]
        ids = self._leaf_index.get(attr, ())
        if len(ids) == 1:
            return next(iter(ids))
        if "lock" in attr.lower():
            return f"attr:{attr}"
        return None

    def _is_reentrant(self, lock_id: str) -> bool:
        d = self.lock_defs.get(lock_id)
        return d is not None and d.reentrant

    # -- stage 4: findings -------------------------------------------------

    def _entry_label(self, fid: str) -> str:
        e = self.entries[fid]
        mult = " x N" if e.multi else ""
        return f"{fid.split(':', 1)[-1]} ({e.kind}{mult})"

    def _emit_unguarded(self) -> None:
        for state in sorted(self.mut_sites):
            per_entry = self.mut_sites[state]
            weight = sum(2 if self.entries[f].multi else 1
                         for f in per_entry)
            if weight < 2:
                continue
            # per-entry lock set: provably held at EVERY mutation of the
            # state from that entry
            locksets = {f: frozenset.intersection(
                *[h for _, _, h, _ in sites])
                for f, sites in per_entry.items()}
            contexts = sorted(per_entry)
            for fid in contexts:
                others = [locksets[o] for o in contexts if o != fid]
                if self.entries[fid].multi:
                    others.append(locksets[fid])
                mine = locksets[fid]
                if others and all(mine & o for o in others):
                    continue
                reported: Set[Tuple[str, int]] = set()
                for file, line, held, chain in per_entry[fid]:
                    if (file, line) in reported:
                        continue
                    reported.add((file, line))
                    names = ", ".join(sorted(held)) or "no lock"
                    ents = ", ".join(self._entry_label(f)
                                     for f in contexts)
                    self.unguarded_raw.append(RawFinding(
                        file=file, line=line,
                        message=(
                            f"shared state '{state}' is mutated from "
                            f"{len(contexts)} concurrent context(s) "
                            f"[{ents}] holding {names} here — no lock "
                            f"is common to all mutating threads"),
                        chain=chain + (chain_hop(file, line,
                                                 f"mutates {state}"),),
                        anchors=self._anchors(chain, file, line)))
        self.unguarded_raw.sort(key=lambda r: (r.file, r.line))

    def _emit_cycles(self) -> None:
        # union lock-order graph over non-local locks; a cycle means two
        # threads can each hold one lock while waiting for the other
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.lock_order:
            if a.startswith("local:") or b.startswith("local:"):
                continue
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[FrozenSet[str]] = set()
        for start in sorted(graph):
            cycle = _find_cycle(graph, start)
            if cycle is None or frozenset(cycle) in seen_cycles:
                continue
            seen_cycles.add(frozenset(cycle))
            edges = [(cycle[i], cycle[(i + 1) % len(cycle)])
                     for i in range(len(cycle))]
            chain: List[str] = []
            anchors: List[Tuple[str, int]] = []
            for e in edges:
                w = self.lock_order[e]
                for hop in w.chain:
                    if hop not in chain:
                        chain.append(hop)
                chain.append(chain_hop(w.file, w.line,
                                       f"acquires {e[1]} while "
                                       f"holding {e[0]}"))
                anchors.append((w.file, w.line))
            w0 = self.lock_order[edges[0]]
            order = " -> ".join(cycle + [cycle[0]])
            self.cycle_raw.append(RawFinding(
                file=w0.file, line=w0.line,
                message=(f"lock-order inversion: {order} — different "
                         f"threads acquire these locks in conflicting "
                         f"order (deadlock when they interleave)"),
                chain=tuple(chain[:12]),
                anchors=tuple(anchors)))
        self.cycle_raw.sort(key=lambda r: (r.file, r.line))

    def _emit_blocking(self) -> None:
        for (file, line) in sorted(self._blocking):
            leaf, held, chain = self._blocking[(file, line)]
            names = ", ".join(sorted(held))
            self.blocking_raw.append(RawFinding(
                file=file, line=line,
                message=(f"blocking call '{leaf}' while holding "
                         f"[{names}] — every thread contending on the "
                         f"lock serializes behind this wait"),
                chain=chain + (chain_hop(file, line, f"{leaf}()"),),
                anchors=self._anchors(chain, file, line)))

    @staticmethod
    def _anchors(chain: Tuple[str, ...], file: str,
                 line: int) -> Tuple[Tuple[str, int], ...]:
        """Dual anchors: the site plus the entry hop (suppressible at
        either)."""
        out = [(file, line)]
        if chain:
            first = chain[0].split(":", 2)
            if len(first) == 3 and first[1].isdigit():
                out.append((first[0], int(first[1])))
        return tuple(out)

    # -- cross-validation surface ------------------------------------------

    def named_lock_edges(self) -> Set[Tuple[str, str]]:
        """Acquisition-order edges between *named* locks (ids that carry
        no positional ``module:``/``attr:``/``local:`` shape) — the
        static side of the DRYNX_LOCK_TRACE runtime cross-check."""
        def named(lid: str) -> bool:
            return ":" not in lid and "." not in lid
        return {(a, b) for (a, b) in self.lock_order
                if named(a) and named(b)}


# -- flow-sensitive statement executor --------------------------------------

class _FnCtx:
    """Executes one function body with a held-lock set, recording
    mutations, acquisition edges and blocking calls; recurses into
    resolvable callees with the held set at the call site."""

    def __init__(self, eng: Concurrency, mg: ModuleGraph, fn: FuncNode,
                 chain: Tuple[str, ...], depth: int):
        self.eng = eng
        self.mg = mg
        self.fn = fn
        self.chain = chain
        self.depth = depth
        self.rel = mg.info.relpath
        self.aliases: Dict[str, str] = {}
        facts = eng._fn_facts.get(fn.fid)
        if facts is None:
            globals_decl: Set[str] = set()
            for sub in ast.walk(fn.node):
                if isinstance(sub, ast.Global):
                    globals_decl.update(sub.names)
            facts = (_local_bindings(fn.node), globals_decl,
                     {id(s.node): s.callee
                      for s in eng.project.calls.callees(fn.fid)})
            eng._fn_facts[fn.fid] = facts
        self.locals, self.globals_decl, self.sites = facts
        self.is_init = fn.qual.split(".")[-1] == "__init__"

    # -- statements --------------------------------------------------------

    def exec_stmts(self, stmts: Sequence[ast.stmt],
                   held: FrozenSet[str]) -> FrozenSet[str]:
        for stmt in stmts:
            held = self.exec_stmt(stmt, held)
        return held

    def exec_stmt(self, stmt: ast.stmt,
                  held: FrozenSet[str]) -> FrozenSet[str]:
        if isinstance(stmt, ast.With):
            locks: List[str] = []
            for item in stmt.items:
                self.scan_expr(item.context_expr, held)
                lid = self.eng._resolve_lock(self.mg, self.fn,
                                             self.aliases,
                                             item.context_expr)
                if lid is not None:
                    for h in held | frozenset(locks):
                        self.eng._record_edge(
                            h, lid, self.rel, item.context_expr.lineno,
                            self.chain + (chain_hop(
                                self.rel, item.context_expr.lineno,
                                f"with {lid}"),))
                    locks.append(lid)
            self.exec_stmts(stmt.body, held | frozenset(locks))
            return held
        if isinstance(stmt, ast.If):
            self.scan_expr(stmt.test, held)
            h1 = self.exec_stmts(stmt.body, held)
            h2 = self.exec_stmts(stmt.orelse, held)
            return h1 & h2
        if isinstance(stmt, ast.Try):
            hb = self.exec_stmts(stmt.body, held)
            out = self.exec_stmts(stmt.orelse, hb) if stmt.orelse else hb
            for handler in stmt.handlers:
                out = out & self.exec_stmts(handler.body, held)
            if stmt.finalbody:
                out = self.exec_stmts(stmt.finalbody, out)
            return out
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.scan_expr(stmt.iter, held)
            self.mutation_target(stmt.target, held)
            self.exec_stmts(stmt.body, held)
            self.exec_stmts(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.While):
            self.scan_expr(stmt.test, held)
            self.exec_stmts(stmt.body, held)
            self.exec_stmts(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return held  # nested defs are their own callgraph nodes
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            if value is not None:
                held = self.scan_expr(value, held)
            for t in targets:
                self.mutation_target(t, held)
            # lock aliasing: x = <lock expr> / x = Lock()
            if isinstance(stmt, ast.Assign) and value is not None \
                    and len(targets) == 1 \
                    and isinstance(targets[0], ast.Name):
                name = targets[0].id
                ctor = _lock_ctor(value)
                if ctor is not None:
                    lit, reentrant = ctor
                    lid = lit or f"local:{self.fn.fid}:{name}"
                    self.aliases[name] = lid
                    if lid not in self.eng.lock_defs:
                        self.eng.lock_defs[lid] = LockDef(
                            lid, reentrant, self.rel, stmt.lineno)
                else:
                    lid = self.eng._resolve_lock(self.mg, self.fn,
                                                 self.aliases, value)
                    if lid is not None:
                        self.aliases[name] = lid
            return held
        if isinstance(stmt, ast.Expr):
            return self.scan_expr(stmt.value, held)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                self.scan_expr(child, held)
            return held
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                held = self.scan_expr(child, held)
            elif isinstance(child, ast.stmt):
                held = self.exec_stmt(child, held)
        return held

    # -- expressions -------------------------------------------------------

    def scan_expr(self, expr: ast.AST,
                  held: FrozenSet[str]) -> FrozenSet[str]:
        """Visit calls in an expression (not into nested defs/lambdas);
        returns the possibly-updated held set (bare acquire/release)."""
        for node in _expr_calls(expr):
            held = self.visit_call(node, held)
        return held

    def visit_call(self, call: ast.Call,
                   held: FrozenSet[str]) -> FrozenSet[str]:
        leaf = _leaf_of(call.func)
        if isinstance(call.func, ast.Attribute):
            recv = call.func.value
            if leaf in ("acquire", "release"):
                lid = self.eng._resolve_lock(self.mg, self.fn,
                                             self.aliases, recv)
                if lid is not None:
                    if leaf == "acquire":
                        for h in held:
                            self.eng._record_edge(
                                h, lid, self.rel, call.lineno,
                                self.chain + (chain_hop(
                                    self.rel, call.lineno,
                                    f"{lid}.acquire()"),))
                        return held | {lid}
                    return held - {lid}
            if leaf in _MUTATORS:
                state = self.state_of(recv)
                if state is not None:
                    self.eng._record_mutation(state, self.rel,
                                              call.lineno, held,
                                              self.chain)
        if held and not self.is_init:
            blocking = (leaf in _BLOCKING_LEAVES
                        or (leaf in _BLOCKING_DOTTED_LEAVES
                            and (_dotted(call.func) or "")
                            in _BLOCKING_DOTTED)
                        or (leaf in _BLOCKING_NOARG_METHODS
                            and isinstance(call.func, ast.Attribute)
                            and not call.args))
            if blocking:
                self.eng._record_blocking(leaf, self.rel, call.lineno,
                                          held, self.chain)
        # interprocedural hop
        callee_fid = self.sites.get(id(call))
        if callee_fid is not None \
                and callee_fid not in self.eng.entries:
            callee = self.eng.project.calls.functions.get(callee_fid)
            if callee is not None:
                hop = chain_hop(self.rel, call.lineno, callee.qual)
                self.eng._walk_fn(callee, held, self.chain + (hop,),
                                  self.depth + 1)
        return held

    # -- shared-state targets ----------------------------------------------

    def mutation_target(self, target: ast.AST,
                        held: FrozenSet[str]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self.mutation_target(el, held)
            return
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Starred):
            node = node.value
        state = self.state_of(node, store=target is node)
        if state is not None:
            self.eng._record_mutation(state, self.rel, target.lineno,
                                      held, self.chain)

    def state_of(self, node: ast.AST,
                 store: bool = False) -> Optional[str]:
        """Canonical shared-state id for a mutated expression root:
        ``module:NAME`` for module globals, ``module:Class.attr`` for
        instance/class attributes; None for locals and unknowns."""
        if isinstance(node, ast.Name):
            name = node.id
            if store:
                # plain `x = ...` rebinding is a local unless global-decl
                if name not in self.globals_decl:
                    return None
            else:
                # container/subscript mutation through a name: global if
                # not locally bound and defined at module level
                if name in self.locals and name not in self.globals_decl:
                    return None
                if name not in self.globals_decl \
                        and name not in self.mg.info.module_assigns \
                        and name not in self.mg.froms:
                    return None
            dm, dn, _ = self.eng.project.imports.resolve(self.mg.dotted,
                                                         name)
            if dm not in self.eng.project.graphs:
                return None
            return f"{dm}:{dn}"
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if not d:
                return None
            parts = d.split(".")
            if parts[0] in ("self", "cls") and len(parts) == 2:
                if self.is_init:
                    return None  # construction happens-before publication
                cls = self.fn.qual.split(".")[0]
                if cls not in self.eng._classes.get(self.mg.dotted, ()):
                    return None
                return f"{self.mg.dotted}:{cls}.{parts[1]}"
            if len(parts) == 2:
                target = self.eng.project.imports.module_for_alias(
                    self.mg.dotted, parts[0])
                if target is not None \
                        and target in self.eng.project.graphs:
                    return f"{target}:{parts[1]}"
        return None


# -- small AST helpers -------------------------------------------------------

def _expr_calls(expr: ast.AST):
    """Call nodes in an expression, outermost-first, not descending into
    lambdas or comprehension-free nested defs."""
    out: List[ast.Call] = []

    def visit(n: ast.AST) -> None:
        if isinstance(n, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            return
        if isinstance(n, ast.Call):
            out.append(n)
        for c in ast.iter_child_nodes(n):
            visit(c)

    visit(expr)
    return out


def _leaf_of(func: ast.AST) -> str:
    """Last dotted component of a call target without building the whole
    dotted string — the hot path looks at every call in the package."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _acquires_syntactically(fn: ast.AST) -> bool:
    """Cheap prefilter: the function's own body (not nested defs) has a
    ``with`` statement or an ``.acquire()`` call — the only statements
    that can make the held set non-empty."""
    def visit(node: ast.AST) -> bool:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                return True
            if isinstance(child, ast.Call) \
                    and isinstance(child.func, ast.Attribute) \
                    and child.func.attr == "acquire":
                return True
            if visit(child):
                return True
        return False

    return visit(fn)


def _loop_lines(tree: ast.AST) -> Set[int]:
    """Line numbers lexically inside a For/While body (spawn-in-a-loop
    detection for multi-instance entries)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            end = getattr(node, "end_lineno", None)
            if end is not None:
                out.update(range(node.lineno, end + 1))
    return out


def _find_cycle(graph: Dict[str, Set[str]],
                start: str) -> Optional[List[str]]:
    """Shortest simple cycle through ``start`` (BFS over the digraph),
    as the node list [start, ..., last] with last -> start implied."""
    from collections import deque

    queue = deque([(start, [start])])
    seen = {start}
    while queue:
        node, path = queue.popleft()
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 1:
                return path
            if nxt not in seen:
                seen.add(nxt)
                queue.append((nxt, path + [nxt]))
    return None


# -- memoized entry point ----------------------------------------------------

_CC_CACHE: Dict[str, Concurrency] = {}
_CC_CACHE_MAX = 8


def concurrency_for(project: ProjectInfo) -> Concurrency:
    """The (memoized) engine run for a project — the three consuming
    rules, repeated analyze_project calls and the lock-trace cross-check
    all share one run per tree version. The result is whole-program;
    ``--changed-only`` focus filtering happens in the rules."""
    fp = project_fingerprint(project)
    eng = _CC_CACHE.get(fp)
    if eng is None:
        if len(_CC_CACHE) >= _CC_CACHE_MAX:
            _CC_CACHE.clear()
        eng = Concurrency(project).run()
        _CC_CACHE[fp] = eng
    return eng
