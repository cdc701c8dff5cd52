"""Typestate analysis: resource-lifecycle protocols, machine-checked.

The last big correctness surface the prover family did not cover is
*resource lifecycles*: the crash-consistency and exactly-once
invariants that the pool, stream and checkpoint code only ever
enforced dynamically. This
engine proves them statically — a whole-program, flow-sensitive
typestate pass over the project graphs, in the shape of the dataflow,
concurrency and determinism engines.

Protocols are declarative finite automata over operations on a
tracked *resource instance*: a creation site starts an instance in
the protocol's start state, recognized transition calls move it
through the automaton, and non-accepting states at an exit (return,
raise, function end, rebind) — or an explicit error transition — are
findings. The engine tracks instances interprocedurally (parameter
passthrough, return propagation, aliasing through locals and tuple
unpacks), joins automaton states at branch merges (a may-analysis:
an instance *may* be in any state of its set; an exit passes if ANY
state is accepting — biased against false positives — while an
explicit error transition reports if ANY live state rejects, because
the dirty arm of a join is a real crash window even when a sibling
arm is clean), and walks loop bodies twice as a fixpoint
approximation. Every finding carries
the observed transition sites as a SARIF codeFlow with dual anchors
(violation site + creation site) so ``noqa`` works at either end.

The four shipped protocols:

* **atomic** (``atomic-durable-write``) — a write landing on a
  durable path (journal/ledger/ckpt/bench/slab/.npz/.db/proof
  hints in the path expression) must follow the tmp-file write →
  ``fsync`` → ``os.rename``/``os.replace`` idiom. Direct
  open-for-append is allowed only on journal paths whose module
  declares torn-tail-tolerant replay (a ``*replay*`` function);
  opening a durable path ``"w"`` in place and writing it is an
  error, as is publishing a tmp file whose bytes were never fsync'd.
* **slab** (``slab-consumption-order``) — the pool's single-consumption
  contract: claim-rename → fsync'd ledger append → read → unlink.
  Reading before the consume event is journaled, unlinking before
  the read, or leaving a claimed slab behind on a normal exit are
  all flagged (crash paths are exempt: the recovery sweep owns them).
* **conn** (``conn-checkout-discipline``) — a ``ConnPool`` checkout
  must reach exactly one of return-to-pool (``put``) or desync
  discard/close on every path *including exception edges*; after a
  transport-failure handler entry the conn is *suspect* and must be
  discarded, never reused or returned.
* **seal** (``seal-commit-once``) — the stream's and checkpoints' exactly-once
  contracts: a pane key is sealed (2-arg ``put``) at most once per
  instance per path, the pane proof-commit call is reachable at most
  once per path, and a checkpoint *loaded* from the store must
  re-enter a phase before it is saved again (a blind re-save
  overwrites the only evidence of where the resume started).

Known over-approximations (the reference's ANALYSIS.md): path classification is
textual (hints in the unparsed path expression / enclosing function
name); ambient events (``_ledger_append``) apply to every live
claimed slab; branch joins union states. Known under-approximations:
an instance passed to an unresolved call (or stored into an
attribute/container) escapes and is no longer exit-checked; an
instance created inside a ``try`` body is *unborn* on the handler
edge, so leaks of try-created instances on exception paths are
invisible. Still pure ``ast``, still no torch import; the whole run is
memoized on the project content fingerprint and focusable for
``--changed-only``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import (Dict, FrozenSet, List, Mapping, Optional, Sequence,
                    Set, Tuple)

from .core import ModuleInfo, _dotted, _local_bindings
from .dataflow import RawFinding, project_fingerprint
from .graph import FuncNode, ModuleGraph
from .project import ProjectInfo, chain_hop

_MAX_DEPTH = 8

_PROTOCOL_RE = re.compile(r"#\s*drynx:\s*protocol\[([^\]]+)\]")

# -- path / context classification tables ------------------------------------

# a path expression containing one of these is a *durable* surface
DURABLE_HINTS = ("jsonl", "journal", "ledger", "ckpt", "checkpoint",
                 "bench", "slab", ".npz", ".db", "proof", "record")
# ...and one of these marks a scratch file headed for an atomic publish
TMP_HINTS = ("tmp", "temp")
# an enclosing function whose name carries one of these is writing a
# durable artifact even when the path variable itself is bland
FN_DURABLE_HINTS = ("atomic", "journal", "ledger", "checkpoint", "ckpt",
                    "persist", "npz", "durable", "seal", "record")

# accepted-by-delegation creation sites: calls that *are* the idiom
_DELEGATED_ATOMIC = {"_atomic_write_npz"}
_JOURNAL_LEAVES = {"_ledger_append"}
_DB_CTORS = {"ProofDB"}

# leaves through which an open handle is written as an *argument*
_HANDLE_WRITE_LEAVES = {"dump", "save", "savez", "savez_compressed",
                        "write", "pack_into"}
# leaves that read a claimed slab path
_SLAB_READ_LEAVES = {"open", "load", "mmap", "memmap", "fromfile",
                     "read_bytes", "_load_npz_mapped"}

# exception names whose handler entry marks a checked-out conn suspect
_SUSPECT_EXC = {"CallTimeout", "TransportError", "ConnectError",
                "OSError", "ConnectionError", "BrokenPipeError",
                "timeout", "socket.timeout"}

# commit calls reachable at most once per path per function walk
_ONCE_LEAVES = {"_deliver_pane_proofs"}

# tokens worth recording on parameter sentinels for caller replay
_SENTINEL_TOKENS = {"put", "discard", "close", "use", "enter", "save",
                    "write", "fsync"}


def _is_drynx_pkg(mod: ModuleInfo) -> bool:
    return (mod.relpath.startswith("drynx_tpu_torch/")
            or "/drynx_tpu_torch/" in mod.relpath
            or "lintpkg" in mod.relpath)


def _unparse(e: Optional[ast.expr]) -> str:
    if e is None:
        return ""
    # memoized on the node: alias/argument texts are re-rendered at
    # every event match and the ASTs outlive the engine run
    s = getattr(e, "_ts_unparse", None)
    if s is None:
        try:
            s = ast.unparse(e)
        except Exception:  # pragma: no cover - malformed synthetic nodes
            s = ""
        try:
            e._ts_unparse = s
        except Exception:  # pragma: no cover - slotted synthetic nodes
            pass
    return s


# -- declarative automata ----------------------------------------------------

# Transition tables: token -> state -> next state. A next state
# prefixed "!" is an error transition (the message follows the "!").
# Unknown (token, state) pairs are identity; the special "unborn"
# state (instance may not exist on this path) absorbs every token,
# and "poisoned" (already reported) absorbs every token and accepts.

@dataclasses.dataclass(frozen=True)
class Protocol:
    key: str                              # short key used in raws
    title: str                            # human protocol name
    accepting: FrozenSet[str]
    table: Mapping[str, Mapping[str, str]]
    exit_error: str = ""                  # "" = every exit accepted
    exit_on_raise: bool = False           # also check on raise edges


_ATOMIC = Protocol(
    key="atomic",
    title="atomic-durable-write",
    accepting=frozenset({"published", "journal", "replay-read",
                         "delegated", "relaxed"}),
    table={
        "write": {
            "open": "dirty", "dirty": "dirty", "synced": "dirty",
            "relaxed": "relaxed",
            "in-place": ("!durable path written in place — write a "
                         "tmp file, fsync, then os.replace onto the "
                         "durable path"),
            "published": ("!tmp handle written after the file was "
                          "published"),
        },
        "fsync": {
            "open": "synced", "dirty": "synced", "synced": "synced",
            "relaxed": "relaxed", "in-place": "in-place",
        },
        "close": {
            "open": "closed-synced", "dirty": "closed-dirty",
            "synced": "closed-synced", "relaxed": "relaxed",
            "in-place": "in-place",
        },
        "rename": {
            "synced": "published", "closed-synced": "published",
            "open": "published", "relaxed": "relaxed",
            "dirty": ("!tmp file renamed onto the durable path "
                      "before fsync — a crash can publish a torn "
                      "file"),
            "closed-dirty": ("!tmp file renamed onto the durable "
                             "path before fsync — a crash can "
                             "publish a torn file"),
        },
    },
    exit_error=("durable tmp write never published — the path must "
                "reach os.replace/os.rename after fsync on every "
                "normal exit"),
)

_SLAB = Protocol(
    key="slab",
    title="slab-consumption-order",
    accepting=frozenset({"consumed"}),
    table={
        "ledger": {
            "claimed": "journaled", "journaled": "journaled",
            "read": "read",
        },
        "read": {
            "journaled": "read", "read": "read",
            "claimed": ("!claimed slab read before the consume "
                        "event is journaled — a crash between read "
                        "and append double-spends the slab"),
        },
        "unlink": {
            "read": "consumed",
            "journaled": "!slab unlinked before it was read",
            "claimed": ("!slab unlinked before the consume event "
                        "is journaled"),
        },
    },
    exit_error=("claimed slab never unlinked on this path — the "
                "claim-rename leaves a .claimed orphan the recovery "
                "sweep must garbage-collect"),
)

_CONN = Protocol(
    key="conn",
    title="conn-checkout-discipline",
    accepting=frozenset({"returned", "discarded", "closed"}),
    table={
        "use": {
            "checked-out": "checked-out",
            "suspect": ("!conn reused after a transport failure — "
                        "the stream may be desynchronized "
                        "(half-sent frame); discard it"),
            "returned": "!conn used after it was returned to the pool",
            "discarded": "!conn used after it was discarded",
            "closed": "!conn used after close",
        },
        "put": {
            "checked-out": "returned",
            "suspect": ("!conn returned to the pool after a "
                        "transport failure — a desynchronized "
                        "stream poisons the next checkout; discard "
                        "it instead"),
            "returned": "!conn returned to the pool twice",
        },
        "discard": {
            "checked-out": "discarded", "suspect": "discarded",
            "returned": "discarded", "closed": "discarded",
        },
        "close": {
            "checked-out": "closed", "suspect": "closed",
            "returned": "closed", "discarded": "closed",
        },
    },
    exit_error=("conn checkout leaks on this path — every path "
                "(including exception edges) must reach exactly one "
                "of pool.put / pool.discard / close"),
    exit_on_raise=True,
)

_SEAL = Protocol(
    key="seal",
    title="seal-commit-once",
    accepting=frozenset({"fresh", "sealed", "fresh-ck", "resumed-ck",
                         "entered-ck", "written-ck"}),
    table={
        "seal": {
            "fresh": "sealed",
            "sealed": ("!pane/checkpoint key written twice on one "
                       "path — seal and proof-commit transitions "
                       "are exactly-once per instance"),
        },
        "enter": {
            "fresh-ck": "entered-ck", "resumed-ck": "entered-ck",
            "entered-ck": "entered-ck", "written-ck": "entered-ck",
        },
        "save": {
            "fresh-ck": "written-ck", "entered-ck": "written-ck",
            "written-ck": "written-ck",
            "resumed-ck": ("!checkpoint loaded from the store is "
                           "re-saved without re-entering a phase — "
                           "the blind overwrite destroys the only "
                           "record of where the resume started"),
        },
    },
)

PROTOCOLS: Dict[str, Protocol] = {p.key: p for p in
                                  (_ATOMIC, _SLAB, _CONN, _SEAL)}


# -- resource instances ------------------------------------------------------

class Resource:
    """One abstract instance of a protocol'd resource. State lives in
    the walker (snapshot/restored around branches); the instance
    itself carries only identity and immutable creation facts."""

    __slots__ = ("proto", "origin", "desc", "aliases", "escaped",
                 "param")

    def __init__(self, proto: Optional[Protocol], origin: Tuple[str, int],
                 desc: str, aliases: FrozenSet[str] = frozenset(),
                 param: str = ""):
        self.proto = proto
        self.origin = origin
        self.desc = desc
        self.aliases = aliases
        self.escaped = False
        self.param = param          # non-empty: a parameter sentinel

    @property
    def is_sentinel(self) -> bool:
        return bool(self.param)


_EMPTY: FrozenSet[Resource] = frozenset()


@dataclasses.dataclass
class FnSummary:
    params: Tuple[str, ...] = ()
    # (param, token, hop) transitions applied to a parameter, in
    # observed order — replayed onto the caller's argument instance
    param_events: Tuple[Tuple[str, str, str], ...] = ()
    param_escapes: FrozenSet[str] = frozenset()
    ret_params: FrozenSet[str] = frozenset()
    # fresh instances the callee creates and returns:
    # (proto key, exit states, chain, desc)
    ret_new: Tuple[Tuple[str, FrozenSet[str], Tuple[str, ...], str],
                   ...] = ()


_EMPTY_SUMMARY = FnSummary()


# -- the engine -------------------------------------------------------------

class Typestate:
    """Whole-program typestate pass over a ProjectInfo."""

    def __init__(self, project: ProjectInfo,
                 focus: Optional[FrozenSet[str]] = None):
        self.project = project
        self.focus = focus
        self.atomic_raw: List[RawFinding] = []
        self.slab_raw: List[RawFinding] = []
        self.conn_raw: List[RawFinding] = []
        self.seal_raw: List[RawFinding] = []
        # recognized surfaces, for the non-vacuity cross-checks
        self.creation_sites: Dict[Tuple[str, int], str] = {}
        self.transition_sites: Dict[Tuple[str, int], str] = {}
        self.marker_sites: Dict[Tuple[str, int], str] = {}
        self._summaries: Dict[str, FnSummary] = {}
        self._inflight: Set[str] = set()
        self._fn_facts: Dict[str, Tuple[Set[str], Dict[int, str]]] = {}
        self._seen: Set[Tuple[str, int, str, Tuple[str, int]]] = set()
        self._replay_mods: Dict[str, bool] = {}

    # -- the run ----------------------------------------------------------

    def run(self) -> "Typestate":
        for fid in sorted(self.project.calls.functions):
            fn = self.project.calls.functions[fid]
            mg = self.project.graphs[fn.module]
            if not _is_drynx_pkg(mg.info):
                continue
            if self.focus is not None and \
                    mg.info.relpath not in self.focus:
                continue
            self._summary(fid, 0)
        for raws in (self.atomic_raw, self.slab_raw, self.conn_raw,
                     self.seal_raw):
            raws.sort(key=lambda r: (r.file, r.line, r.message))
        return self

    def protocols_covered(self) -> Set[str]:
        return {v.split(":", 1)[0] for v in self.creation_sites.values()}

    # -- summaries --------------------------------------------------------

    def _summary(self, fid: str, depth: int) -> FnSummary:
        summ = self._summaries.get(fid)
        if summ is not None:
            return summ
        if fid in self._inflight or depth > _MAX_DEPTH:
            return _EMPTY_SUMMARY
        fn = self.project.calls.functions.get(fid)
        if fn is None:
            return _EMPTY_SUMMARY
        mg = self.project.graphs.get(fn.module)
        if mg is None or not _is_drynx_pkg(mg.info):
            return _EMPTY_SUMMARY
        self._inflight.add(fid)
        try:
            ctx = _TsCtx(self, mg, fn, depth)
            summ = ctx.walk()
        finally:
            self._inflight.discard(fid)
        self._summaries[fid] = summ
        return summ

    def module_declares_replay(self, relpath: str) -> bool:
        """Append-mode journals are legal only where a replay routine
        proves the on-disk format tolerates a torn tail."""
        got = self._replay_mods.get(relpath)
        if got is not None:
            return got
        info = self.project.modules.get(relpath)
        got = False
        if info is not None:
            for n in ast.walk(info.tree):
                if isinstance(n, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)) and \
                        "replay" in n.name.lower():
                    got = True
                    break
        self._replay_mods[relpath] = got
        return got

    # -- emission ---------------------------------------------------------

    def marked(self, relpath: str, line: int) -> Optional[str]:
        """The ``protocol[reason]`` marker governing a line: on the
        line itself or in the comment block directly above it."""
        info = self.project.modules.get(relpath)
        if info is None or not (0 < line <= len(info.lines)):
            return None
        m = _PROTOCOL_RE.search(info.lines[line - 1])
        prev = line - 1
        while m is None and prev >= 1 and \
                info.lines[prev - 1].lstrip().startswith("#"):
            m = _PROTOCOL_RE.search(info.lines[prev - 1])
            prev -= 1
        if m is None:
            return None
        self.marker_sites[(relpath, line)] = m.group(1).strip()
        return m.group(1).strip()

    def emit(self, proto: Protocol, relpath: str, line: int, msg: str,
             chain: Tuple[str, ...], origin: Tuple[str, int]) -> None:
        if self.marked(relpath, line) is not None:
            return
        if self.marked(origin[0], origin[1]) is not None:
            return
        key = (relpath, line, proto.key, origin)
        if key in self._seen:
            return
        self._seen.add(key)
        anchors: Tuple[Tuple[str, int], ...] = ((relpath, line),)
        if origin != (relpath, line):
            anchors = anchors + (origin,)
        raw = RawFinding(file=relpath, line=line, message=msg,
                         chain=chain, anchors=anchors)
        {"atomic": self.atomic_raw, "slab": self.slab_raw,
         "conn": self.conn_raw, "seal": self.seal_raw}[proto.key].append(raw)


# -- flow-sensitive function walker -----------------------------------------

class _TsCtx:
    """Executes one function body tracking resource instances through
    their protocol automata; parameters are seeded as sentinels so one
    walk yields both local findings and the interprocedural summary."""

    def __init__(self, eng: Typestate, mg: ModuleGraph, fn: FuncNode,
                 depth: int):
        self.eng = eng
        self.mg = mg
        self.fn = fn
        self.depth = depth
        self.rel = mg.info.relpath
        self.info = mg.info
        facts = eng._fn_facts.get(fn.fid)
        if facts is None:
            # slot 0 (bound-name set) is filled lazily: it is only
            # consulted for the builtin-`open` shadow check, and the
            # full binding walk is the engine's hottest cost
            facts = [None,
                     {id(s.node): s.callee
                      for s in eng.project.calls.callees(fn.fid)}]
            eng._fn_facts[fn.fid] = facts
        self._facts = facts
        self.sites = facts[1]
        self.env: Dict[str, FrozenSet[Resource]] = {}
        a = fn.node.args
        self.params: Tuple[str, ...] = tuple(
            p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs))
        for p in self.params:
            self.env[p] = frozenset(
                {Resource(None, (self.rel, fn.node.lineno),
                          f"param {p}", param=p)})
        # local name -> raw RHS node, for path-hint classification
        # (flow-insensitive on purpose: hints, not semantics)
        self.texts: Dict[str, ast.expr] = {}
        # per-path automaton state (snapshot/restored around branches)
        self.states: Dict[Resource, FrozenSet[str]] = {}
        self.chains: Dict[Resource, Tuple[str, ...]] = {}
        # commit-once sites observed on the current path: leaf -> lines
        self.once: Dict[str, FrozenSet[int]] = {}
        self.param_events: List[Tuple[str, str, str]] = []
        self.param_escapes: Set[str] = set()
        self.ret_params: Set[str] = set()
        self.ret_new: List[Tuple[str, FrozenSet[str], Tuple[str, ...],
                                 str]] = []
        # finalbodies of enclosing try statements: a return/raise runs
        # them before the frame exits, so exit checks credit them
        self.finally_stack: List[Sequence[ast.stmt]] = []

    @property
    def locals(self) -> Set[str]:
        if self._facts[0] is None:
            self._facts[0] = _local_bindings(self.fn.node)
        return self._facts[0]

    def walk(self) -> FnSummary:
        self.exec_stmts(self.fn.node.body)
        last = self.fn.node.body[-1] if self.fn.node.body \
            else self.fn.node
        self.exit_check("end", getattr(last, "lineno",
                                       self.fn.node.lineno))
        return FnSummary(params=self.params,
                         param_events=tuple(self.param_events),
                         param_escapes=frozenset(self.param_escapes),
                         ret_params=frozenset(self.ret_params),
                         ret_new=tuple(self.ret_new))

    # -- path-state plumbing -----------------------------------------------

    def _snap(self):
        return (dict(self.states), dict(self.chains), dict(self.once),
                dict(self.env))

    def _restore(self, snap) -> None:
        self.states, self.chains, self.once, self.env = (
            dict(snap[0]), dict(snap[1]), dict(snap[2]), dict(snap[3]))

    def _merge(self, *snaps) -> None:
        """Union-join path states (and env alias sets) after a branch."""
        states: Dict[Resource, FrozenSet[str]] = {}
        chains: Dict[Resource, Tuple[str, ...]] = {}
        once: Dict[str, FrozenSet[int]] = {}
        env: Dict[str, FrozenSet[Resource]] = {}
        for st, ch, on, en in snaps:
            for r, s in st.items():
                states[r] = states.get(r, frozenset()) | s
            for r, c in ch.items():
                if len(c) > len(chains.get(r, ())):
                    chains[r] = c
            for leaf, lines in on.items():
                once[leaf] = once.get(leaf, frozenset()) | lines
            for name, rs in en.items():
                env[name] = env.get(name, frozenset()) | rs
        self.states, self.chains, self.once, self.env = (states, chains,
                                                         once, env)

    def new_resource(self, proto: Protocol, line: int, desc: str,
                     start: FrozenSet[str],
                     aliases: FrozenSet[str] = frozenset(),
                     chain: Tuple[str, ...] = ()) -> Resource:
        r = Resource(proto, (self.rel, line), desc, aliases=aliases)
        self.states[r] = start
        self.chains[r] = chain or (chain_hop(self.rel, line,
                                             f"{desc} [{proto.key}]"),)
        self.eng.creation_sites.setdefault(
            (self.rel, line), f"{proto.key}:{desc}")
        return r

    def apply(self, res: Resource, token: str, line: int,
              leaf: str) -> None:
        """Drive one instance through one automaton transition."""
        if res.is_sentinel:
            if token in _SENTINEL_TOKENS:
                hop = chain_hop(self.rel, line, f"{leaf}() [{token}]")
                self.param_events.append((res.param, token, hop))
            return
        proto = res.proto
        if proto is None:
            return
        tab = proto.table.get(token)
        if tab is None:
            return
        cur = self.states.get(res)
        if cur is None:
            return
        self.eng.transition_sites.setdefault(
            (self.rel, line), f"{proto.key}:{token}")
        nxt: Set[str] = set()
        errors: List[str] = []
        for s in cur:
            if s in ("unborn", "poisoned"):
                nxt.add(s)
                continue
            to = tab.get(s, s)
            if to.startswith("!"):
                errors.append(to[1:])
            else:
                nxt.add(to)
        hop = chain_hop(self.rel, line, f"{leaf}() [{token}]")
        if errors:
            # may-error: some path state rejects the event — the dirty
            # arm of a branch join is a real crash window even when a
            # sibling arm accepts. Poison only if no live state survives
            # (surviving states carry the instance forward; the emit
            # dedup key stops repeat reports at this site).
            self.eng.emit(proto, self.rel, line, errors[0],
                          self.chains.get(res, ()) + (hop,), res.origin)
            if not (nxt - {"unborn"}):
                nxt.add("poisoned")
        self.states[res] = frozenset(nxt) if nxt else frozenset(cur)
        self.chains[res] = self.chains.get(res, ()) + (hop,)

    def _once_event(self, leaf: str, line: int) -> None:
        seen = self.once.get(leaf, frozenset())
        if any(ln != line for ln in seen):
            hop = chain_hop(self.rel, line, f"{leaf}() [commit]")
            prior = min(ln for ln in seen if ln != line)
            self.eng.emit(
                _SEAL, self.rel, line,
                f"'{leaf}' reached twice on one path (first at line "
                f"{prior}) — pane proof-commit is exactly-once per "
                f"pane", (chain_hop(self.rel, prior,
                                    f"{leaf}() [commit]"), hop),
                (self.rel, prior))
        self.once[leaf] = seen | {line}
        self.eng.transition_sites.setdefault((self.rel, line),
                                             "seal:commit")

    def _exit_via_finally(self, kind: str, line: int) -> None:
        """Exit-check after replaying pending ``finally`` bodies on a
        throwaway copy of the path state (``try: return conn.call(m)
        finally: conn.close()`` is a clean exit)."""
        if not self.finally_stack:
            self.exit_check(kind, line)
            return
        snap = self._snap()
        stack, self.finally_stack = self.finally_stack, []
        try:
            for fin in reversed(stack):
                self.exec_stmts(fin)
            self.exit_check(kind, line)
        finally:
            self.finally_stack = stack
            self._restore(snap)

    def exit_check(self, kind: str, line: int) -> None:
        """May-accept exit discipline: flag instances none of whose
        possible states is accepting (or unborn/poisoned)."""
        for res, sts in list(self.states.items()):
            if res.escaped or res.is_sentinel or res.proto is None:
                continue
            proto = res.proto
            if not proto.exit_error:
                continue
            if kind == "raise" and not proto.exit_on_raise:
                continue
            if sts & (proto.accepting | {"unborn", "poisoned"}):
                continue
            hop = chain_hop(self.rel, line,
                            f"{kind} [{'/'.join(sorted(sts))}]")
            self.eng.emit(proto, self.rel, line, proto.exit_error,
                          self.chains.get(res, ()) + (hop,), res.origin)
            self.states[res] = sts | {"poisoned"}

    def _escape(self, rs: Optional[FrozenSet[Resource]]) -> None:
        for r in rs or _EMPTY:
            if r.is_sentinel:
                self.param_escapes.add(r.param)
            else:
                r.escaped = True

    # -- statements --------------------------------------------------------

    def exec_stmts(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self.exec_stmt(stmt)

    def _hint_text(self, node: Optional[ast.expr],
                   _depth: int = 0) -> str:
        """Lowered text of an expression for hint classification, with
        names transitively expanded through the simple local string
        assignments seen so far — so ``tmp = final + ".tmp"`` carries
        the durable hint of ``final`` into ``open(tmp, "w")``.
        Expansion is lazy (assigns record the raw RHS node) and
        depth-capped against self-referential rebinds."""
        if node is None:
            return ""
        text = _unparse(node).lower()
        if _depth < 4:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    ref = self.texts.get(sub.id)
                    if ref is not None and ref is not node:
                        text += " " + self._hint_text(ref, _depth + 1)
        return text

    def exec_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            rs = self.eval_expr(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, rs, stmt.lineno)
                # record the raw RHS for hint classification; _hint_text
                # expands it lazily at the few lookup sites
                if isinstance(tgt, ast.Name) and not isinstance(
                        stmt.value, (ast.Lambda, ast.ListComp,
                                     ast.SetComp, ast.DictComp,
                                     ast.GeneratorExp)):
                    self.texts[tgt.id] = stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.eval_expr(stmt.value),
                           stmt.lineno)
        elif isinstance(stmt, ast.AugAssign):
            self.eval_expr(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self.eval_expr(stmt.value)
        elif isinstance(stmt, ast.Return):
            rs = self.eval_expr(stmt.value) if stmt.value is not None \
                else None
            for r in rs or _EMPTY:
                if r.is_sentinel:
                    self.ret_params.add(r.param)
                elif r.proto is not None:
                    r.escaped = True
                    if r.proto.key in ("conn", "seal"):
                        self.ret_new.append(
                            (r.proto.key,
                             self.states.get(r, frozenset()),
                             self.chains.get(r, ()), r.desc))
            self._exit_via_finally("return", stmt.lineno)
        elif isinstance(stmt, ast.If):
            self.eval_expr(stmt.test)
            snap = self._snap()
            self.exec_stmts(stmt.body)
            after_body = self._snap()
            self._restore(snap)
            self.exec_stmts(stmt.orelse)
            self._merge(after_body, self._snap())
        elif isinstance(stmt, (ast.For, ast.While)):
            self._exec_loop(stmt)
        elif isinstance(stmt, ast.With):
            self._exec_with(stmt)
        elif isinstance(stmt, ast.Try):
            self._exec_try(stmt)
        elif isinstance(stmt, ast.Raise):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self._escape(self.eval_expr(sub))
            self._exit_via_finally("raise", stmt.lineno)
        elif isinstance(stmt, ast.Assert):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self.eval_expr(sub)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                name = _dotted(tgt)
                if name is not None:
                    self.env.pop(name, None)
        # nested defs/classes are their own callgraph nodes; skip

    def _exec_loop(self, stmt) -> None:
        pre = self._snap()
        if isinstance(stmt, ast.For):
            self._bind(stmt.target, self.eval_expr(stmt.iter),
                       stmt.lineno)
        else:
            self.eval_expr(stmt.test)
        # two passes approximate the fixpoint (second pass sees
        # loop-carried states); join with the zero-trip path
        self.exec_stmts(stmt.body)
        self.exec_stmts(stmt.body)
        self._merge(pre, self._snap())
        self.exec_stmts(stmt.orelse)

    def _exec_with(self, stmt: ast.With) -> None:
        bound: List[FrozenSet[Resource]] = []
        for item in stmt.items:
            rs = self.eval_expr(item.context_expr)
            if item.optional_vars is not None:
                self._bind(item.optional_vars, rs, stmt.lineno)
            bound.append(rs or _EMPTY)
        self.exec_stmts(stmt.body)
        last = stmt.body[-1] if stmt.body else stmt
        for rs in reversed(bound):
            for r in rs:
                self.apply(r, "close", getattr(last, "lineno",
                                               stmt.lineno), "with-exit")

    def _exec_try(self, stmt: ast.Try) -> None:
        if stmt.finalbody:
            self.finally_stack.append(stmt.finalbody)
        pre_rids = set(self.states)
        union = self._snap()
        for sub in stmt.body:
            self.exec_stmt(sub)
            merged_from = (union, self._snap())
            keep = self._snap()
            self._merge(*merged_from)
            union = self._snap()
            self._restore(keep)
        post_body = self._snap()
        exits = []
        for h in stmt.handlers:
            self._restore(union)
            # instances created inside the body may not exist yet on
            # the handler edge: they are *unborn* there
            for r in list(self.states):
                if r not in pre_rids:
                    self.states[r] = self.states[r] | {"unborn"}
            self._mark_suspects(h)
            if h.name:
                self.env[h.name] = frozenset()
            self.exec_stmts(h.body)
            if not (h.body and isinstance(h.body[-1],
                                          (ast.Raise, ast.Continue))):
                exits.append(self._snap())
        self._restore(post_body)
        self.exec_stmts(stmt.orelse)
        exits.append(self._snap())
        self._merge(*exits)
        if stmt.finalbody:
            self.finally_stack.pop()
        self.exec_stmts(stmt.finalbody)

    def _mark_suspects(self, h: ast.ExceptHandler) -> None:
        names: Set[str] = set()
        types = h.type.elts if isinstance(h.type, ast.Tuple) else \
            ([h.type] if h.type is not None else [])
        for t in types:
            d = _dotted(t)
            if d:
                names.add(d)
                names.add(d.split(".")[-1])
        if not (names & _SUSPECT_EXC):
            return
        for r in list(self.states):
            if r.proto is _CONN and "checked-out" in self.states[r]:
                self.states[r] = (self.states[r] - {"checked-out"}) \
                    | {"suspect"}
                self.chains[r] = self.chains.get(r, ()) + (chain_hop(
                    self.rel, h.lineno,
                    f"except {'/'.join(sorted(names & _SUSPECT_EXC))} "
                    f"[suspect]"),)

    def _bind(self, tgt: ast.expr, rs: Optional[FrozenSet[Resource]],
              line: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el, rs, line)
            return
        if isinstance(tgt, ast.Starred):
            self._bind(tgt.value, rs, line)
            return
        if isinstance(tgt, (ast.Subscript, ast.Attribute)):
            # stored beyond the frame: the instance escapes the walk
            self._escape(rs)
            return
        name = _dotted(tgt)
        if name is None:
            self._escape(rs)
            return
        old = self.env.get(name, _EMPTY)
        new = rs or _EMPTY
        # rebinding over a live non-accepting instance drops the only
        # reference: an in-scope leak
        for r in old - new:
            if r.escaped or r.is_sentinel or r.proto is None or \
                    not r.proto.exit_error:
                continue
            if any(r in others for n, others in self.env.items()
                   if n != name):
                continue
            sts = self.states.get(r)
            if sts is None or sts & (r.proto.accepting
                                     | {"unborn", "poisoned"}):
                continue
            hop = chain_hop(self.rel, line, "rebind [reference lost]")
            self.eng.emit(r.proto, self.rel, line, r.proto.exit_error,
                          self.chains.get(r, ()) + (hop,), r.origin)
            self.states[r] = sts | {"poisoned"}
        if new:
            self.env[name] = new
        else:
            self.env.pop(name, None)

    # -- expressions -------------------------------------------------------

    def eval_expr(self, e: Optional[ast.expr]
                  ) -> Optional[FrozenSet[Resource]]:
        if e is None:
            return None
        if isinstance(e, ast.Name):
            return self.env.get(e.id)
        if isinstance(e, ast.Attribute):
            dotted = _dotted(e)
            if dotted is not None and dotted in self.env:
                return self.env[dotted]
            self.eval_expr(e.value)
            return None                 # projection: not the resource
        if isinstance(e, ast.Call):
            return self.visit_call(e)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            out: Set[Resource] = set()
            for el in e.elts:
                out |= self.eval_expr(el) or _EMPTY
            return frozenset(out) or None
        if isinstance(e, ast.Starred):
            return self.eval_expr(e.value)
        if isinstance(e, ast.IfExp):
            self.eval_expr(e.test)
            return frozenset((self.eval_expr(e.body) or _EMPTY)
                             | (self.eval_expr(e.orelse) or _EMPTY)) \
                or None
        if isinstance(e, ast.BoolOp):
            out = set()
            for v in e.values:
                out |= self.eval_expr(v) or _EMPTY
            return frozenset(out) or None
        if isinstance(e, ast.NamedExpr):
            rs = self.eval_expr(e.value)
            self._bind(e.target, rs, e.lineno)
            return rs
        if isinstance(e, (ast.Await, ast.YieldFrom)):
            return self.eval_expr(e.value)
        if isinstance(e, ast.Yield):
            self._escape(self.eval_expr(e.value))
            return None
        if isinstance(e, (ast.BinOp, ast.UnaryOp, ast.Compare,
                          ast.JoinedStr, ast.FormattedValue,
                          ast.Subscript, ast.Dict, ast.ListComp,
                          ast.GeneratorExp, ast.SetComp, ast.DictComp,
                          ast.Lambda)):
            for sub in ast.iter_child_nodes(e):
                if isinstance(sub, ast.expr):
                    self.eval_expr(sub)
            return None
        return None

    # -- calls -------------------------------------------------------------

    def visit_call(self, call: ast.Call
                   ) -> Optional[FrozenSet[Resource]]:
        args_r: List[Tuple[Optional[str], Optional[FrozenSet[Resource]],
                           ast.expr]] = []
        for a in call.args:
            args_r.append((None, self.eval_expr(a), a))
        for kw in call.keywords:
            args_r.append((kw.arg, self.eval_expr(kw.value), kw.value))
        recv_r: Optional[FrozenSet[Resource]] = None
        recv_name: Optional[str] = None
        if isinstance(call.func, ast.Attribute):
            recv_name = _dotted(call.func.value)
            if recv_name is not None and recv_name in self.env:
                recv_r = self.env[recv_name]
            else:
                self.eval_expr(call.func.value)
        dotted = _dotted(call.func)
        leaf = dotted.split(".")[-1] if dotted else ""
        line = call.lineno

        # handle passthrough: os.fsync(f.fileno()) addresses f
        if leaf == "fileno" and recv_r:
            return recv_r

        matched = self._match_events(call, dotted, leaf, line, args_r,
                                     recv_r, recv_name)
        created = self._match_creations(call, dotted, leaf, line,
                                        args_r, recv_name)
        if created is not None:
            return created
        if matched:
            return None

        callee_fid = self.sites.get(id(call))
        if callee_fid is not None:
            return self._call_summary(call, callee_fid, leaf, line,
                                      args_r, recv_r)

        # unresolved call: argument instances may be stored anywhere —
        # they escape (receivers of method calls do not)
        for _, rs, _node in args_r:
            self._escape(rs)
        return None

    # -- event matchers ----------------------------------------------------

    def _match_events(self, call, dotted, leaf, line, args_r, recv_r,
                      recv_name) -> bool:
        matched = False
        pos = [rs for name, rs, _ in args_r if name is None]

        # ambient journal append: journals every live claimed slab and
        # is itself an accepted-by-delegation durable write
        if leaf in _JOURNAL_LEAVES:
            for r in list(self.states):
                if r.proto is _SLAB:
                    self.apply(r, "ledger", line, leaf)
            self.eng.creation_sites.setdefault(
                (self.rel, line), "atomic:journal-append (delegated)")
            self.eng.transition_sites.setdefault((self.rel, line),
                                                 "atomic:ledger")
            return True

        if leaf in _DELEGATED_ATOMIC:
            self.eng.creation_sites.setdefault(
                (self.rel, line), "atomic:tmp-fsync-rename (delegated)")
            return True

        if leaf in _ONCE_LEAVES:
            self._once_event(leaf, line)
            return True

        # os.rename/os.replace: publishes a tmp file (atomic) —
        # claim-renames are creations, handled by the creation matcher
        if dotted in ("os.rename", "os.replace") and len(call.args) == 2:
            src = _unparse(call.args[0])
            for r in list(self.states):
                if r.proto is _ATOMIC and src and src in r.aliases:
                    self.apply(r, "rename", line, leaf)
                    matched = True

        # slab alias events: text-addressed (the claimed path is a
        # string, not a tracked object); arg texts are rendered only
        # for the leaves that can consume them — unparse dominates the
        # walk otherwise
        if leaf in ("unlink", "remove") or leaf in _SLAB_READ_LEAVES:
            arg_texts = [_unparse(node) for name, _, node in args_r]
            if leaf in ("unlink", "remove") and arg_texts:
                for r in list(self.states):
                    if r.proto is _SLAB and arg_texts[0] in r.aliases:
                        self.apply(r, "unlink", line, leaf)
                        matched = True
            if leaf in _SLAB_READ_LEAVES:
                for r in list(self.states):
                    if r.proto is _SLAB and \
                            any(t in r.aliases for t in arg_texts if t):
                        self.apply(r, "read", line, leaf)
                        matched = True

        # pool return/discard: arg-addressed, one positional argument
        if leaf == "put" and len(call.args) == 1 and not call.keywords \
                and pos and pos[0]:
            for r in pos[0]:
                if r.is_sentinel or r.proto is _CONN:
                    self.apply(r, "put", line, leaf)
                    matched = True
        if leaf == "discard" and call.args and pos and pos[0]:
            for r in pos[0]:
                if r.is_sentinel or r.proto is _CONN:
                    self.apply(r, "discard", line, leaf)
                    matched = True

        # 2-arg put: seals the key given as the first argument
        if leaf == "put" and len(call.args) == 2:
            sealed = False
            for r in (pos[0] or _EMPTY) if pos else _EMPTY:
                if r.is_sentinel or r.proto is _SEAL:
                    self.apply(r, "seal", line, leaf)
                    sealed = True
                    matched = True
            if not sealed:
                key_text = self._hint_text(call.args[0])
                if any(h in key_text for h in ("ckpt", "pane")):
                    r = self.new_resource(
                        _SEAL, line, "keyed durable write",
                        frozenset({"sealed"}))
                    r.escaped = True
                    self.eng.transition_sites.setdefault(
                        (self.rel, line), "seal:seal")
                    matched = True

        # receiver-addressed transitions
        if recv_r:
            token = {"call": "use", "close": "close", "enter": "enter",
                     "save": "save", "write": "write",
                     "writelines": "write"}.get(leaf)
            if token is not None:
                for r in recv_r:
                    self.apply(r, token, line, leaf)
                matched = True

        # handle-as-argument writes and fsync
        if leaf in _HANDLE_WRITE_LEAVES:
            for rs in pos:
                for r in rs or _EMPTY:
                    if r.is_sentinel or r.proto is _ATOMIC:
                        self.apply(r, "write", line, leaf)
                        matched = True
        if dotted == "os.fsync" and pos and pos[0]:
            for r in pos[0]:
                self.apply(r, "fsync", line, leaf)
            matched = True
        return matched

    # -- creation matchers -------------------------------------------------

    def _match_creations(self, call, dotted, leaf, line, args_r,
                         recv_name) -> Optional[FrozenSet[Resource]]:
        n_args = len(call.args) + len(call.keywords)

        # builtin open(): classify the path expression
        if isinstance(call.func, ast.Name) and call.func.id == "open" \
                and "open" not in self.locals and call.args:
            return self._open_resource(call, line)

        # pool checkout / direct conn construction
        if leaf == "get" and recv_name is not None and n_args >= 2 and \
                recv_name.split(".")[-1].lower().endswith("pool"):
            r = self.new_resource(
                _CONN, line, f"{recv_name}.get checkout",
                frozenset({"checked-out"}))
            return frozenset({r})
        if leaf == "Conn" and n_args >= 2:
            r = self.new_resource(_CONN, line, "Conn(...) construction",
                                  frozenset({"checked-out"}))
            return frozenset({r})

        # claim-rename starts a slab consumption
        if dotted in ("os.rename", "os.replace") and \
                len(call.args) == 2 and \
                "claim" in self._hint_text(call.args[1]):
            dst = call.args[1]
            aliases = {_unparse(dst)}
            if isinstance(dst, ast.Name):
                aliases.add(dst.id)
            r = self.new_resource(_SLAB, line, "claim-rename",
                                  frozenset({"claimed"}),
                                  aliases=frozenset(a for a in aliases
                                                    if a))
            return frozenset({r})

        # pane seal keys and checkpoints
        if leaf == "pane_key":
            r = self.new_resource(_SEAL, line, "pane key",
                                  frozenset({"fresh"}))
            return frozenset({r})
        if leaf == "SurveyCheckpoint" and \
                isinstance(call.func, ast.Name):
            r = self.new_resource(_SEAL, line, "fresh checkpoint",
                                  frozenset({"fresh-ck"}))
            return frozenset({r})
        if leaf == "load" and recv_name is not None and \
                recv_name.split(".")[-1] == "SurveyCheckpoint":
            r = self.new_resource(_SEAL, line, "loaded checkpoint",
                                  frozenset({"resumed-ck"}))
            return frozenset({r})

        # delegated durable stores (coverage: the store owns the idiom)
        if leaf in _DB_CTORS:
            self.eng.creation_sites.setdefault(
                (self.rel, line), "atomic:durable store (delegated)")
            return None
        return None

    def _open_resource(self, call: ast.Call,
                       line: int) -> Optional[FrozenSet[Resource]]:
        path_node = call.args[0]
        path_text = self._hint_text(path_node)
        mode = "r"
        if len(call.args) >= 2 and \
                isinstance(call.args[1], ast.Constant) and \
                isinstance(call.args[1].value, str):
            mode = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        durable = any(h in path_text for h in DURABLE_HINTS)
        tmpish = any(h in path_text for h in TMP_HINTS)
        fn_durable = any(h in self.fn.node.name.lower()
                         for h in FN_DURABLE_HINTS)
        aliases = {_unparse(path_node)}
        if isinstance(path_node, ast.Name):
            aliases.add(path_node.id)
        aliases = frozenset(a for a in aliases if a)

        if "w" in mode or "x" in mode:
            if tmpish and (durable or fn_durable):
                r = self.new_resource(_ATOMIC, line, "tmp-file open",
                                      frozenset({"open"}),
                                      aliases=aliases)
                return frozenset({r})
            if durable and not tmpish:
                r = self.new_resource(_ATOMIC, line,
                                      "in-place durable open",
                                      frozenset({"in-place"}),
                                      aliases=aliases)
                return frozenset({r})
            r = self.new_resource(_ATOMIC, line, "scratch open",
                                  frozenset({"relaxed"}),
                                  aliases=aliases)
            return frozenset({r})
        if "a" in mode:
            if durable:
                if self.eng.module_declares_replay(self.rel):
                    r = self.new_resource(
                        _ATOMIC, line, "declared-replay journal append",
                        frozenset({"journal"}), aliases=aliases)
                    return frozenset({r})
                r = self.new_resource(_ATOMIC, line,
                                      "journal append", frozenset(),
                                      aliases=aliases)
                self.states[r] = frozenset({"poisoned"})
                self.eng.emit(
                    _ATOMIC, self.rel, line,
                    "append-mode open on a durable path in a module "
                    "with no torn-tail replay routine — a crash "
                    "mid-append leaves an unreadable tail; add a "
                    "*_replay loader or write tmp → fsync → "
                    "os.replace", self.chains[r], r.origin)
                return frozenset({r})
            r = self.new_resource(_ATOMIC, line, "scratch append",
                                  frozenset({"relaxed"}),
                                  aliases=aliases)
            return frozenset({r})
        if durable:
            r = self.new_resource(_ATOMIC, line, "replay read",
                                  frozenset({"replay-read"}),
                                  aliases=aliases)
            return frozenset({r})
        return None

    # -- interprocedural ---------------------------------------------------

    def _call_summary(self, call: ast.Call, callee_fid: str, leaf: str,
                      line: int,
                      args_r, recv_r) -> Optional[FrozenSet[Resource]]:
        summ = self.eng._summary(callee_fid, self.depth + 1)
        if summ is _EMPTY_SUMMARY or (not summ.param_events
                                      and not summ.param_escapes
                                      and not summ.ret_params
                                      and not summ.ret_new):
            for _, rs, _node in args_r:
                self._escape(rs)
            return None
        is_method = (isinstance(call.func, ast.Attribute)
                     and bool(summ.params)
                     and summ.params[0] in ("self", "cls"))
        by_param: Dict[str, Optional[FrozenSet[Resource]]] = {}
        if is_method:
            by_param[summ.params[0]] = recv_r
        offset = 1 if is_method else 0
        pos = [rs for name, rs, _ in args_r if name is None]
        for i, rs in enumerate(pos):
            if offset + i < len(summ.params):
                by_param[summ.params[offset + i]] = rs
        for name, rs, _node in args_r:
            if name is not None:
                by_param[name] = rs
        call_hop = chain_hop(self.rel, line, f"{leaf}(...)")
        for param, token, hop in summ.param_events:
            for r in by_param.get(param) or _EMPTY:
                if r.is_sentinel:
                    if token in _SENTINEL_TOKENS:
                        self.param_events.append((r.param, token, hop))
                else:
                    self.chains[r] = self.chains.get(r, ()) + (call_hop,)
                    self.apply(r, token, line, leaf)
        for param in summ.param_escapes:
            self._escape(by_param.get(param))
        out: Set[Resource] = set()
        for param in summ.ret_params:
            out |= by_param.get(param) or _EMPTY
        for proto_key, sts, chain, desc in summ.ret_new:
            proto = PROTOCOLS[proto_key]
            r = self.new_resource(
                proto, line, desc,
                sts or frozenset({"poisoned"}),
                chain=chain + (chain_hop(self.rel, line,
                                         f"{leaf}() returns {desc}"),))
            out.add(r)
        return frozenset(out) or None


# -- memoized entry point ----------------------------------------------------

_TS_CACHE: Dict[str, Typestate] = {}
_TS_CACHE_MAX = 8


def typestate_for(project: ProjectInfo,
                  focus: Optional[FrozenSet[str]] = None) -> Typestate:
    """The (memoized) engine run for a project. ``focus`` narrows the
    walked module set for ``--changed-only`` (summaries for callees
    outside the focus are still computed on demand); focused runs are
    cached under a salted key like :func:`dataflow_for`."""
    fp = project_fingerprint(project)
    if focus is not None:
        fp = fp + "|" + ",".join(sorted(focus))
    eng = _TS_CACHE.get(fp)
    if eng is None:
        if len(_TS_CACHE) >= _TS_CACHE_MAX:
            _TS_CACHE.clear()
        eng = Typestate(project, focus=focus).run()
        _TS_CACHE[fp] = eng
    return eng
