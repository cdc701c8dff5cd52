"""Determinism analysis: nondeterminism taint over byte-identity sinks.

Byte-identical transcripts are the repo's load-bearing equivalence
claim — restarts, topologies, worker counts and decode modes must all
reproduce the exact bytes a VN is audited against — yet that property
was only ever checked dynamically, one seed and one configuration at a
time. This engine proves it statically: a flow-sensitive,
interprocedural taint pass over the project graphs, in the shape of
the dataflow and concurrency engines.

**Sources** seed taint at

* wall-clock reads — ``time.time``/``monotonic``/``perf_counter`` and
  ``datetime.now``/``utcnow`` *when the value flows to data* (a clock
  value compared against a deadline is control, not data, and stays
  clean);
* unseeded RNG — ``os.urandom``, ``secrets.*``, ``uuid.*``,
  module-level ``random.*``, ``random.Random()`` with no seed,
  ``np.random.*`` global state, ``default_rng()`` without a seed,
  torch's global-state draws (``torch.randint``/``rand``/``randn``/
  ``randperm``... with no ``generator=``) and a ``torch.Generator()``
  that is never seeded (``.manual_seed(x)`` makes the generator as
  deterministic as ``x``);
* identity — ``id()``, ``hash()`` of interned-unstable values under
  hash randomization, ``os.getpid()``;
* order hazards — ``os.listdir``/``glob``/``iterdir`` without
  ``sorted`` (filesystem order), ``set`` construction (iteration order
  varies under hash randomization; plain dicts are insertion-ordered
  and deterministic), and ``as_completed`` thread-completion order.

**Launders** clear taint: ``sorted(...)`` and the canonicalizers
``canon_points``/``fold_cts`` clear *order* kinds (a sorted list of
wall-clock stamps is still wall-clock); order-insensitive reductions
(``len``/``sum``/``min``/``max``/``any``/``all``) clear order kinds;
index-addressed stores (``results[i] = v`` — the roster-order
``fan_out`` gather) clear order kinds because final container state is
placement- not arrival-ordered; ``fold_in`` from a deterministic key
derives deterministic randomness (and is recorded as a launder site);
and the explicit ``# drynx: deterministic[reason]`` marker declares a
deliberate exception at the source or the sink line.

**Sinks** are the byte-identity surfaces of the real tree: transcript
serialization (``survey_transcript``/``transcript_digest``), digest
computations (``hashlib.*``), ProofDB / ``pane:`` / ``ckpt:`` writes
(2-arg ``.put``), skipchain ``chain.append``/``create_genesis``, wire
v2 frame encode (``encode_frame``/``_encode_v2``), and the fsync'd
journal lines (``_ledger_append`` — EpsilonLedger and the pool store).

Two finding kinds feed the project rules: a *value*-kind taint
(wall-clock/rng/identity) reaching a sink argument is
``nondet-flow-to-transcript``; an *order*-kind taint (listing /
set-order / thread-order) reaching a sink argument — or a sink call
lexically inside a loop whose iterate is order-tainted, where the
*write order* itself is nondeterministic — is
``unordered-iteration-at-sink``. Both carry call chains rendered as
SARIF codeFlows, with dual anchors (sink + source) so ``noqa`` works
at either end, exactly like ``secret-flow-to-sink``.

Known over-approximations (the reference's ANALYSIS.md): any tainted argument
taints an unresolvable call's result (method calls on tainted
receivers included); container mutators inside an order-tainted loop
taint the container; comparisons are control, not data. Known
under-approximations: sink-bearing callees invoked with *untainted*
arguments from inside an unordered loop are not flagged (only direct
sink calls and tainted-argument flows are), and closures over tainted
locals are invisible. Still pure ``ast``, still no torch import; the
whole run is memoized on the project content fingerprint.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import ModuleInfo, _dotted, _local_bindings
from .dataflow import RawFinding, project_fingerprint
from .graph import FuncNode, ModuleGraph
from .project import ProjectInfo, chain_hop

_MAX_DEPTH = 8

_DETERMINISTIC_RE = re.compile(r"#\s*drynx:\s*deterministic\[([^\]]+)\]")

# Taint kinds. Value kinds poison the bytes themselves; order kinds
# poison the sequence in which deterministic bytes are combined.
VALUE_KINDS = frozenset({"wall-clock", "rng", "identity"})
ORDER_KINDS = frozenset({"listing", "set-order", "thread-order"})

# -- source tables ----------------------------------------------------------

_WALLCLOCK_DOTTED = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
_RNG_DOTTED = {"os.urandom", "os.getrandom"}
_RNG_PREFIXES = ("secrets.", "uuid.")
# module-level random.* functions draw from the unseeded global
# Mersenne state; random.Random(seed) instances are handled separately
_RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "choice", "choices", "sample",
    "shuffle", "getrandbits", "randbytes", "gauss", "uniform",
    "betavariate", "expovariate", "normalvariate",
}
# torch draws that take the global generator unless given generator=
_TORCH_RNG_FNS = {"rand", "randn", "randint", "randperm", "rand_like",
                  "randn_like", "randint_like", "normal", "bernoulli",
                  "multinomial", "poisson"}
_IDENTITY_DOTTED = {"os.getpid"}
_LISTING_DOTTED = {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}
_LISTING_LEAVES = {"glob", "iglob", "iterdir", "rglob", "listdir",
                   "scandir"}
_THREAD_ORDER_LEAVES = {"as_completed"}

# -- launder tables ---------------------------------------------------------

# clear ORDER kinds, keep value kinds
_ORDER_LAUNDER_BUILTINS = {"sorted"}
_ORDER_INSENSITIVE = {"len", "sum", "min", "max", "any", "all"}
_CANON_LEAVES = {"canon_points", "fold_cts"}
# deterministic key derivation: passthrough (tainted key -> tainted
# child key), but a recognized launder construct worth recording
_FOLD_LEAVES = {"fold_in"}
_SET_CTORS = {"set", "frozenset"}

# -- sink tables ------------------------------------------------------------

_DIGEST_LEAVES = {"sha256", "sha384", "sha512", "sha1", "md5",
                  "sha3_256", "sha3_384", "sha3_512",
                  "blake2b", "blake2s"}
_TRANSCRIPT_LEAVES = {"survey_transcript", "transcript_digest"}
_JOURNAL_LEAVES = {"_ledger_append"}
_WIRE_LEAVES = {"encode_frame", "_encode_v2"}
_CHAIN_LEAVES = {"append", "create_genesis"}

# container mutators whose call order IS the container order
_ORDERED_MUTATORS = {"append", "add", "extend", "insert", "update",
                     "appendleft", "write"}


def _has_generator(call: ast.Call) -> bool:
    """True when a torch draw names its generator (``generator=None``
    takes the global one)."""
    return any(kw.arg == "generator" and not (
        isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in call.keywords)


def _is_drynx_pkg(mod: ModuleInfo) -> bool:
    return (mod.relpath.startswith("drynx_tpu_torch/")
            or "/drynx_tpu_torch/" in mod.relpath
            or "lintpkg" in mod.relpath)


@dataclasses.dataclass(frozen=True)
class Taint:
    """One nondeterministic value (or a parameter sentinel)."""
    kind: str                       # VALUE_KINDS | ORDER_KINDS |
    #                                 "set-value" | "param"
    source: str = ""                # human description of the origin
    chain: Tuple[str, ...] = ()     # chain hops, source first
    param: str = ""                 # for kind == "param"

    @property
    def is_param(self) -> bool:
        return self.kind == "param"

    @property
    def is_order(self) -> bool:
        return self.kind in ORDER_KINDS or self.kind == "set-value"

    @property
    def is_value(self) -> bool:
        return self.kind in VALUE_KINDS


def _join(*taints: Optional[Taint]) -> Optional[Taint]:
    """Combine taints of an expression: first real taint wins (value
    kinds preferred over order kinds, both over param sentinels)."""
    best: Optional[Taint] = None
    for t in taints:
        if t is None:
            continue
        if best is None:
            best = t
        elif best.is_param and not t.is_param:
            best = t
        elif (not best.is_value) and t.is_value:
            best = t
    return best


def _strip_order(t: Optional[Taint]) -> Tuple[Optional[Taint], bool]:
    """Remove order kinds; returns (remaining taint, stripped?)."""
    if t is not None and t.is_order:
        return None, True
    return t, False


@dataclasses.dataclass(frozen=True)
class ParamSink:
    """A callee parameter that flows into a sink inside the callee."""
    param: str
    label: str                   # sink label
    leaf: str                    # sink callable leaf name
    file: str                    # sink site
    line: int
    hops: Tuple[str, ...]        # hops inside the callee, call-order


@dataclasses.dataclass
class FnSummary:
    params: Tuple[str, ...] = ()
    ret: Optional[Taint] = None            # fresh taint returned
    ret_params: FrozenSet[str] = frozenset()   # params reaching return
    param_sinks: Tuple[ParamSink, ...] = ()


_EMPTY_SUMMARY = FnSummary()


# -- the engine -------------------------------------------------------------

class Determinism:
    """Whole-program nondeterminism-taint pass over a ProjectInfo."""

    def __init__(self, project: ProjectInfo,
                 focus: Optional[FrozenSet[str]] = None):
        self.project = project
        self.focus = focus          # relpaths to walk (None = all)
        self.nondet_raw: List[RawFinding] = []
        self.unordered_raw: List[RawFinding] = []
        # recognized surfaces, for the non-vacuity cross-checks
        self.sink_sites: Dict[Tuple[str, int], str] = {}
        self.launder_sites: Dict[Tuple[str, int], str] = {}
        self.source_sites: Dict[Tuple[str, int], str] = {}
        self.marker_sites: Dict[Tuple[str, int], str] = {}
        self._summaries: Dict[str, FnSummary] = {}
        self._inflight: Set[str] = set()
        # fid -> (locals, {id(call): callee fid})
        self._fn_facts: Dict[str, Tuple[Set[str], Dict[int, str]]] = {}
        self._seen: Set[Tuple[str, int, str, str]] = set()

    # -- the run ----------------------------------------------------------

    def run(self) -> "Determinism":
        for fid in sorted(self.project.calls.functions):
            fn = self.project.calls.functions[fid]
            mg = self.project.graphs[fn.module]
            if not _is_drynx_pkg(mg.info):
                continue
            if self.focus is not None and \
                    mg.info.relpath not in self.focus:
                continue
            self._summary(fid, 0)
        self.nondet_raw.sort(key=lambda r: (r.file, r.line, r.message))
        self.unordered_raw.sort(key=lambda r: (r.file, r.line, r.message))
        return self

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
            ctx = _DetCtx(self, mg, fn, depth)
            summ = ctx.walk()
        finally:
            self._inflight.discard(fid)
        self._summaries[fid] = summ
        return summ

    # -- emission ---------------------------------------------------------

    def marked(self, info: ModuleInfo, line: int) -> Optional[str]:
        """The ``deterministic[reason]`` marker text governing a line:
        on the line itself, or in the comment block directly above it
        (long call lines keep their markers readable)."""
        if not (0 < line <= len(info.lines)):
            return None
        m = _DETERMINISTIC_RE.search(info.lines[line - 1])
        prev = line - 1
        while m is None and prev >= 1 and \
                info.lines[prev - 1].lstrip().startswith("#"):
            m = _DETERMINISTIC_RE.search(info.lines[prev - 1])
            prev -= 1
        if m is None:
            return None
        self.marker_sites[(info.relpath, line)] = m.group(1).strip()
        self.launder_sites.setdefault((info.relpath, line), "marker")
        return m.group(1).strip()

    def emit(self, info: ModuleInfo, line: int, label: str, leaf: str,
             taint: Taint, ordered_write: bool = False) -> None:
        if self.marked(info, line) is not None:
            return
        src = taint.chain[0] if taint.chain else ""
        key = (info.relpath, line, taint.kind, src)
        if key in self._seen:
            return
        self._seen.add(key)
        chain = taint.chain + (chain_hop(info.relpath, line,
                                         f"{leaf}() [{label} sink]"),)
        if ordered_write:
            msg = (f"{label} sink '{leaf}' runs inside a loop over "
                   f"{taint.source} — the write order follows "
                   f"{taint.kind} order, so the bytes differ run to "
                   f"run; sort the iterate or buffer and sort")
        elif taint.is_order:
            msg = (f"unordered value ({taint.kind}: {taint.source}) "
                   f"reaches {label} sink '{leaf}' — serialize through "
                   f"sorted(...) or a canonicalizer first")
        else:
            msg = (f"nondeterministic value ({taint.kind}: "
                   f"{taint.source}) flows into {label} sink '{leaf}' "
                   f"— byte-identity surfaces must derive from survey "
                   f"inputs; launder it or mark the deliberate "
                   f"exception '# drynx: deterministic[reason]'")
        raw = RawFinding(file=info.relpath, line=line, message=msg,
                         chain=chain,
                         anchors=self._anchors(chain, info.relpath,
                                               line))
        if taint.is_order or ordered_write:
            self.unordered_raw.append(raw)
        else:
            self.nondet_raw.append(raw)

    @staticmethod
    def _anchors(chain: Tuple[str, ...], file: str,
                 line: int) -> Tuple[Tuple[str, int], ...]:
        """Dual anchors: the sink site plus the source hop
        (suppressible at either)."""
        out = [(file, line)]
        if chain:
            first = chain[0].split(":", 2)
            if len(first) == 3 and first[1].isdigit():
                out.append((first[0], int(first[1])))
        return tuple(out)


# -- flow-sensitive function walker -----------------------------------------

class _DetCtx:
    """Executes one function body with a taint environment, recording
    sink flows; parameters are seeded as sentinels so one walk yields
    both the local findings and the interprocedural summary."""

    def __init__(self, eng: Determinism, mg: ModuleGraph, fn: FuncNode,
                 depth: int):
        self.eng = eng
        self.mg = mg
        self.fn = fn
        self.depth = depth
        self.rel = mg.info.relpath
        self.info = mg.info
        facts = eng._fn_facts.get(fn.fid)
        if facts is None:
            facts = (_local_bindings(fn.node),
                     {id(s.node): s.callee
                      for s in eng.project.calls.callees(fn.fid)})
            eng._fn_facts[fn.fid] = facts
        self.locals, self.sites = facts
        self.env: Dict[str, Taint] = {}
        self.order_stack: List[Taint] = []
        a = fn.node.args
        self.params: Tuple[str, ...] = tuple(
            p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs))
        for p in self.params:
            self.env[p] = Taint("param", source=f"param {p}", param=p)
        self.ret: Optional[Taint] = None
        self.ret_params: Set[str] = set()
        self.param_sinks: List[ParamSink] = []

    def walk(self) -> FnSummary:
        self.exec_stmts(self.fn.node.body)
        return FnSummary(params=self.params, ret=self.ret,
                         ret_params=frozenset(self.ret_params),
                         param_sinks=tuple(self.param_sinks))

    # -- statements --------------------------------------------------------

    def exec_stmts(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self.exec_stmt(stmt)

    def exec_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.eval_expr(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, t)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.eval_expr(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            t = self.eval_expr(stmt.value)
            name = _dotted(stmt.target)
            if name is not None:
                self.env[name] = _join(self.env.get(name), t) or \
                    self.env.get(name) or t
                if self.env[name] is None:
                    self.env.pop(name, None)
        elif isinstance(stmt, ast.Expr):
            self.eval_expr(stmt.value)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                t = self.eval_expr(stmt.value)
                if t is not None:
                    if t.is_param:
                        self.ret_params.add(t.param)
                    else:
                        self.ret = _join(self.ret, t)
        elif isinstance(stmt, (ast.If, ast.While)):
            self.eval_expr(stmt.test)
            self.exec_stmts(stmt.body)
            self.exec_stmts(stmt.orelse)
        elif isinstance(stmt, ast.For):
            self._exec_for(stmt)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                t = self.eval_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, t)
            self.exec_stmts(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.exec_stmts(stmt.body)
            for h in stmt.handlers:
                self.exec_stmts(h.body)
            self.exec_stmts(stmt.orelse)
            self.exec_stmts(stmt.finalbody)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self.eval_expr(sub)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                name = _dotted(tgt)
                if name is not None:
                    self.env.pop(name, None)
        # nested defs/classes are their own callgraph nodes; skip

    def _exec_for(self, stmt: ast.For) -> None:
        t = self.eval_expr(stmt.iter)
        loop_taint: Optional[Taint] = None
        if t is not None and t.kind == "set-value":
            hop = chain_hop(self.rel, stmt.iter.lineno,
                            "iterate set")
            loop_taint = Taint("set-order", source=t.source or "a set",
                              chain=t.chain + (hop,))
        elif t is not None and t.is_order:
            loop_taint = t
        if loop_taint is not None:
            self._bind(stmt.target, loop_taint)
            self.order_stack.append(loop_taint)
            try:
                self.exec_stmts(stmt.body)
            finally:
                self.order_stack.pop()
        else:
            # value/param taints: the element values carry the taint
            self._bind(stmt.target, t)
            self.exec_stmts(stmt.body)
        self.exec_stmts(stmt.orelse)

    def _bind(self, tgt: ast.expr, t: Optional[Taint]) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el, t)
            return
        if isinstance(tgt, ast.Starred):
            self._bind(tgt.value, t)
            return
        if isinstance(tgt, ast.Subscript):
            # index-addressed store: final container state is
            # placement-ordered, not arrival-ordered — this is the
            # roster-order fan_out gather launder
            t, stripped = _strip_order(t)
            if stripped:
                self.eng.launder_sites[(self.rel, tgt.lineno)] = \
                    "indexed-store"
            name = _dotted(tgt.value)
            if name is not None and t is not None:
                self.env[name] = _join(self.env.get(name), t)
            return
        name = _dotted(tgt)
        if name is None:
            return
        if t is None:
            self.env.pop(name, None)
        else:
            self.env[name] = t

    # -- expressions -------------------------------------------------------

    def eval_expr(self, e: Optional[ast.expr]) -> Optional[Taint]:
        if e is None:
            return None
        if isinstance(e, ast.Name):
            return self.env.get(e.id)
        if isinstance(e, ast.Attribute):
            dotted = _dotted(e)
            if dotted is not None and dotted in self.env:
                return self.env[dotted]
            return self.eval_expr(e.value)
        if isinstance(e, ast.Call):
            return self.visit_call(e)
        if isinstance(e, ast.BinOp):
            return _join(self.eval_expr(e.left), self.eval_expr(e.right))
        if isinstance(e, ast.BoolOp):
            return _join(*[self.eval_expr(v) for v in e.values])
        if isinstance(e, ast.UnaryOp):
            return self.eval_expr(e.operand)
        if isinstance(e, ast.Compare):
            # comparisons yield control booleans, not data bytes
            self.eval_expr(e.left)
            for c in e.comparators:
                self.eval_expr(c)
            return None
        if isinstance(e, ast.IfExp):
            self.eval_expr(e.test)
            return _join(self.eval_expr(e.body),
                         self.eval_expr(e.orelse))
        if isinstance(e, ast.JoinedStr):
            return _join(*[self.eval_expr(v) for v in e.values])
        if isinstance(e, ast.FormattedValue):
            return self.eval_expr(e.value)
        if isinstance(e, ast.Subscript):
            return _join(self.eval_expr(e.value),
                         self.eval_expr(e.slice))
        if isinstance(e, ast.Starred):
            return self.eval_expr(e.value)
        if isinstance(e, (ast.List, ast.Tuple)):
            return _join(*[self.eval_expr(el) for el in e.elts])
        if isinstance(e, ast.Set):
            inner = _join(*[self.eval_expr(el) for el in e.elts])
            return self._as_set(inner, e.lineno, "a set literal")
        if isinstance(e, ast.Dict):
            return _join(*[self.eval_expr(v) for v in e.values
                           if v is not None],
                         *[self.eval_expr(k) for k in e.keys
                           if k is not None])
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                          ast.DictComp)):
            return self._eval_comp(e)
        if isinstance(e, (ast.Await, ast.YieldFrom)):
            return self.eval_expr(e.value)
        if isinstance(e, ast.NamedExpr):
            t = self.eval_expr(e.value)
            self._bind(e.target, t)
            return t
        return None

    def _as_set(self, inner: Optional[Taint], lineno: int,
                what: str) -> Taint:
        if inner is not None and inner.is_value:
            return inner                      # value taint dominates
        chain = (inner.chain if inner is not None else
                 (chain_hop(self.rel, lineno, what),))
        return Taint("set-value", source=what, chain=chain)

    def _eval_comp(self, e: ast.expr) -> Optional[Taint]:
        order: Optional[Taint] = None
        elt_env: List[Optional[Taint]] = []
        for gen in e.generators:
            t = self.eval_expr(gen.iter)
            if t is not None and (t.is_order or t.kind == "set-value"):
                order = _join(order, t)
                self._bind(gen.target, t)
            else:
                self._bind(gen.target, t)
        if isinstance(e, ast.DictComp):
            elt_env.append(self.eval_expr(e.key))
            elt_env.append(self.eval_expr(e.value))
        else:
            elt_env.append(self.eval_expr(e.elt))
        inner = _join(*elt_env)
        if isinstance(e, ast.SetComp):
            return self._as_set(_join(inner, order), e.lineno,
                                "a set comprehension")
        if isinstance(e, ast.DictComp):
            return inner                      # dicts insertion-ordered
        return _join(inner, order)

    # -- calls -------------------------------------------------------------

    def visit_call(self, call: ast.Call) -> Optional[Taint]:
        args_t: List[Tuple[Optional[str], Optional[Taint]]] = []
        for a in call.args:
            args_t.append((None, self.eval_expr(a)))
        for kw in call.keywords:
            args_t.append((kw.arg, self.eval_expr(kw.value)))
        recv_t: Optional[Taint] = None
        if isinstance(call.func, ast.Attribute):
            recv_t = self.eval_expr(call.func.value)
        dotted = _dotted(call.func)
        leaf = dotted.split(".")[-1] if dotted else ""

        label = self._sink_label(call, dotted, leaf)
        if label is not None:
            self._check_sink(call, label, leaf, args_t)

        t = self._source_taint(call, dotted, leaf, args_t)
        if t is not None:
            return t

        if leaf == "manual_seed" and isinstance(call.func, ast.Attribute):
            # g.manual_seed(x): the generator (and the call's value, the
            # generator itself) is as deterministic as the seed
            t = _join(*[t for _, t in args_t])
            name = _dotted(call.func.value)
            if name is not None and t is None:
                self.env.pop(name, None)
            elif name is not None and name in self.env:
                self.env[name] = t
            self.eng.launder_sites[(self.rel, call.lineno)] = "manual_seed"
            return t

        t = self._launder(call, dotted, leaf, args_t)
        if t is not NotImplemented:
            return t

        callee_fid = self.sites.get(id(call))
        if callee_fid is not None:
            return self._call_summary(call, callee_fid, leaf, args_t,
                                      recv_t)

        joined = _join(*[t for _, t in args_t], recv_t)
        if joined is not None and isinstance(call.func, ast.Attribute) \
                and leaf in _ORDERED_MUTATORS and joined.is_order:
            # building a container in nondeterministic call order
            name = _dotted(call.func.value)
            if name is not None:
                self.env[name] = _join(self.env.get(name), joined)
        if self.order_stack and isinstance(call.func, ast.Attribute) \
                and leaf in _ORDERED_MUTATORS:
            name = _dotted(call.func.value)
            if name is not None:
                self.env[name] = _join(self.env.get(name),
                                       self.order_stack[-1])
        return joined

    # -- sinks -------------------------------------------------------------

    def _sink_label(self, call: ast.Call, dotted: Optional[str],
                    leaf: str) -> Optional[str]:
        if dotted and (dotted.startswith("hashlib.")
                       or leaf in _DIGEST_LEAVES):
            return "digest"
        if leaf in _TRANSCRIPT_LEAVES:
            return "transcript"
        if leaf in _JOURNAL_LEAVES:
            return "journal"
        if leaf in _WIRE_LEAVES:
            return "wire-encode"
        if isinstance(call.func, ast.Attribute):
            if leaf == "put" and len(call.args) == 2:
                return "db-write"
            if leaf in _CHAIN_LEAVES:
                recv = _dotted(call.func.value)
                if recv is not None and \
                        recv.split(".")[-1] == "chain":
                    return "skipchain"
        return None

    def _check_sink(self, call: ast.Call, label: str, leaf: str,
                    args_t: Sequence[Tuple[Optional[str],
                                           Optional[Taint]]]) -> None:
        self.eng.sink_sites[(self.rel, call.lineno)] = label
        for _, t in args_t:
            if t is None:
                continue
            if t.is_param:
                hop = chain_hop(self.rel, call.lineno,
                                f"{leaf}() [{label} sink]")
                self.param_sinks.append(ParamSink(
                    param=t.param, label=label, leaf=leaf,
                    file=self.rel, line=call.lineno,
                    hops=t.chain + (hop,)))
            elif t.is_value or t.is_order:
                self.eng.emit(self.info, call.lineno, label, leaf, t)
        if self.order_stack:
            self.eng.emit(self.info, call.lineno, label, leaf,
                          self.order_stack[-1], ordered_write=True)

    # -- sources -----------------------------------------------------------

    def _source_taint(self, call: ast.Call, dotted: Optional[str],
                      leaf: str,
                      args_t: Sequence[Tuple[Optional[str],
                                             Optional[Taint]]]
                      ) -> Optional[Taint]:
        kind: Optional[str] = None
        desc = f"{dotted or leaf}()"
        if dotted in _WALLCLOCK_DOTTED:
            kind = "wall-clock"
        elif dotted in _RNG_DOTTED or \
                (dotted and dotted.startswith(_RNG_PREFIXES)):
            kind = "rng"
        elif dotted and dotted.startswith(("random.", "np.random.",
                                           "numpy.random.")):
            if leaf == "Random" or leaf == "default_rng":
                if not call.args and not call.keywords:
                    kind = "rng"
                    desc = f"unseeded {dotted}()"
                # seeded instances stay clean (arg taint propagates
                # via the default join below if the seed is tainted)
            elif leaf == "SystemRandom":
                kind = "rng"
            elif leaf in _RANDOM_MODULE_FNS:
                kind = "rng"
                desc = f"global-state {dotted}()"
        elif dotted and dotted.startswith("torch.") \
                and leaf in _TORCH_RNG_FNS and not _has_generator(call):
            kind = "rng"
            desc = f"global-state {dotted}()"
        elif dotted in ("torch.Generator", "torch.random.Generator"):
            kind = "rng"
            desc = f"unseeded {dotted}()"
        elif dotted in _IDENTITY_DOTTED:
            kind = "identity"
        elif isinstance(call.func, ast.Name) and \
                call.func.id in ("id", "hash") and \
                call.func.id not in self.locals:
            kind = "identity"
            desc = (f"{call.func.id}() under "
                    f"{'hash randomization' if call.func.id == 'hash' else 'address reuse'}")
        elif dotted in _LISTING_DOTTED or leaf in _LISTING_LEAVES:
            kind = "listing"
            desc = f"unsorted {dotted or leaf}()"
        elif leaf in _THREAD_ORDER_LEAVES:
            kind = "thread-order"
            desc = "as_completed() thread-completion order"
        elif leaf in _SET_CTORS and isinstance(call.func, ast.Name) \
                and leaf not in self.locals:
            inner = _join(*[t for _, t in args_t])
            inner, stripped = _strip_order(inner)
            if stripped:
                self.eng.launder_sites[(self.rel, call.lineno)] = \
                    "set-membership"
            if inner is not None and inner.is_value:
                return inner
            return self._as_set(inner, call.lineno,
                                f"{leaf}(...) construction")
        if kind is None:
            return None
        if self.eng.marked(self.info, call.lineno) is not None:
            return None
        self.eng.source_sites[(self.rel, call.lineno)] = kind
        hop = chain_hop(self.rel, call.lineno, f"{desc} [{kind}]")
        return Taint(kind, source=desc, chain=(hop,))

    # -- launders ----------------------------------------------------------

    def _launder(self, call: ast.Call, dotted: Optional[str], leaf: str,
                 args_t: Sequence[Tuple[Optional[str],
                                        Optional[Taint]]]):
        """Returns a taint (or None) when the call is a recognized
        launder; NotImplemented otherwise."""
        joined = _join(*[t for _, t in args_t])
        if leaf in _ORDER_LAUNDER_BUILTINS and \
                isinstance(call.func, ast.Name):
            self.eng.launder_sites[(self.rel, call.lineno)] = "sorted"
            t, _ = _strip_order(joined)
            return t
        if leaf in _CANON_LEAVES:
            self.eng.launder_sites[(self.rel, call.lineno)] = \
                "canonicalize"
            t, _ = _strip_order(joined)
            return t
        if leaf in _FOLD_LEAVES:
            self.eng.launder_sites[(self.rel, call.lineno)] = "fold_in"
            return joined            # deterministic derivation: the
            #                          result is tainted iff the key is
        if leaf in _ORDER_INSENSITIVE and \
                isinstance(call.func, ast.Name) and \
                leaf not in self.locals:
            t, stripped = _strip_order(joined)
            if stripped:
                self.eng.launder_sites[(self.rel, call.lineno)] = \
                    "order-insensitive"
            return t
        return NotImplemented

    # -- interprocedural ---------------------------------------------------

    def _call_summary(self, call: ast.Call, callee_fid: str, leaf: str,
                      args_t: Sequence[Tuple[Optional[str],
                                             Optional[Taint]]],
                      recv_t: Optional[Taint]) -> Optional[Taint]:
        summ = self.eng._summary(callee_fid, self.depth + 1)
        if not summ.params and summ.ret is None:
            return _join(*[t for _, t in args_t], recv_t)
        # map caller arguments onto callee parameter names
        is_method = (isinstance(call.func, ast.Attribute)
                     and bool(summ.params)
                     and summ.params[0] in ("self", "cls"))
        by_param: Dict[str, Optional[Taint]] = {}
        if is_method:
            by_param[summ.params[0]] = recv_t
        offset = 1 if is_method else 0
        pos = [t for name, t in args_t if name is None]
        for i, t in enumerate(pos):
            if offset + i < len(summ.params):
                by_param[summ.params[offset + i]] = t
        for name, t in args_t:
            if name is not None:
                by_param[name] = t
        # parameter -> sink flows inside the callee
        for ps in summ.param_sinks:
            t = by_param.get(ps.param)
            if t is None or t.is_param:
                if t is not None and t.is_param:
                    # forwardings: extend our own summary
                    self.param_sinks.append(ParamSink(
                        param=t.param, label=ps.label, leaf=ps.leaf,
                        file=ps.file, line=ps.line,
                        hops=(chain_hop(self.rel, call.lineno,
                                        f"{leaf}(...)"),) + ps.hops))
                continue
            if not (t.is_value or t.is_order):
                continue
            info = self.eng.project.modules.get(ps.file)
            if info is None:
                continue
            carried = Taint(t.kind, source=t.source,
                            chain=t.chain + (chain_hop(
                                self.rel, call.lineno,
                                f"{leaf}(...)"),) + ps.hops[:-1])
            self.eng.emit(info, ps.line, ps.label, ps.leaf, carried)
        # result taint: fresh taint returned by the callee, plus any
        # passthrough parameter whose argument is tainted
        out = summ.ret
        if out is not None:
            out = Taint(out.kind, source=out.source,
                        chain=out.chain + (chain_hop(
                            self.rel, call.lineno,
                            f"{leaf}() returns {out.kind}"),),
                        param=out.param)
        for p in summ.ret_params:
            out = _join(out, by_param.get(p))
        if callee_fid.split(".")[-1] == "__init__":
            # constructed object carries its argument taints
            out = _join(out, *[t for _, t in args_t])
        return out


# -- memoized entry point ----------------------------------------------------

_DET_CACHE: Dict[str, Determinism] = {}
_DET_CACHE_MAX = 8


def determinism_for(project: ProjectInfo,
                    focus: Optional[FrozenSet[str]] = None
                    ) -> Determinism:
    """The (memoized) engine run for a project. ``focus`` narrows the
    walked module set for ``--changed-only`` (summaries for callees
    outside the focus are still computed on demand); focused runs are
    cached under a salted key like :func:`dataflow_for`."""
    fp = project_fingerprint(project)
    if focus is not None:
        fp = fp + "|" + ",".join(sorted(focus))
    eng = _DET_CACHE.get(fp)
    if eng is None:
        if len(_DET_CACHE) >= _DET_CACHE_MAX:
            _DET_CACHE.clear()
        eng = Determinism(project, focus=focus).run()
        _DET_CACHE[fp] = eng
    return eng
