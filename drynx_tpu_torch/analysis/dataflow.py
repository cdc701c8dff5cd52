"""Value-level dataflow: an AST abstract interpreter over two lattices.

The callgraph rules track *launch operands* (the ``cuda-launch-operand``
prover walks definitions backwards to a ``check_operands`` or a pinned
constructor).
This module tracks **values** forward, per binding, on two small lattices:

* **dtype** — ``int32 | uint32 | other | unknown``, threaded through
  pytree packing/unpacking, tuple/dict construction, dataclass fields and
  the ``stack/cat/reshape/where`` dtype-preserving chains. The two limb
  points are the kernels' ``torch.int32`` limbs and the ``uint32`` layout
  the packages keep at their module boundaries (numpy, the wire). The
  interesting event is **laundering**: a value that was provably a limb
  tensor losing the dtype (``.float()``, ``.to(torch.float32)``,
  ``astype(float32)``, float-constant arithmetic, true division) and then
  reaching a ``cuda_build.launch``, a kernel wrapper or a serialization
  point — the exact class of bug that corrupts Montgomery carries
  silently.

* **secrecy** — ``secret | public``, seeded at *definition sites* (ElGamal
  ``keygen()``, ``secrets.randbelow()`` nonce draws, DP cleartext loads)
  rather than by identifier regex, and reported when a secret value
  reaches ``print``/``log.*``/TOML output/exception messages/``send``.

Functions get interprocedural :class:`Summary` objects (param -> return
lattice transfer plus "param reaches sink" records) computed lazily along
the callgraph and memoized; the whole engine result is cached on a
content-hash fingerprint of the project (:func:`dataflow_for`), so the two
consuming rules share one run and re-runs in one process are free.

Suppression composes with the usual anchors: every chain hop of a finding
is an anchor, so ``# drynx: noqa[rule]`` works at the source *or* the
sink. Additionally ``# drynx: declassify[secret]`` (or ``[dtype]``) on an
assignment line forces the assigned value public / un-laundered — the
documented way to mark protocol outputs (Schnorr ``s``, ciphertexts) that
are public by construction.

Still pure ``ast``, still no torch import.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple, Union

from .core import _dotted, is_launch_call
from .graph import FuncNode
from .project import ProjectInfo, chain_hop

# -- lattices ---------------------------------------------------------------

DT_UINT32 = "uint32"
DT_INT32 = "int32"
LIMB_DTYPES = (DT_INT32, DT_UINT32)
DT_OTHER = "other"
DT_UNKNOWN = "unknown"

SEC_PUBLIC = "public"
SEC_SECRET = "secret"

_MAX_CHAIN = 8

_DECLASSIFY_RE = re.compile(r"#\s*drynx:\s*declassify\[([a-z,\s]+)\]")

# Sink tables (deliberately local copies: rules.py imports this module).
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log", "lvl", "lvl1", "lvl2", "lvl3"}
_LOGGER_NAMES = {"log", "logging", "logger", "_logger", "LOG", "LOGGER"}
_SEND_LEAVES = {"send_msg", "send", "sendall", "sendto", "broadcast"}
_DUMP_LEAVES = {"dump", "dumps"}

# Secrecy seeds: callee leaf name -> what the value is.
_NONCE_LEAVES = {"randbelow"}
_CLEARTEXT_LEAVES = {"load_csv", "loadtxt", "genfromtxt"}

# Container mutation methods: ``xs.append(secret)`` taints the binding of
# ``xs`` itself (container-sensitive secrecy — the dual of the existing
# ``d[k] = v`` subscript-assign rule), so a later ``log.info(xs)`` still
# sees the taint even though no assignment statement touched ``xs``.
_MUTATOR_LEAVES = {"append", "appendleft", "add", "insert", "extend",
                   "update", "setdefault"}

# Introspection builtins whose result is public whatever goes in (a
# length/type/id does not reveal the value), and digest methods — hashing
# IS the redaction the secret-flow findings ask for, so it declassifies.
_PUBLIC_FUNCS = {"len", "bool", "type", "id", "isinstance", "issubclass",
                 "hash", "callable"}
_DIGEST_LEAVES = {"hexdigest", "digest"}

# the JAX spellings stay: the reference's fixture package (whose goldens
# the port's engine reproduces) is written against jnp
_UINT32_DTYPES = {"jnp.uint32", "np.uint32", "numpy.uint32",
                  "jax.numpy.uint32", "torch.uint32"}
_INT32_DTYPES = {"torch.int32", "torch.int"}
# torch dtypes whose values are no longer exact limbs
_FLOAT_DTYPES = {"float", "torch.float", "torch.float16", "torch.float32",
                 "torch.float64", "torch.half", "torch.double",
                 "torch.bfloat16", "np.float32", "np.float64",
                 "numpy.float32", "numpy.float64"}
_ARRAY_ROOTS = {"jnp", "np", "numpy", "jax", "torch"}
# positional index at which dtype may appear (numpy/jnp; torch takes
# dtype only as a keyword)
_CTOR_DTYPE_POS = {"array": 1, "asarray": 1, "zeros": 1, "ones": 1,
                   "empty": 1, "full": 2, "arange": 3}
_TORCH_CTORS = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
                "arange", "zeros_like", "ones_like", "empty_like",
                "full_like"}
_FRESH_CTORS = {"zeros", "ones", "empty", "full", "arange"}
_PRESERVING_FUNCS = {"transpose", "reshape", "concatenate", "stack",
                     "broadcast_to", "tile", "repeat", "flip", "roll",
                     "moveaxis", "swapaxes", "expand_dims", "squeeze",
                     "ravel", "pad", "zeros_like", "ones_like",
                     "empty_like", "full_like", "flipud", "rot90",
                     "cat", "flatten", "permute", "unsqueeze"}
_PRESERVING_METHODS = {"reshape", "transpose", "ravel", "squeeze",
                       "swapaxes", "copy", "flatten", "block_until_ready"}
# torch tensor methods that keep the dtype whatever their arguments
_TORCH_PRESERVING_METHODS = {"contiguous", "clone", "detach", "cpu", "cuda",
                             "numpy", "permute", "unsqueeze", "expand",
                             "narrow", "repeat", "roll", "flip",
                             "index_select"}
# torch tensor methods that cast to a float dtype
_TORCH_FLOAT_METHODS = {"float", "double", "half", "bfloat16"}
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size"}


class Secret:
    """Annotation-only marker: ``sk: Secret[int]`` (or the string form
    ``"Secret[int]"``) seeds the secrecy lattice at the annotation site —
    the way to declare a secret that the definition-site seeds (keygen /
    randbelow / cleartext loads) cannot see, e.g. a key passed in from a
    caller outside the analyzed tree. Erased at runtime: subscripting
    returns the class itself, so the annotation costs nothing."""

    def __class_getitem__(cls, _item):
        return cls


def _is_secret_ann(ann: Optional[ast.AST]) -> bool:
    """True for ``Secret[...]`` / ``x.Secret[...]`` / bare ``Secret`` and
    their string-literal forms."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        head = ann.value.split("[", 1)[0]
        return head.split(".")[-1].strip() == "Secret"
    node = ann.value if isinstance(ann, ast.Subscript) else ann
    return (_dotted(node) or "").split(".")[-1] == "Secret"


def _is_uint32_dtype(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and expr.value == "uint32":
        return True
    return _dotted(expr) in _UINT32_DTYPES


def _limb_dtype(expr: ast.AST) -> Optional[str]:
    """The limb lattice point a dtype expression names, else None."""
    if _is_uint32_dtype(expr):
        return DT_UINT32
    if _dotted(expr) in _INT32_DTYPES:
        return DT_INT32
    return None


def _is_dtype_expr(expr: ast.AST) -> bool:
    """A dtype (not a device) in a ``.to(...)`` argument."""
    d = _dotted(expr) or ""
    return (_limb_dtype(expr) is not None or d in _FLOAT_DTYPES
            or (d.startswith("torch.") and d.split(".")[-1].startswith(
                ("int", "uint", "float", "bool", "complex", "half",
                 "double", "long", "short", "bfloat"))))


def _dtype_scope(relpath: str) -> bool:
    """ciphertext-dtype-launder fires in crypto/parallel (+ the fixture)."""
    marked = f"/{relpath}"
    return ("/crypto/" in marked or "/parallel/" in marked
            or "lintpkg" in relpath)


def _secret_scope(relpath: str) -> bool:
    """secret-flow-to-sink fires package-wide (+ the fixture)."""
    return (relpath.startswith("drynx_tpu_torch/")
            or "/drynx_tpu_torch/" in relpath
            or "lintpkg" in relpath)


def _cap(chain: Tuple[str, ...]) -> Tuple[str, ...]:
    return chain if len(chain) <= _MAX_CHAIN else chain[:_MAX_CHAIN]


# -- abstract values --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AV:
    """One lattice point. ``*_src`` fields are *symbolic*: they name the
    parameter indices of the function being summarized whose concrete
    values (at a call site) decide the concrete lattice point — this is
    what makes summaries transfer functions instead of constants."""
    dtype: str = DT_UNKNOWN
    secrecy: str = SEC_PUBLIC
    laundered: bool = False
    dtype_src: Optional[int] = None
    secret_src: FrozenSet[int] = frozenset()
    launders_src: FrozenSet[int] = frozenset()
    dtype_chain: Tuple[str, ...] = ()
    secret_chain: Tuple[str, ...] = ()


TOP = AV()


@dataclasses.dataclass
class TupleVal:
    elts: Tuple["ValT", ...]


@dataclasses.dataclass
class ObjVal:
    cls: Tuple[str, str]                # (module dotted, ClassName)
    fields: Dict[str, "ValT"]


ValT = Union[AV, TupleVal, ObjVal]


def join_av(a: AV, b: AV) -> AV:
    if a is b:
        return a
    if a.laundered and a.dtype_chain:
        dchain = a.dtype_chain
    elif b.laundered and b.dtype_chain:
        dchain = b.dtype_chain
    else:
        dchain = a.dtype_chain or b.dtype_chain
    if a.secrecy == SEC_SECRET and a.secret_chain:
        schain = a.secret_chain
    elif b.secrecy == SEC_SECRET and b.secret_chain:
        schain = b.secret_chain
    else:
        schain = a.secret_chain or b.secret_chain
    return AV(
        dtype=a.dtype if a.dtype == b.dtype else DT_UNKNOWN,
        secrecy=(SEC_SECRET if SEC_SECRET in (a.secrecy, b.secrecy)
                 else SEC_PUBLIC),
        laundered=a.laundered or b.laundered,
        dtype_src=a.dtype_src if a.dtype_src == b.dtype_src else None,
        secret_src=a.secret_src | b.secret_src,
        launders_src=a.launders_src | b.launders_src,
        dtype_chain=dchain, secret_chain=schain)


def collapse(v: ValT) -> AV:
    """Join all leaves of a structured value into one AV."""
    if isinstance(v, AV):
        return v
    if isinstance(v, TupleVal):
        if not v.elts:
            return TOP
        out = collapse(v.elts[0])
        for e in v.elts[1:]:
            out = join_av(out, collapse(e))
        return out
    vals = list(v.fields.values())
    if not vals:
        return TOP
    out = collapse(vals[0])
    for e in vals[1:]:
        out = join_av(out, collapse(e))
    return out


def shallow(v: ValT) -> AV:
    """Like collapse, but an object's fields do NOT taint the object —
    used for unknown-call passthrough so a NodeIdentity flowing through
    helper calls doesn't turn everything it touches secret."""
    if isinstance(v, AV):
        return v
    if isinstance(v, TupleVal):
        out = TOP
        for e in v.elts:
            out = join_av(out, shallow(e))
        return out
    return TOP


def join_val(a: ValT, b: ValT) -> ValT:
    if isinstance(a, TupleVal) and isinstance(b, TupleVal) \
            and len(a.elts) == len(b.elts):
        return TupleVal(tuple(join_val(x, y)
                              for x, y in zip(a.elts, b.elts)))
    if isinstance(a, ObjVal) and isinstance(b, ObjVal) and a.cls == b.cls:
        merged: Dict[str, ValT] = dict(a.fields)
        for k, v in b.fields.items():
            merged[k] = join_val(merged[k], v) if k in merged else v
        return ObjVal(a.cls, merged)
    return join_av(collapse(a), collapse(b))


def _value_json(v: ValT) -> Dict[str, object]:
    """Stable JSON for the golden-summary tests."""
    if isinstance(v, TupleVal):
        return {"tuple": [_value_json(e) for e in v.elts]}
    if isinstance(v, ObjVal):
        return {"object": f"{v.cls[0]}:{v.cls[1]}",
                "fields": {k: _value_json(x)
                           for k, x in sorted(v.fields.items())}}
    return {"dtype": v.dtype, "secrecy": v.secrecy,
            "laundered": v.laundered, "dtype_src": v.dtype_src,
            "secret_src": sorted(v.secret_src),
            "launders_src": sorted(v.launders_src)}


# -- summaries --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSink:
    """"Parameter ``param`` reaches a sink inside this function": fired at
    call sites that pass a concretely-secret (kind=secret), concretely
    laundered (dtype-pass) or concretely-uint32 (dtype-launder) value."""
    param: int
    kind: str                     # "secret" | "dtype-pass" | "dtype-launder"
    chain: Tuple[str, ...]        # hops from inside the callee to the sink
    message: str


@dataclasses.dataclass
class Summary:
    fid: str
    params: Tuple[str, ...]
    ret: ValT
    sinks: Tuple[ParamSink, ...]

    def to_json(self) -> Dict[str, object]:
        return {"params": list(self.params), "ret": _value_json(self.ret),
                "sinks": [{"param": s.param, "kind": s.kind,
                           "message": s.message} for s in self.sinks]}


_EMPTY = Summary("", (), TOP, ())


@dataclasses.dataclass(frozen=True)
class RawFinding:
    file: str
    line: int
    message: str
    chain: Tuple[str, ...]
    anchors: Tuple[Tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    module: str
    name: str
    fields: Tuple[str, ...]       # ordered AnnAssign names (dataclass ctor)
    is_dataclass: bool


# -- the engine -------------------------------------------------------------

class Dataflow:
    """Whole-program value dataflow over a :class:`ProjectInfo`.

    Two passes: pass 1 populates per-class field states (``self.x = ...``
    assignments seen in any method) and warms summaries; pass 2 recomputes
    with stable class fields and records the raw findings. ``secret_raw``
    and ``dtype_raw`` are consumed by the two project rules."""

    def __init__(self, project: ProjectInfo):
        self.project = project
        self.classes: Dict[Tuple[str, str], ClassSpec] = {}
        self.ctor_index: Dict[str, List[Tuple[str, str]]] = {}
        self.class_fields: Dict[Tuple[str, str], Dict[str, AV]] = {}
        self.summaries: Dict[str, Summary] = {}
        self._computing: Set[str] = set()
        self.recording = False
        self.secret_raw: List[RawFinding] = []
        self.dtype_raw: List[RawFinding] = []
        self._seen_sites: Set[Tuple[str, str, int]] = set()
        self.runs = 0                     # cache-hit observability
        self._collect_classes()

    # -- classes ----------------------------------------------------------

    def _collect_classes(self) -> None:
        for dotted, mg in self.project.graphs.items():
            for node in ast.walk(mg.info.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                fields = tuple(
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name))
                is_dc = any(
                    (_dotted(d.func if isinstance(d, ast.Call) else d)
                     or "").split(".")[-1] == "dataclass"
                    for d in node.decorator_list)
                is_dc = is_dc or any(
                    (_dotted(b) or "").split(".")[-1] == "NamedTuple"
                    for b in node.bases)
                key = (dotted, node.name)
                self.classes[key] = ClassSpec(dotted, node.name, fields,
                                              is_dc)
                self.ctor_index.setdefault(node.name, []).append(key)

    def class_for_ctor(self, module: str, name: str
                       ) -> Optional[Tuple[str, str]]:
        """(module, ClassName) a constructor call resolves to: same-module
        class first, then a unique bare-name match project-wide."""
        if (module, name) in self.classes:
            return (module, name)
        cands = self.ctor_index.get(name, [])
        return cands[0] if len(cands) == 1 else None

    # -- the run ----------------------------------------------------------

    def run(self, focus: Optional[Set[str]] = None) -> None:
        """Interpret every function (or, focused, only those defined in
        the ``focus`` relpaths — callees elsewhere are still pulled in
        lazily through their summaries) and record raw findings."""
        self.runs += 1
        fids = sorted(self.project.calls.functions)
        if focus is not None:
            fids = [fid for fid in fids
                    if self._relpath_of(fid) in focus]
        for final in (False, True):
            self.recording = final
            self.summaries.clear()
            self._seen_sites.clear()
            self.secret_raw, self.dtype_raw = [], []
            for fid in fids:
                self.summary_for(fid)
        self.secret_raw.sort(key=lambda r: (r.file, r.line))
        self.dtype_raw.sort(key=lambda r: (r.file, r.line))

    def _relpath_of(self, fid: str) -> str:
        mg = self.project.graphs.get(fid.split(":", 1)[0])
        return mg.info.relpath if mg is not None else ""

    def summary_for(self, fid: str) -> Summary:
        got = self.summaries.get(fid)
        if got is not None:
            return got
        fn = self.project.calls.functions.get(fid)
        if fn is None or fid in self._computing:
            return _EMPTY                 # unknown / recursion cut
        self._computing.add(fid)
        try:
            summ = _Interp(self, fn).run()
        except RecursionError:            # pathological nesting: give up
            summ = Summary(fid, (), TOP, ())
        finally:
            self._computing.discard(fid)
        self.summaries[fid] = summ
        return summ

    def record(self, kind: str, file: str, line: int, message: str,
               chain: Tuple[str, ...]) -> None:
        if not self.recording:
            return
        in_scope = _secret_scope(file) if kind == "secret" \
            else _dtype_scope(file)
        if not in_scope:
            return
        key = (kind, file, line)
        if key in self._seen_sites:
            return
        self._seen_sites.add(key)
        anchors: List[Tuple[str, int]] = []
        for hop in chain:
            parts = hop.split(":", 2)
            if len(parts) == 3 and parts[1].isdigit():
                anchors.append((parts[0], int(parts[1])))
        raw = RawFinding(file, line, message, _cap(chain),
                         tuple(dict.fromkeys(anchors)))
        (self.secret_raw if kind == "secret" else self.dtype_raw).append(raw)

    def summaries_json(self, module: str) -> Dict[str, object]:
        """Golden-test surface: summaries of one module's functions."""
        return {fid: s.to_json() for fid, s in sorted(self.summaries.items())
                if fid.split(":", 1)[0] == module}


# -- the interpreter --------------------------------------------------------

class _Interp:
    def __init__(self, df: Dataflow, fn: FuncNode):
        self.df = df
        self.fn = fn
        self.mg = df.project.graphs[fn.module]
        self.info = self.mg.info
        self.rel = self.info.relpath
        self.sites = {id(s.node): s.callee
                      for s in df.project.calls.callees(fn.fid)}
        self.env: Dict[str, ValT] = {}
        self.params: List[str] = []
        a = fn.node.args
        idx = 0
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            if arg.arg in ("self", "cls"):
                key = self._self_class()
                self.env[arg.arg] = ObjVal(key, {}) if key else TOP
                continue
            av = AV(dtype_src=idx, secret_src=frozenset((idx,)))
            if _is_secret_ann(arg.annotation):
                hop = chain_hop(self.rel, arg.lineno,
                                f"Secret[...] annotated parameter "
                                f"'{arg.arg}'")
                av = dataclasses.replace(av, secrecy=SEC_SECRET,
                                         secret_chain=(hop,))
            self.env[arg.arg] = av
            self.params.append(arg.arg)
            idx += 1
        if a.vararg:
            self.env[a.vararg.arg] = TOP
        if a.kwarg:
            self.env[a.kwarg.arg] = TOP
        self.returns: List[ValT] = []
        self.sinks: List[ParamSink] = []

    def _self_class(self) -> Optional[Tuple[str, str]]:
        parts = self.fn.qual.split(".")
        if len(parts) >= 2 and (self.fn.module, parts[-2]) in self.df.classes:
            return (self.fn.module, parts[-2])
        return None

    def run(self) -> Summary:
        for stmt in self.fn.node.body:
            self.exec_stmt(stmt)
        if not self.returns:
            ret: ValT = TOP
        else:
            ret = self.returns[0]
            for r in self.returns[1:]:
                ret = join_val(ret, r)
        return Summary(self.fn.fid, tuple(self.params), ret,
                       tuple(dict.fromkeys(self.sinks)))

    # -- statements -------------------------------------------------------

    def exec_stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.Assign):
            v = self._declassify(self.eval(stmt.value), stmt.lineno)
            for t in stmt.targets:
                self.assign(t, v)
        elif isinstance(stmt, ast.AnnAssign):
            secret_ann = _is_secret_ann(stmt.annotation)
            if stmt.value is not None:
                v = self._declassify(self.eval(stmt.value), stmt.lineno)
            elif secret_ann:
                # declaration-only form (``sk: Secret[int]``): bind the
                # seed so later reads of the name carry it
                v = TOP
            else:
                return
            if secret_ann:
                v = self._mark_secret(v, stmt.lineno,
                                      "Secret[...] annotated binding")
            self.assign(stmt.target, v)
        elif isinstance(stmt, ast.AugAssign):
            cur = TOP
            if isinstance(stmt.target, ast.Name):
                cur = self.env.get(stmt.target.id, TOP)
            v = self._binop_result(collapse(cur),
                                   collapse(self.eval(stmt.value)),
                                   stmt.op, stmt.value, stmt.lineno)
            self.assign(stmt.target, self._declassify(v, stmt.lineno))
        elif isinstance(stmt, ast.Return):
            v = self.eval(stmt.value) if stmt.value is not None else TOP
            self.returns.append(self._declassify(v, stmt.lineno))
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            saved = dict(self.env)
            for s in stmt.body:
                self.exec_stmt(s)
            after_body = self.env
            self.env = dict(saved)
            for s in stmt.orelse:
                self.exec_stmt(s)
            merged = dict(self.env)
            for k, v in after_body.items():
                merged[k] = join_val(merged[k], v) if k in merged else v
            self.env = merged
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self.eval(stmt.iter)
            self.assign(stmt.target, self._element_of(it))
            for s in stmt.body:
                self.exec_stmt(s)
            for s in stmt.orelse:
                self.exec_stmt(s)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            for s in stmt.body:
                self.exec_stmt(s)
            for s in stmt.orelse:
                self.exec_stmt(s)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, v)
            for s in stmt.body:
                self.exec_stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body:
                self.exec_stmt(s)
            for h in stmt.handlers:
                for s in h.body:
                    self.exec_stmt(s)
            for s in stmt.orelse:
                self.exec_stmt(s)
            for s in stmt.finalbody:
                self.exec_stmt(s)
        elif isinstance(stmt, ast.Raise):
            self._exec_raise(stmt)
        elif isinstance(stmt, ast.Assert):
            self.eval(stmt.test)
            if stmt.msg is not None:
                self.eval(stmt.msg)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        # FunctionDef/ClassDef/Import/Pass/etc: no value flow to model

    def _exec_raise(self, stmt: ast.Raise) -> None:
        if stmt.exc is None:
            return
        if not isinstance(stmt.exc, ast.Call):
            self.eval(stmt.exc)
            return
        exc_name = (_dotted(stmt.exc.func) or "Exception").split(".")[-1]
        for arg in list(stmt.exc.args) + [k.value for k in stmt.exc.keywords]:
            c = collapse(self.eval(arg))
            hop = chain_hop(self.rel, stmt.lineno,
                            f"raise {exc_name}(...) message")
            if c.secrecy == SEC_SECRET:
                self.df.record(
                    "secret", self.rel, stmt.lineno,
                    "secret value reaches an exception message — tracebacks "
                    "cross trust boundaries; redact or hash it",
                    c.secret_chain + (hop,))
            for p in c.secret_src:
                self.sinks.append(ParamSink(
                    p, "secret", c.secret_chain + (hop,),
                    "exception message"))

    def assign(self, target: ast.AST, v: ValT) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = v
        elif isinstance(target, ast.Starred):
            self.assign(target.value, collapse(v))
        elif isinstance(target, (ast.Tuple, ast.List)):
            plain = [t for t in target.elts
                     if not isinstance(t, ast.Starred)]
            if isinstance(v, TupleVal) and len(plain) == len(target.elts) \
                    and len(v.elts) == len(target.elts):
                for t, e in zip(target.elts, v.elts):
                    self.assign(t, e)
            else:
                c = self._element_of(v)
                for t in target.elts:
                    self.assign(t, c)
        elif isinstance(target, ast.Attribute):
            base = target.value
            if isinstance(base, ast.Name):
                obj = self.env.get(base.id)
                if isinstance(obj, ObjVal):
                    cv = v if not isinstance(v, AV) else v
                    obj.fields[target.attr] = (
                        join_val(obj.fields[target.attr], cv)
                        if target.attr in obj.fields else cv)
                    if base.id in ("self", "cls"):
                        conc = self._concrete(collapse(v))
                        cf = self.df.class_fields.setdefault(obj.cls, {})
                        cf[target.attr] = (join_av(cf[target.attr], conc)
                                           if target.attr in cf else conc)
        elif isinstance(target, ast.Subscript):
            if isinstance(target.value, ast.Name):
                name = target.value.id
                old = self.env.get(name, TOP)
                self.env[name] = join_av(collapse(old), collapse(v))

    @staticmethod
    def _concrete(av: AV) -> AV:
        """Strip symbolic param indices (they are meaningless outside the
        function being summarized) before persisting into class state."""
        return dataclasses.replace(av, dtype_src=None,
                                   secret_src=frozenset(),
                                   launders_src=frozenset())

    @staticmethod
    def _fold(vals: List[AV]) -> AV:
        """Join a list of AVs without a TOP seed (TOP's unknown dtype is
        absorbing, so folding from it would drop every dtype fact)."""
        if not vals:
            return TOP
        out = vals[0]
        for v in vals[1:]:
            out = join_av(out, v)
        return out

    @staticmethod
    def _element_of(v: ValT) -> ValT:
        """The value of one element when iterating/unpacking ``v``:
        iterating a limb array yields limb rows; iterating a secret
        list yields secret elements."""
        if isinstance(v, TupleVal):
            return collapse(v)
        if isinstance(v, ObjVal):
            return TOP
        return v

    def _mark_secret(self, v: ValT, lineno: int, what: str) -> ValT:
        """Structurally force ``v`` secret (annotation seeds). Leaves that
        are already secret keep their original, more precise chain."""
        hop = chain_hop(self.rel, lineno, what)

        def mark(x: ValT) -> ValT:
            if isinstance(x, TupleVal):
                return TupleVal(tuple(mark(e) for e in x.elts))
            if isinstance(x, ObjVal):
                return ObjVal(x.cls, {k: mark(e)
                                      for k, e in x.fields.items()})
            if x.secrecy == SEC_SECRET:
                return x
            return dataclasses.replace(
                x, secrecy=SEC_SECRET,
                secret_chain=_cap(x.secret_chain + (hop,)))

        return mark(v)

    def _declassify(self, v: ValT, lineno: int) -> ValT:
        if not (1 <= lineno <= len(self.info.lines)):
            return v
        m = _DECLASSIFY_RE.search(self.info.lines[lineno - 1])
        if not m:
            return v
        kinds = {k.strip() for k in m.group(1).split(",")}

        def scrub(x: ValT) -> ValT:
            if isinstance(x, TupleVal):
                return TupleVal(tuple(scrub(e) for e in x.elts))
            if isinstance(x, ObjVal):
                return ObjVal(x.cls, {k: scrub(e)
                                      for k, e in x.fields.items()})
            out = x
            if "secret" in kinds:
                out = dataclasses.replace(out, secrecy=SEC_PUBLIC,
                                          secret_src=frozenset(),
                                          secret_chain=())
            if "dtype" in kinds:
                out = dataclasses.replace(out, laundered=False,
                                          launders_src=frozenset(),
                                          dtype_chain=())
            return out

        return scrub(v)

    # -- expressions ------------------------------------------------------

    def eval(self, node: Optional[ast.AST]) -> ValT:
        if node is None:
            return TOP
        if isinstance(node, ast.Constant):
            if isinstance(node.value, float):
                return AV(dtype=DT_OTHER)
            return TOP
        if isinstance(node, ast.Name):
            return self.env.get(node.id, TOP)
        if isinstance(node, (ast.Tuple, ast.List)):
            return TupleVal(tuple(
                collapse(self.eval(e.value)) if isinstance(e, ast.Starred)
                else self.eval(e) for e in node.elts))
        if isinstance(node, ast.Dict):
            # fold from the first value, not TOP: TOP's unknown dtype is
            # absorbing and would erase a limb pin carried by the values
            vals = [collapse(self.eval(v)) for v in node.values]
            return self._fold(vals)
        if isinstance(node, ast.Set):
            vals = [collapse(self.eval(v)) for v in node.elts]
            return self._fold(vals)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for comp in node.generators:
                self.assign(comp.target,
                            self._element_of(self.eval(comp.iter)))
                for cond in comp.ifs:
                    self.eval(cond)
            return collapse(self.eval(node.elt))
        if isinstance(node, ast.DictComp):
            for comp in node.generators:
                self.assign(comp.target,
                            self._element_of(self.eval(comp.iter)))
                for cond in comp.ifs:
                    self.eval(cond)
            self.eval(node.key)
            return collapse(self.eval(node.value))
        if isinstance(node, ast.JoinedStr):
            # an f-string is a str whatever it embeds; secrecy still taints
            emb = self._fold([collapse(self.eval(v)) for v in node.values])
            return AV(dtype=DT_OTHER, secrecy=emb.secrecy,
                      secret_src=emb.secret_src,
                      secret_chain=emb.secret_chain)
        if isinstance(node, ast.FormattedValue):
            return collapse(self.eval(node.value))
        if isinstance(node, ast.BoolOp):
            return self._fold([collapse(self.eval(v))
                               for v in node.values])
        if isinstance(node, ast.Compare):
            self.eval(node.left)
            for c in node.comparators:
                self.eval(c)
            return TOP
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return join_val(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, ast.BinOp):
            return self._binop_result(
                collapse(self.eval(node.left)),
                collapse(self.eval(node.right)),
                node.op, node.right, node.lineno, left_node=node.left)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            self.eval(node.slice)
            if isinstance(base, TupleVal) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, int) \
                    and -len(base.elts) <= node.slice.value < len(base.elts):
                return base.elts[node.slice.value]
            if isinstance(base, AV):
                return base           # indexing preserves dtype/secrecy
            return collapse(base)
        if isinstance(node, ast.Attribute):
            return self._attr(node)
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            if node.value is not None:
                self.returns.append(self.eval(node.value))
            return TOP
        if isinstance(node, ast.NamedExpr):
            v = self.eval(node.value)
            self.assign(node.target, v)
            return v
        if isinstance(node, ast.Lambda):
            return TOP
        return TOP

    def _attr(self, node: ast.Attribute) -> ValT:
        base = self.eval(node.value)
        if node.attr in _SHAPE_ATTRS:
            return AV(dtype=DT_OTHER)
        if isinstance(base, ObjVal):
            if node.attr in base.fields:
                return base.fields[node.attr]
            cf = self.df.class_fields.get(base.cls, {})
            return cf.get(node.attr, TOP)
        b = collapse(base)
        if node.attr == "T":
            return b                  # transpose preserves everything
        # attribute of a secret object is secret; dtype is unknown
        return AV(secrecy=b.secrecy, secret_src=b.secret_src,
                  secret_chain=b.secret_chain)

    def _binop_result(self, lv: AV, rv: AV, op: ast.AST,
                      right_node: ast.AST, lineno: int,
                      left_node: Optional[ast.AST] = None) -> AV:
        def is_int_const(n: Optional[ast.AST]) -> bool:
            return (isinstance(n, ast.Constant)
                    and isinstance(n.value, int)
                    and not isinstance(n.value, bool))

        def is_float_const(n: Optional[ast.AST]) -> bool:
            return (isinstance(n, ast.Constant)
                    and isinstance(n.value, float))

        joined = join_av(lv, rv)
        # pick the "array side" dtype view: an int constant operand never
        # promotes a limb tensor (a Python scalar never widens a tensor)
        sides = []
        if not is_int_const(left_node) and not is_float_const(left_node):
            sides.append(lv)
        if not is_int_const(right_node) and not is_float_const(right_node):
            sides.append(rv)
        if not sides:
            sides = [lv, rv]
        arr = sides[0]
        for s in sides[1:]:
            arr = join_av(arr, s)
        launders = (isinstance(op, ast.Div)
                    or is_float_const(right_node)
                    or is_float_const(left_node))
        if launders:
            what = ("true division launders the limbs"
                    if isinstance(op, ast.Div)
                    else "float arithmetic launders the limbs")
            arr = self._launder(arr, lineno, what)
        return dataclasses.replace(
            arr, secrecy=joined.secrecy, secret_src=joined.secret_src,
            secret_chain=joined.secret_chain)

    def _launder(self, v: AV, lineno: int, what: str) -> AV:
        hop = chain_hop(self.rel, lineno, what)
        if v.dtype in LIMB_DTYPES:
            return dataclasses.replace(
                v, dtype=DT_OTHER, laundered=True, dtype_src=None,
                launders_src=frozenset(),
                dtype_chain=_cap(v.dtype_chain + (hop,)))
        extra = (frozenset((v.dtype_src,)) if v.dtype_src is not None
                 else frozenset())
        ls = v.launders_src | extra
        chain = (_cap(v.dtype_chain + (hop,))
                 if (v.laundered or ls) else v.dtype_chain)
        return dataclasses.replace(v, dtype=DT_OTHER, dtype_src=None,
                                   launders_src=ls, dtype_chain=chain)

    def _pin(self, v: AV, lineno: int, what: str,
             dtype: str = DT_UINT32) -> AV:
        hop = chain_hop(self.rel, lineno, what)
        return AV(dtype=dtype, secrecy=v.secrecy, laundered=False,
                  dtype_src=None, secret_src=v.secret_src,
                  launders_src=frozenset(), dtype_chain=(hop,),
                  secret_chain=v.secret_chain)

    # -- calls ------------------------------------------------------------

    def eval_call(self, call: ast.Call) -> ValT:
        if isinstance(call.func, ast.Attribute):
            leaf = call.func.attr
        elif isinstance(call.func, ast.Name):
            leaf = call.func.id
        else:
            leaf = ""
        d = _dotted(call.func) or ""
        recv: Optional[ValT] = None
        if isinstance(call.func, ast.Attribute):
            recv = self.eval(call.func.value)
        argvals: List[ValT] = [
            self.eval(a.value) if isinstance(a, ast.Starred)
            else self.eval(a) for a in call.args]
        kwvals: Dict[Optional[str], ValT] = {
            kw.arg: self.eval(kw.value) for kw in call.keywords}

        self._check_secret_sinks(call, d, leaf, recv, argvals, kwvals)
        self._check_dtype_sinks(call, leaf, recv, argvals)

        if (leaf in _MUTATOR_LEAVES and isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id in self.env):
            # container-sensitive secrecy: xs.append(secret) re-binds xs
            # with the argument's taint joined in (mirrors the
            # subscript-assign rule in ``assign``)
            folded = self._fold([collapse(v)
                                 for v in argvals + list(kwvals.values())])
            if folded.secrecy == SEC_SECRET or folded.secret_src:
                name = call.func.value.id
                hop = chain_hop(self.rel, call.lineno,
                                f".{leaf}() into container '{name}'")
                self.env[name] = join_av(
                    collapse(self.env[name]),
                    AV(secrecy=folded.secrecy,
                       secret_src=folded.secret_src,
                       secret_chain=_cap(folded.secret_chain + (hop,))))

        seeded = self._seed(call, d, leaf)
        if seeded is not None:
            return seeded
        if isinstance(call.func, ast.Name) and leaf in _PUBLIC_FUNCS:
            return AV(dtype=DT_OTHER)
        if isinstance(call.func, ast.Attribute) and leaf in _DIGEST_LEAVES:
            return AV(dtype=DT_OTHER)
        transferred = self._dtype_transfer(call, d, leaf, recv, argvals,
                                           kwvals)
        if transferred is not None:
            return transferred
        tree = self._pytree(call, d, leaf, argvals)
        if tree is not None:
            return tree
        ctor = self._ctor(call, leaf, argvals, kwvals)
        if ctor is not None:
            return ctor

        fid = self.sites.get(id(call))
        if fid is not None:
            return self._apply_summary(fid, call, argvals, kwvals)

        # unknown call: taint-through (shallow — objects don't leak their
        # fields through helpers), dtype gives up, laundering is dropped
        out = TOP
        for v in argvals + list(kwvals.values()):
            out = join_av(out, shallow(v))
        if recv is not None:
            out = join_av(out, shallow(recv))
        return AV(secrecy=out.secrecy, secret_src=out.secret_src,
                  secret_chain=out.secret_chain)

    # -- sinks ------------------------------------------------------------

    def _secret_sink_name(self, call: ast.Call, d: str,
                          leaf: str) -> Optional[str]:
        if isinstance(call.func, ast.Name) and leaf == "print":
            return "print()"
        if isinstance(call.func, ast.Attribute):
            if leaf in _LOG_METHODS:
                root = call.func.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in _LOGGER_NAMES:
                    return f"{d or leaf}() log output"
            if leaf in _SEND_LEAVES:
                return f".{leaf}() transport send"
        if leaf in _DUMP_LEAVES:
            return f"{d or leaf}() serialized output"
        return None

    def _check_secret_sinks(self, call: ast.Call, d: str, leaf: str,
                            recv: Optional[ValT], argvals: List[ValT],
                            kwvals: Dict[Optional[str], ValT]) -> None:
        sink = self._secret_sink_name(call, d, leaf)
        vals = list(argvals) + list(kwvals.values())
        if leaf in ("tobytes", "to_bytes") and recv is not None:
            sink = f".{leaf}() serialization"
            vals = vals + [recv]
        if sink is None:
            return
        hop = chain_hop(self.rel, call.lineno, sink)
        for v in vals:
            c = collapse(v)
            if c.secrecy == SEC_SECRET:
                origin = (c.secret_chain[0].rsplit(":", 1)[-1]
                          if c.secret_chain else "secret value")
                self.df.record(
                    "secret", self.rel, call.lineno,
                    f"secret value ({origin}) reaches {sink} — redact or "
                    f"hash it before it crosses a trust boundary",
                    c.secret_chain + (hop,))
            for p in c.secret_src:
                self.sinks.append(ParamSink(p, "secret",
                                            c.secret_chain + (hop,), sink))

    def _check_dtype_sinks(self, call: ast.Call, leaf: str,
                           recv: Optional[ValT],
                           argvals: List[ValT]) -> None:
        # cuda_build.launch(lib, entry, out, inputs, ints): out and the
        # tensors of inputs; a kernel wrapper: every operand
        kernel: Optional[str] = None
        operands = argvals
        project = self.df.project
        if is_launch_call(call, project.modules[self.rel].launch_aliases):
            kernel = "cuda_build.launch"
            operands = argvals[2:4]
        fid = self.sites.get(id(call))
        if kernel is None and fid is not None \
                and fid in project.calls.wrappers:
            kernel = f"kernel wrapper '{fid.rsplit(':', 1)[-1]}'"
        if kernel is not None:
            hop = chain_hop(self.rel, call.lineno, kernel)
            for i, v in enumerate(operands):
                c = collapse(v)
                if c.laundered:
                    self.df.record(
                        "dtype", self.rel, call.lineno,
                        f"operand {i} of {kernel} was a limb tensor and "
                        f"lost the dtype on the way (laundered) — re-pin "
                        f"with .to(torch.int32) at the boundary",
                        c.dtype_chain + (hop,))
                for p in c.launders_src:
                    self.sinks.append(ParamSink(
                        p, "dtype-launder", c.dtype_chain + (hop,), kernel))
                if c.dtype_src is not None:
                    self.sinks.append(ParamSink(
                        c.dtype_src, "dtype-pass", (hop,), kernel))
        if leaf in ("tobytes", "to_bytes") and recv is not None:
            c = collapse(recv)
            hop = chain_hop(self.rel, call.lineno, f".{leaf}() serialization")
            if c.laundered:
                self.df.record(
                    "dtype", self.rel, call.lineno,
                    "a laundered limb array is serialized — the "
                    "byte transcript silently changes; re-pin the dtype "
                    "first",
                    c.dtype_chain + (hop,))
            for p in c.launders_src:
                self.sinks.append(ParamSink(
                    p, "dtype-launder", c.dtype_chain + (hop,),
                    "serialization"))

    # -- seeds ------------------------------------------------------------

    def _seed(self, call: ast.Call, d: str, leaf: str) -> Optional[ValT]:
        if leaf == "keygen":
            hop = chain_hop(self.rel, call.lineno,
                            "keygen() ElGamal secret key")
            return TupleVal((AV(secrecy=SEC_SECRET, secret_chain=(hop,)),
                             TOP))
        if leaf in _NONCE_LEAVES:
            hop = chain_hop(self.rel, call.lineno,
                            f"{d or leaf}() nonce draw")
            return AV(secrecy=SEC_SECRET, secret_chain=(hop,))
        if leaf in _CLEARTEXT_LEAVES:
            hop = chain_hop(self.rel, call.lineno,
                            f"{d or leaf}() DP cleartext load")
            return AV(secrecy=SEC_SECRET, secret_chain=(hop,))
        return None

    # -- dtype transfer ---------------------------------------------------

    def _dtype_transfer(self, call: ast.Call, d: str, leaf: str,
                        recv: Optional[ValT], argvals: List[ValT],
                        kwvals: Dict[Optional[str], ValT]
                        ) -> Optional[ValT]:
        if leaf == "astype" and isinstance(call.func, ast.Attribute) \
                and recv is not None and call.args:
            r = collapse(recv)
            limb = _limb_dtype(call.args[0])
            if limb is not None:
                return self._pin(r, call.lineno, f".astype({limb})", limb)
            dt = _dotted(call.args[0]) or "<dtype>"
            return self._launder(r, call.lineno, f".astype({dt})")
        if isinstance(call.func, ast.Attribute) and recv is not None:
            got = self._torch_method(call, leaf, collapse(recv))
            if got is not None:
                return got
        root = d.split(".")[0] if "." in d else ""
        is_torch = root == "torch"
        if root in _ARRAY_ROOTS and (leaf in _TORCH_CTORS if is_torch
                                     else leaf in _CTOR_DTYPE_POS):
            dtype = next((kw.value for kw in call.keywords
                          if kw.arg == "dtype"), None)
            pos = None if is_torch else _CTOR_DTYPE_POS[leaf]
            if dtype is None and pos is not None and len(call.args) > pos:
                dtype = call.args[pos]
            src = collapse(argvals[0]) if argvals else TOP
            if dtype is not None:
                limb = _limb_dtype(dtype)
                if limb is not None:
                    return self._pin(src, call.lineno,
                                     f"{d}(dtype={limb})", limb)
                if leaf in _FRESH_CTORS:
                    return AV(dtype=DT_OTHER)
                dt = _dotted(dtype) or "<dtype>"
                return self._launder(src, call.lineno, f"{d}(dtype={dt})")
            if leaf in ("array", "asarray", "tensor", "as_tensor") \
                    or leaf.endswith("_like"):
                if argvals:
                    return src        # no dtype: preserves the input's
            return AV()               # fresh ctor, inferred dtype
        if root in _ARRAY_ROOTS and leaf == "where" and len(argvals) == 3:
            return join_av(collapse(argvals[1]), collapse(argvals[2]))
        if root in _ARRAY_ROOTS and leaf in _PRESERVING_FUNCS and argvals:
            return collapse(argvals[0])
        if isinstance(call.func, ast.Attribute) and recv is not None \
                and leaf in _PRESERVING_METHODS and not call.args:
            return collapse(recv)
        return None

    def _torch_method(self, call: ast.Call, leaf: str,
                      r: AV) -> Optional[AV]:
        """dtype transfer of a torch tensor method: ``.to(dtype)``,
        ``.int()``, ``.float()`` and the dtype-keeping methods."""
        if leaf == "to":
            dtype = next((kw.value for kw in call.keywords
                          if kw.arg == "dtype"), None)
            if dtype is None:
                dtype = next((a for a in call.args if _is_dtype_expr(a)),
                             None)
            if dtype is None:
                return r              # .to(device): the dtype is kept
            limb = _limb_dtype(dtype)
            if limb is not None:
                return self._pin(r, call.lineno, f".to({limb})", limb)
            dt = _dotted(dtype) or "<dtype>"
            if dt in _FLOAT_DTYPES:
                return self._launder(r, call.lineno, f".to({dt})")
            return AV(dtype=DT_OTHER, secrecy=r.secrecy,
                      secret_src=r.secret_src, secret_chain=r.secret_chain)
        if leaf == "int" and not call.args:
            return self._pin(r, call.lineno, ".int()", DT_INT32)
        if leaf in _TORCH_FLOAT_METHODS and not call.args:
            return self._launder(r, call.lineno, f".{leaf}()")
        if leaf in _TORCH_PRESERVING_METHODS:
            return r
        return None

    # -- pytrees ----------------------------------------------------------

    def _pytree(self, call: ast.Call, d: str, leaf: str,
                argvals: List[ValT]) -> Optional[ValT]:
        treeish = "tree" in d or leaf in ("tree_flatten", "tree_unflatten",
                                          "tree_map")
        if not treeish:
            return None
        if leaf in ("flatten", "tree_flatten") and argvals:
            # (leaves, treedef): every leaf joins the packed value
            return TupleVal((collapse(argvals[0]), TOP))
        if leaf in ("unflatten", "tree_unflatten") and argvals:
            return collapse(argvals[-1])
        if leaf in ("map", "tree_map") and len(argvals) >= 2:
            return self._fold([collapse(v) for v in argvals[1:]])
        return None

    # -- constructors -----------------------------------------------------

    def _ctor(self, call: ast.Call, leaf: str, argvals: List[ValT],
              kwvals: Dict[Optional[str], ValT]) -> Optional[ValT]:
        if not leaf or not leaf[:1].isupper():
            return None
        key = self.df.class_for_ctor(self.fn.module, leaf)
        if key is None:
            return None
        spec = self.df.classes[key]
        fields: Dict[str, ValT] = {}
        for name, v in zip(spec.fields, argvals):
            fields[name] = v
        for kwname, v in kwvals.items():
            if kwname is not None:
                fields[kwname] = v
        return ObjVal(key, fields)

    # -- summary application ----------------------------------------------

    def _apply_summary(self, fid: str, call: ast.Call, argvals: List[ValT],
                       kwvals: Dict[Optional[str], ValT]) -> ValT:
        summ = self.df.summary_for(fid)
        callee = self.df.project.calls.functions.get(fid)
        qual = callee.qual if callee is not None else fid

        has_star = (any(isinstance(a, ast.Starred) for a in call.args)
                    or None in kwvals)

        def arg_for(j: int) -> ValT:
            if has_star or j >= len(summ.params):
                return TOP
            name = summ.params[j]
            if name in kwvals:
                return kwvals[name]           # type: ignore[index]
            if j < len(argvals):
                return argvals[j]
            return TOP

        # fire / propagate the callee's param sinks
        for ps in summ.sinks:
            av = collapse(arg_for(ps.param))
            pname = (summ.params[ps.param]
                     if ps.param < len(summ.params) else f"#{ps.param}")
            call_hop = chain_hop(self.rel, call.lineno,
                                 f"{qual}({pname})")
            if ps.kind == "secret":
                if av.secrecy == SEC_SECRET:
                    self.df.record(
                        "secret", self.rel, call.lineno,
                        f"secret value passed to '{qual}' reaches "
                        f"{ps.message} inside it",
                        av.secret_chain + (call_hop,) + ps.chain)
                for p in av.secret_src:
                    self.sinks.append(ParamSink(
                        p, "secret",
                        av.secret_chain + (call_hop,) + ps.chain,
                        ps.message))
            elif ps.kind == "dtype-pass":
                if av.laundered:
                    self.df.record(
                        "dtype", self.rel, call.lineno,
                        f"laundered limb value passed to '{qual}' "
                        f"reaches {ps.message} inside it — re-pin with "
                        f".to(torch.int32)",
                        av.dtype_chain + (call_hop,) + ps.chain)
                for p in av.launders_src:
                    self.sinks.append(ParamSink(
                        p, "dtype-launder",
                        av.dtype_chain + (call_hop,) + ps.chain,
                        ps.message))
                if av.dtype_src is not None:
                    self.sinks.append(ParamSink(
                        av.dtype_src, "dtype-pass",
                        (call_hop,) + ps.chain, ps.message))
            elif ps.kind == "dtype-launder":
                if av.dtype in LIMB_DTYPES:
                    self.df.record(
                        "dtype", self.rel, call.lineno,
                        f"limb value passed to '{qual}' is laundered "
                        f"inside it and reaches {ps.message} — pin the "
                        f"dtype at the boundary",
                        av.dtype_chain + (call_hop,) + ps.chain)
                if av.dtype_src is not None:
                    self.sinks.append(ParamSink(
                        av.dtype_src, "dtype-launder",
                        (call_hop,) + ps.chain, ps.message))

        call_hop = chain_hop(self.rel, call.lineno, f"{qual}()")

        def map_leaf(av: AV) -> AV:
            out = av
            if av.dtype_src is not None:
                src = collapse(arg_for(av.dtype_src))
                out = dataclasses.replace(
                    out, dtype=src.dtype, dtype_src=src.dtype_src,
                    laundered=out.laundered or src.laundered,
                    launders_src=out.launders_src | src.launders_src,
                    dtype_chain=_cap(src.dtype_chain + out.dtype_chain))
            if av.secret_src:
                srcs = [collapse(arg_for(j)) for j in sorted(av.secret_src)]
                hot = next((s for s in srcs if s.secrecy == SEC_SECRET),
                           None)
                sym = frozenset().union(*(s.secret_src for s in srcs)) \
                    if srcs else frozenset()
                if hot is not None:
                    out = dataclasses.replace(
                        out, secrecy=SEC_SECRET, secret_src=sym,
                        secret_chain=_cap(hot.secret_chain + (call_hop,)
                                          + out.secret_chain))
                else:
                    out = dataclasses.replace(out, secret_src=sym)
            if av.launders_src:
                lsym = set(out.launders_src - av.launders_src)
                fired = None
                for j in sorted(av.launders_src):
                    src = collapse(arg_for(j))
                    if src.dtype in LIMB_DTYPES and fired is None:
                        fired = src
                    if src.dtype_src is not None:
                        lsym.add(src.dtype_src)
                if fired is not None:
                    out = dataclasses.replace(
                        out, laundered=True,
                        launders_src=frozenset(lsym),
                        dtype_chain=_cap(fired.dtype_chain + (call_hop,)
                                         + out.dtype_chain))
                else:
                    out = dataclasses.replace(out,
                                              launders_src=frozenset(lsym))
            return out

        def map_value(v: ValT) -> ValT:
            if isinstance(v, TupleVal):
                return TupleVal(tuple(map_value(e) for e in v.elts))
            if isinstance(v, ObjVal):
                return ObjVal(v.cls, {k: map_value(e)
                                      for k, e in v.fields.items()})
            return map_leaf(v)

        return map_value(summ.ret)


# -- project-fingerprint cache ----------------------------------------------

_DF_CACHE: Dict[str, Dataflow] = {}
_DF_CACHE_MAX = 8


def project_fingerprint(project: ProjectInfo) -> str:
    h = hashlib.sha256()
    for rel in sorted(project.modules):
        h.update(rel.encode("utf-8"))
        h.update(project.modules[rel].content_hash.encode("utf-8"))
    return h.hexdigest()


def dataflow_for(project: ProjectInfo,
                 focus: Optional[Set[str]] = None) -> Dataflow:
    """The (memoized) engine run for a project: both consuming rules — and
    repeated analyze_project calls over unchanged sources — share one.
    A focused run (--changed-only) caches under its own key: it only
    interprets functions defined in the focus relpaths."""
    fp = project_fingerprint(project)
    if focus is not None:
        fp = hashlib.sha256(
            (fp + "|" + "\n".join(sorted(focus))).encode("utf-8")
        ).hexdigest()
    df = _DF_CACHE.get(fp)
    if df is None:
        if len(_DF_CACHE) >= _DF_CACHE_MAX:
            _DF_CACHE.clear()
        df = Dataflow(project)
        df.run(focus)
        _DF_CACHE[fp] = df
    return df
