"""The port's lint rules (see the README's analyzer section).

Every rule is a static approximation: it must be cheap, zero-dependency
(no torch import) and err toward flagging — suppressions (`# drynx:
noqa[rule]`) and the committed baseline absorb deliberate exceptions.

Each rule of the reference analyzer (``drynx_tpu/analysis/rules.py``)
is here in one of four groups, which ``--list-rules`` prints: *kept*
unchanged, *adapted* to torch, *replaced* by a CUDA counterpart (the
rule's ``replaces``), or *n/a* (:data:`NOT_APPLICABLE`, with the reason).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .core import (Finding, ModuleInfo, Rule, _dotted, is_launch_call,
                   register)
from .dataflow import _is_dtype_expr
from .graph import FuncNode, _calls_with_scope, _own_calls, _own_returns
from .project import ProjectInfo, ProjectRule, chain_hop
_SECRET_RE = re.compile(
    r"(^|_)(sk|secret|secrets|priv|privkey|private(_?key)?)(_|$)|secret",
    re.IGNORECASE)

_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log", "lvl", "lvl1", "lvl2", "lvl3"}
_LOGGER_NAMES = {"log", "logging", "logger", "_logger", "LOG", "LOGGER"}


def _in_scope(mod: ModuleInfo, *parts: str) -> bool:
    return any(f"/{p}/" in f"/{mod.relpath}" for p in parts)


def _is_drynx_pkg(mod: ModuleInfo) -> bool:
    # lintpkg is the test fixture package: it opts into the scoped rules so
    # the project-level pass can be exercised end-to-end from the CLI.
    return (mod.relpath.startswith("drynx_tpu_torch/")
            or "/drynx_tpu_torch/" in mod.relpath
            or "lintpkg" in mod.relpath)



# Reference rules with no counterpart in the port, each with its reason.
_NO_TRACE_CACHE = (
    "the port has no trace cache: nothing is jitted or torch.compile'd, a "
    "kernel's behaviour is fixed by its launch arguments, and cuda_build "
    "keys each library by a digest of its sources and flags")
NOT_APPLICABLE: Dict[str, str] = {
    "jit-global-capture": _NO_TRACE_CACHE,
    "env-read-into-trace": _NO_TRACE_CACHE,
    "cross-module-flag-capture": _NO_TRACE_CACHE,
}

# ---------------------------------------------------------------------------
@register
class UnsafePickle(Rule):
    """VNs deserialize proof bodies sent by the very parties they exist to
    distrust; `pickle.loads` on those bytes is remote code execution via a
    crafted __reduce__. All deserialization must go through the restricted
    unpickler in proofs/safe_pickle.py (the only file allowed here)."""

    id = "unsafe-pickle"
    summary = ("raw pickle.load(s)/Unpickler outside proofs/safe_pickle.py "
               "— RCE on attacker-controlled bytes")

    _ALLOWED_SUFFIX = "proofs/safe_pickle.py"

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.relpath.endswith(self._ALLOWED_SUFFIX):
            return
        # track `from pickle import loads [as x]`
        from_pickle: Set[str] = set()
        for node in mod.tree.body:
            if isinstance(node, ast.ImportFrom) and node.module == "pickle":
                for a in node.names:
                    if a.name in ("loads", "load", "Unpickler"):
                        from_pickle.add(a.asname or a.name)
        for sub in ast.walk(mod.tree):
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            bad = (d in ("pickle.loads", "pickle.load", "pickle.Unpickler")
                   or (isinstance(sub.func, ast.Name)
                       and sub.func.id in from_pickle))
            if bad:
                yield self.finding(
                    mod, sub,
                    f"'{d or sub.func.id}' on untrusted bytes is arbitrary "
                    f"code execution; use proofs.safe_pickle.safe_loads")


# ---------------------------------------------------------------------------
@register
class ImplicitDtype(Rule):
    """The crypto/proof layers are exact int32 limb arithmetic (the
    kernels' operands) and exact int64 statistics: a dtype-inferred
    tensor (int64 from Python ints, float32 from floats) silently
    corrupts Montgomery carries or changes a hash transcript. Tensor
    constructors inside crypto/ and proofs/ must pin their dtype."""

    id = "implicit-dtype"
    group = "adapted"
    summary = ("torch tensor constructor without an explicit dtype inside "
               "crypto/ or proofs/ — inferred dtypes corrupt limb math")

    _CTORS = {"torch.tensor", "torch.as_tensor", "torch.zeros",
              "torch.ones", "torch.empty", "torch.full"}

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not (_is_drynx_pkg(mod) and _in_scope(mod, "crypto", "proofs")):
            return
        for sub in ast.walk(mod.tree):
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            if d not in self._CTORS:
                continue
            if any(k.arg == "dtype" for k in sub.keywords):
                continue
            yield self.finding(
                mod, sub,
                f"'{d}' without explicit dtype= — pin it (int32 limb "
                f"tensors / exact-int statistics must not rely on "
                f"inference)")


# ---------------------------------------------------------------------------
def _device_move(call: ast.Call) -> bool:
    """``.cuda()`` or ``.to(<device>)``/``.to(device=...)``: a call that
    uploads its receiver (a ``.to(<dtype>)`` cast stays on the host)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    return any(not _is_dtype_expr(a) for a in call.args)


@register
class HostRoundtripInDecode(Rule):
    """A value materialized on the host with ``np.asarray(...)`` and
    immediately turned into a tensor with ``torch.as_tensor`` /
    ``torch.tensor``, or a ``torch.from_numpy(...)`` tensor moved to the
    card with ``.to(cuda)``/``.cuda()``, is the host round-trip the
    device-direct data path removes: the wire / staging layers
    (service/, parallel/) should hand device consumers a device tensor
    directly (``transport.unpack_array_device``, ``proof_plane.put_shard``)
    instead of copying through host memory. Flags the nested forms and
    the two-statement forms ``v = np.asarray(...)`` followed by
    ``torch.as_tensor(v)``, and ``v = torch.from_numpy(...)`` followed by
    ``v.cuda()``."""

    id = "host-roundtrip-in-decode"
    group = "adapted"
    summary = ("np.asarray(...) re-wrapped by torch.as_tensor, or "
               "torch.from_numpy(...) moved to the card, inside service/ "
               "or parallel/ — use the device-direct decode path instead "
               "of a host round-trip")

    _HOST = {"np.asarray", "numpy.asarray"}
    _WRAP = {"torch.as_tensor", "torch.tensor"}
    _FROM_NUMPY = {"torch.from_numpy"}

    @staticmethod
    def _is(node, names) -> bool:
        return isinstance(node, ast.Call) and _dotted(node.func) in names

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not (_is_drynx_pkg(mod)
                and _in_scope(mod, "service", "parallel")):
            return
        for sub in ast.walk(mod.tree):
            if isinstance(sub, ast.Call) and self._is(sub, self._WRAP) \
                    and sub.args and self._is(sub.args[0], self._HOST):
                yield self.finding(
                    mod, sub,
                    f"'{_dotted(sub.func)}(np.asarray(...))' round-trips "
                    f"through host memory — decode/stage straight to "
                    f"device (unpack_array_device / put_shard)")
            elif isinstance(sub, ast.Call) and _device_move(sub) \
                    and self._is(sub.func.value, self._FROM_NUMPY):
                yield self.finding(
                    mod, sub,
                    f"'torch.from_numpy(...).{sub.func.attr}(...)' "
                    f"uploads a host copy — decode/stage straight to "
                    f"device (unpack_array_device / put_shard)")
            # two-statement forms: v = <host value>; <upload of v>
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(sub, field, None)
                if not isinstance(stmts, list):
                    continue
                for prev, nxt in zip(stmts, stmts[1:]):
                    if not (isinstance(prev, ast.Assign)
                            and len(prev.targets) == 1
                            and isinstance(prev.targets[0], ast.Name)):
                        continue
                    name = prev.targets[0].id
                    host = self._is(prev.value, self._HOST)
                    staged = self._is(prev.value, self._FROM_NUMPY)
                    if not (host or staged):
                        continue
                    for call in ast.walk(nxt):
                        if not isinstance(call, ast.Call):
                            continue
                        if host and self._is(call, self._WRAP) \
                                and call.args \
                                and isinstance(call.args[0], ast.Name) \
                                and call.args[0].id == name:
                            yield self.finding(
                                mod, call,
                                f"'{name} = np.asarray(...)' is "
                                f"immediately re-wrapped by "
                                f"'{_dotted(call.func)}({name})' — a "
                                f"host round-trip the device-direct "
                                f"path avoids")
                            break
                        if staged and _device_move(call) \
                                and isinstance(call.func.value, ast.Name) \
                                and call.func.value.id == name:
                            yield self.finding(
                                mod, call,
                                f"'{name} = torch.from_numpy(...)' is "
                                f"immediately uploaded by "
                                f"'{name}.{call.func.attr}(...)' — a host "
                                f"round-trip the device-direct path "
                                f"avoids")
                            break


# ---------------------------------------------------------------------------
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}


def _scalar_params(fn: ast.AST) -> Set[str]:
    """Parameters that are not tensors: annotated with a scalar type (or
    Optional of one), or defaulting to a non-None constant."""
    out: Set[str] = set()
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = dict(zip([x.arg for x in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update({x.arg: d for x, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    for x in pos + a.kwonlyargs:
        ann = x.annotation
        if isinstance(ann, ast.Subscript) and \
                (_dotted(ann.value) or "").split(".")[-1] == "Optional":
            ann = ann.slice
        elif isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr) \
                and isinstance(ann.right, ast.Constant) \
                and ann.right.value is None:
            ann = ann.left                         # `int | None`
        if ann is not None and (_dotted(ann) in _SCALAR_ANNOTATIONS or (
                isinstance(ann, ast.Constant)
                and ann.value in _SCALAR_ANNOTATIONS)):
            out.add(x.arg)
            continue
        d = defaults.get(x.arg)
        if isinstance(d, ast.Constant) and d.value is not None:
            out.add(x.arg)
    return out


@register
class HostSyncInHotPath(ProjectRule):
    """A launch path that reads a device tensor back to the host —
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``float()``/``int()``/``bool()``/``np.asarray()`` on a tensor — or
    calls ``torch.cuda.synchronize()`` blocks the host until every
    kernel queued before it has finished, so the next launch cannot be
    queued behind the running one: the pipeline serializes. Heuristic
    taint: function parameters (minus scalar-typed ones) and locals
    derived from them.

    The per-module pass (``run``) checks the launch helpers' bodies
    lexically. The project pass (``run_project``) follows the callgraph
    out of every launch entry in crypto/ or parallel/: a sync inside a
    plain helper *transitively reachable* from one fires too, with the
    call chain rendered and the finding suppressible at the sync site OR
    the entry. Reads of ``.shape/.ndim/.dtype/.device`` and ``len()``
    are host metadata and never taint."""

    id = "host-sync-in-hot-path"
    group = "adapted"
    summary = ("host-synchronizing call on a device tensor inside (or "
               "transitively reachable from) a launch entry in crypto/ or "
               "parallel/")

    _HOST_CASTS = {"float", "int", "bool"}
    _HOST_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
    _ALWAYS_SYNC = {"torch.cuda.synchronize"}

    _SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "device", "numel",
                    "dim", "is_cuda"}
    _MAX_DEPTH = 5

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not (_is_drynx_pkg(mod) and _in_scope(mod, "crypto", "parallel")):
            return
        for fn in mod.launch_functions:
            tainted = self._tainted_names(fn)
            for sub, what in self._body_syncs(fn, tainted):
                yield self.finding(
                    mod, sub,
                    f"'{what}' on a device tensor inside launch helper "
                    f"'{fn.name}' — blocks the host until the queued "
                    f"kernels finish")

    def _body_syncs(self, fn: ast.AST, tainted: Set[str],
                    ) -> Iterator[Tuple[ast.Call, str]]:
        """(call node, rendered sink) for every host sync on a tainted
        value lexically in fn (nested defs included: they close over the
        same tensors)."""
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            if d in self._ALWAYS_SYNC:
                yield sub, f"{d}()"
                continue
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in self._SYNC_METHODS):
                if self._refs_tainted(sub.func.value, tainted):
                    yield sub, f".{sub.func.attr}()"
                continue
            name = d if d in self._HOST_FUNCS else (
                sub.func.id if isinstance(sub.func, ast.Name)
                and sub.func.id in self._HOST_CASTS else None)
            if name and any(self._refs_tainted(a, tainted)
                            for a in sub.args):
                yield sub, f"{name}()"

    # -- project pass: follow the callgraph out of launch entries ---------

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        reported: Set[Tuple[str, int]] = set()
        for fid in sorted(project.calls.launch_entries):
            entry = project.calls.functions.get(fid)
            if entry is None:
                continue
            mg = project.graphs[entry.module]
            if not (_is_drynx_pkg(mg.info)
                    and _in_scope(mg.info, "crypto", "parallel")):
                continue
            # the launch helpers' own bodies are covered lexically by
            # run(); every other entry's body is included here
            lexical = any(entry.node is f for f in mg.info.launch_functions)
            chain = [chain_hop(mg.info.relpath, entry.node.lineno,
                               entry.qual)]
            anchors = ((mg.info.relpath, entry.node.lineno),)
            yield from self._walk_entry(
                project, entry, frozenset(self._tainted_names(entry.node)),
                chain, anchors, include_body=not lexical,
                reported=reported, visited=set(), depth=0)

    def _walk_entry(self, project: ProjectInfo, fn: FuncNode,
                    tainted_params: FrozenSet[str], chain: List[str],
                    anchors: Tuple[Tuple[str, int], ...], include_body: bool,
                    reported: Set[Tuple[str, int]],
                    visited: Set[Tuple[str, FrozenSet[str]]], depth: int,
                    ) -> Iterator[Finding]:
        key = (fn.fid, tainted_params)
        if key in visited or depth > self._MAX_DEPTH:
            return
        visited.add(key)
        mg = project.graphs[fn.module]
        tainted = self._propagate(fn.node, set(tainted_params))
        if include_body:
            for sub, what in self._body_syncs(fn.node, tainted):
                site = (mg.info.relpath, sub.lineno)
                if site in reported:
                    continue
                reported.add(site)
                full = chain + [chain_hop(mg.info.relpath, sub.lineno, what)]
                yield self.finding(
                    mg.info, sub,
                    f"'{what}' on a device tensor in '{fn.qual}', "
                    f"reachable from launch entry "
                    f"'{chain[0].rsplit(':', 1)[-1]}' — blocks the host "
                    f"until the queued kernels finish",
                    call_chain=full, anchors=anchors)
        for site in project.calls.callees(fn.fid):
            callee = project.calls.functions.get(site.callee)
            if callee is None or callee.fid in project.calls.launch_entries:
                continue  # launch entries are analyzed as their own
            passed = self._callee_taint(site.node, callee.node, tainted)
            if not passed:
                continue
            hop = chain_hop(mg.info.relpath, site.lineno, callee.qual)
            yield from self._walk_entry(
                project, callee, frozenset(passed), chain + [hop], anchors,
                include_body=True, reported=reported, visited=visited,
                depth=depth + 1)

    def _callee_taint(self, call: ast.Call, callee: ast.AST,
                      tainted: Set[str]) -> Set[str]:
        """Callee parameter names that receive tainted arguments."""
        args = callee.args
        params = [a.arg for a in (args.posonlyargs + args.args)
                  if a.arg != "self"]
        out: Set[str] = set()
        splat = False
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                splat = splat or self._refs_tainted(a, tainted)
                continue
            if self._refs_tainted(a, tainted) and i < len(params):
                out.add(params[i])
        for kw in call.keywords:
            if kw.arg is None:
                splat = splat or self._refs_tainted(kw.value, tainted)
            elif self._refs_tainted(kw.value, tainted):
                out.add(kw.arg)
        if splat:
            out.update(params)
        return out - _scalar_params(callee)

    def _tainted_names(self, fn: ast.AST) -> Set[str]:
        scalar = _scalar_params(fn)
        args = fn.args
        start = {a.arg for a in
                 (args.posonlyargs + args.args + args.kwonlyargs)
                 if a.arg not in scalar and a.arg not in ("self", "cls")}
        return self._propagate(fn, start)

    def _propagate(self, fn: ast.AST, tainted: Set[str]) -> Set[str]:
        # one forward pass of simple propagation through assignments
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) \
                    and self._refs_tainted(stmt.value, tainted):
                for t in stmt.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
        return tainted

    @classmethod
    def _refs_tainted(cls, node: ast.AST, tainted: Set[str]) -> bool:
        # x.shape / x.dtype / x.device / len(x) are host-side metadata:
        # code like `int(x.shape[0])` never syncs the device buffer.
        def walk(n: ast.AST) -> bool:
            if isinstance(n, ast.Attribute) and n.attr in cls._SHAPE_ATTRS:
                return False
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id == "len":
                return False
            if isinstance(n, ast.Name) and n.id in tainted:
                return True
            return any(walk(c) for c in ast.iter_child_nodes(n))
        return walk(node)


# ---------------------------------------------------------------------------
@register
class SecretLogging(Rule):
    """Secret-key material (ElGamal secrets, Schnorr nonces) must never hit
    a log stream or stdout: logs cross trust boundaries (CI artifacts,
    shared hosts) that the ciphertexts are specifically protecting the data
    from. Flags print()/log.*/logging calls whose arguments reference a
    secret-shaped identifier.

    Kept as the *seed list* for the dataflow successor
    ``secret-flow-to-sink`` (which tracks actual values from keygen/nonce
    definition sites instead of matching names): where both fire on the
    same line, the dataflow finding wins and this one is absorbed."""

    id = "secret-logging"
    seed_only = True
    summary = "print/log call referencing secret-key material"

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        for sub in ast.walk(mod.tree):
            if not isinstance(sub, ast.Call):
                continue
            if not self._is_log_sink(sub):
                continue
            ident = self._secret_ident(sub)
            if ident:
                yield self.finding(
                    mod, sub,
                    f"'{ident}' looks like secret-key material flowing "
                    f"into a log/print sink")

    @staticmethod
    def _is_log_sink(call: ast.Call) -> bool:
        if isinstance(call.func, ast.Name) and call.func.id == "print":
            return True
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _LOG_METHODS:
            root = call.func.value
            while isinstance(root, ast.Attribute):
                root = root.value
            return isinstance(root, ast.Name) and root.id in _LOGGER_NAMES
        return False

    @classmethod
    def _secret_ident(cls, call: ast.Call) -> str:
        for arg in list(call.args) + [k.value for k in call.keywords]:
            for n in ast.walk(arg):
                name = None
                if isinstance(n, ast.Name):
                    name = n.id
                elif isinstance(n, ast.Attribute):
                    name = n.attr
                if name and _SECRET_RE.search(name):
                    return name
        return ""


# ---------------------------------------------------------------------------
@register
class HardcodedTimeout(Rule):
    """Retry/timeout numbers scattered as bare literals made failure
    behavior unauditable: nobody could say how long a dead DP stalls a
    survey without reading every call site (the pre-resilience state of
    node.py/api.py/service.py). Every such number must be a named constant
    in drynx_tpu_torch/resilience/policy.py — that module is the single place
    the rule exempts. Fires on: timeout=/retries= keyword literals,
    timeout-ish parameter defaults, sleep/wait calls with literal
    durations, and `.get("...timeout...", <literal>)` fallbacks.

    The network plane added a second family of tuning knobs with
    the same auditability problem: fan-out worker counts and connection-
    pool bounds (workers=/max_workers=/max_idle=/pool_size=). A bare
    ``max_workers=8`` decides how hard a survey hammers a roster exactly
    like a bare ``timeout=900`` decides how long it stalls — both live as
    named constants in resilience/policy.py (FAN_OUT_WORKERS,
    CONN_POOL_MAX_IDLE).

    The tree overlay added a third family: tree fanout and pool
    caps (fanout=/tree_fanout=/pool_max=), surfaced as the
    DRYNX_TREE_FANOUT / DRYNX_TOPOLOGY / DRYNX_CONN_POOL_MAX env knobs.
    A literal ``fanout=8`` shapes dispatch depth — and a numeric literal
    fallback in ``.get("DRYNX_CONN_POOL_MAX", 1024)`` silently forks the
    default away from policy — so both route through TREE_FANOUT_MIN/MAX
    and CONN_POOL_MAX instead (env fallbacks stay string-typed, which
    this rule ignores by design).

    Saturation serving added the admission-control family:
    verify-worker pool width, per-tenant quotas, shed thresholds, and
    retry-after hint bounds (workers=/quota=/shed_fraction=/
    retry_after_*=), surfaced as the DRYNX_VERIFY_WORKERS /
    DRYNX_TENANT_QUOTA / DRYNX_SHED_FRACTION env knobs. A literal
    ``tenant_quota=8`` decides when a tenant starts seeing typed
    rejections exactly like a bare timeout decides when a caller gives
    up — the defaults live in policy.py (VERIFY_WORKERS, TENANT_QUOTA,
    SHED_FRACTION, SHED_RETRY_MIN_S/MAX_S).

    Streaming surveys added the window/pane/epsilon family:
    pane width, window span, per-advance privacy spend and slide pacing
    (pane_width=/window_panes=/epsilon_budget=/epsilon_per_advance=/
    slide_pacing=), surfaced as the DRYNX_PANE_WIDTH /
    DRYNX_STREAM_WINDOW / DRYNX_EPSILON_BUDGET /
    DRYNX_EPSILON_PER_ADVANCE / DRYNX_SLIDE_PACING env knobs. A literal
    ``epsilon_budget=1.0`` is a PRIVACY bound — a fork of that default
    away from policy is strictly worse than an unauditable timeout —
    and a literal ``pane_width=4096`` silently re-shapes every proof
    blob a stream caches; the defaults live in policy.py (PANE_WIDTH,
    STREAM_WINDOW_PANES, EPSILON_BUDGET, EPSILON_PER_ADVANCE,
    SLIDE_PACING_S)."""

    id = "hardcoded-timeout"
    summary = ("bare numeric timeout/retry/worker-pool literal outside "
               "drynx_tpu_torch/resilience/ — name it in resilience/policy.py")

    _SLEEPY = {"sleep", "wait", "join"}

    @staticmethod
    def _timeoutish(name: str) -> bool:
        n = name.lower()
        return ("timeout" in n or n == "retries" or n.endswith("_retries")
                or n.endswith("deadline")
                or n == "workers" or n.endswith("_workers")
                or n == "max_idle" or n.endswith("_idle")
                or n == "pool_size" or n.endswith("_pool_size")
                or n == "fanout" or n.endswith("_fanout")
                or n == "pool_max" or n.endswith("_pool_max")
                or n == "quota" or n.endswith("_quota")
                # NB: substring "shed" would also match "finished"
                or n == "shed" or n.startswith("shed_")
                or n.endswith("_shed") or "shed_fraction" in n
                or "retry_after" in n
                # streaming knobs: substring matches so the env-var forms
                # (DRYNX_PANE_WIDTH, DRYNX_STREAM_WINDOW, ...) fire in
                # .get() fallbacks too; bare "epsilon" stays unmatched —
                # it is a common math variable name
                or "pane_width" in n
                or "window_panes" in n or "stream_window" in n
                or "epsilon_budget" in n or "epsilon_per_advance" in n
                or n.endswith("_epsilon")
                or "slide_pacing" in n)

    @staticmethod
    def _nonzero_num(node: ast.AST) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, (int, float))
                and not isinstance(node.value, bool)
                and node.value != 0)

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not _is_drynx_pkg(mod) or _in_scope(mod, "resilience"):
            return
        for sub in ast.walk(mod.tree):
            if isinstance(sub, ast.Call):
                yield from self._check_call(mod, sub)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_defaults(mod, sub)

    def _check_call(self, mod: ModuleInfo, call: ast.Call):
        for kw in call.keywords:
            if kw.arg and self._timeoutish(kw.arg) \
                    and self._nonzero_num(kw.value):
                yield self.finding(
                    mod, call,
                    f"literal {kw.arg}={kw.value.value!r} — use a named "
                    f"constant from drynx_tpu_torch/resilience/policy.py")
                return
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in self._SLEEPY and call.args \
                    and self._nonzero_num(call.args[0]):
                yield self.finding(
                    mod, call,
                    f"literal duration in '.{call.func.attr}"
                    f"({call.args[0].value!r})' — use a named constant "
                    f"from drynx_tpu_torch/resilience/policy.py")
                return
            if (call.func.attr == "get" and len(call.args) >= 2
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)
                    and self._timeoutish(call.args[0].value)
                    and self._nonzero_num(call.args[1])):
                yield self.finding(
                    mod, call,
                    f"literal fallback in .get({call.args[0].value!r}, "
                    f"{call.args[1].value!r}) — use a named constant from "
                    f"drynx_tpu_torch/resilience/policy.py")

    def _check_defaults(self, mod: ModuleInfo, fn):
        args = fn.args
        pos = args.posonlyargs + args.args
        for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
            if self._timeoutish(a.arg) and self._nonzero_num(d):
                yield self.finding(
                    mod, d,
                    f"literal default {a.arg}={d.value!r} in '{fn.name}' — "
                    f"use a named constant from "
                    f"drynx_tpu_torch/resilience/policy.py")
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is not None and self._timeoutish(a.arg) \
                    and self._nonzero_num(d):
                yield self.finding(
                    mod, d,
                    f"literal default {a.arg}={d.value!r} in '{fn.name}' — "
                    f"use a named constant from "
                    f"drynx_tpu_torch/resilience/policy.py")


# ---------------------------------------------------------------------------
def _locked_calls(fn: ast.AST) -> Set[int]:
    """ids of the Call nodes lexically inside a ``with <...lock...>:``
    block of fn (nested defs are their own callgraph nodes)."""
    out: Set[int] = set()

    def visit(node: ast.AST, locked: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            inner = locked
            if isinstance(child, ast.With):
                inner = locked or any(
                    "lock" in (_dotted(i.context_expr) or "").lower()
                    for i in child.items)
            if isinstance(child, ast.Call) and locked:
                out.add(id(child))
            visit(child, inner)

    visit(fn, False)
    return out


@register
class ThreadBuild(ProjectRule):
    """The port's counterpart of first-touch tracing off the main thread:
    a ``threading.Thread`` whose target reaches ``cuda_build.load`` /
    ``build`` can start an nvcc build (seconds per library; minutes for
    a cold checkout) on a worker thread in the middle of a survey, while
    every other thread that wants a kernel waits on ``cuda_build``'s
    lock behind it, and a build that fails there fails one worker's
    survey instead of start-up. Libraries are built up front by the
    warm-up registry (``compilecache/``, ``cuda_build.build_all``) on the
    main thread. Fires when a thread target reaches a build through the
    callgraph outside a ``with <...lock...>:`` block and outside
    compilecache/; the chain from the spawn site to the build is
    rendered, and the finding is suppressible at the spawn site or the
    target."""

    id = "thread-build"
    group = "replaced"
    replaces = "thread-trace"
    summary = ("threading.Thread target reaches cuda_build.load/build "
               "outside the warm-up registry or a lock — a first-touch "
               "nvcc build on a worker thread")

    _BUILDERS = {"load", "build", "build_all", "build_copies"}
    _MAX_DEPTH = 12

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        calls = project.calls
        build_fns = {fid for fid, fn in calls.functions.items()
                    if fn.module.split(".")[-1] == "cuda_build"
                    and fn.qual in self._BUILDERS}
        if not build_fns:
            return
        self._locked: Dict[str, Set[int]] = {}
        for dotted in sorted(project.graphs):
            mg = project.graphs[dotted]
            info = mg.info
            if not (_is_drynx_pkg(info) and project.in_focus(info.relpath)
                    and not _in_scope(info, "compilecache")):
                continue
            for scope, call in _calls_with_scope(mg):
                if _dotted(call.func) not in ("threading.Thread", "Thread"):
                    continue
                target = next((kw.value for kw in call.keywords
                               if kw.arg == "target"), None)
                if target is None:
                    continue
                if isinstance(target, ast.Lambda):
                    starts = [calls.resolve_call(mg, scope, sub)
                              for sub in ast.walk(target.body)
                              if isinstance(sub, ast.Call)]
                else:
                    starts = [calls.resolve_call(
                        mg, scope, ast.Call(func=target, args=[],
                                            keywords=[]))]
                for start in filter(None, starts):
                    path = self._reach(project, start, build_fns)
                    if path is None:
                        continue
                    chain = [chain_hop(info.relpath, call.lineno,
                                       f"Thread(target={start.qual})")]
                    chain += path
                    yield self.finding(
                        info, call,
                        f"Thread target '{start.qual}' reaches "
                        f"'{path[-1].rsplit(':', 1)[-1]}' — a first-touch "
                        f"nvcc build off the main thread (build it in the "
                        f"warm-up, compilecache/, or under a lock)",
                        call_chain=chain,
                        anchors=((project.graphs[start.module].info.relpath,
                                  start.node.lineno),))
                    break

    def _reach(self, project: ProjectInfo, start: FuncNode,
               build_fns: Set[str]) -> Optional[List[str]]:
        """Rendered call sites from start to a build function, breadth first,
        skipping calls under a lock and functions in compilecache/."""
        calls = project.calls
        prev: Dict[str, Optional[Tuple[str, int, str]]] = {start.fid: None}
        frontier = [start.fid]
        for _ in range(self._MAX_DEPTH):
            nxt: List[str] = []
            for fid in frontier:
                fn = calls.functions[fid]
                rel = project.graphs[fn.module].info.relpath
                locked = self._locked.get(fid)
                if locked is None:
                    locked = self._locked[fid] = _locked_calls(fn.node)
                for site in calls.callees(fid):
                    if id(site.node) in locked or site.callee in prev:
                        continue
                    callee = calls.functions[site.callee]
                    if _in_scope(project.graphs[callee.module].info,
                                 "compilecache"):
                        continue
                    prev[site.callee] = (rel, site.lineno, fid)
                    if site.callee in build_fns:
                        hops: List[str] = []
                        cur: Optional[str] = site.callee
                        while prev[cur] is not None:
                            r, ln, parent = prev[cur]
                            hops.append(chain_hop(
                                r, ln, calls.functions[cur].qual))
                            cur = parent
                        return list(reversed(hops))
                    nxt.append(site.callee)
            frontier = nxt
        return None


# ---------------------------------------------------------------------------
_INT32 = {"torch.int32", "torch.int"}
_LAUNCH_ARGS = ("name", "entry", "out", "inputs", "ints")
# torch functions whose result has its tensor arguments' dtype and device
_KEEPING_FUNCS = {"torch.stack", "torch.cat", "torch.concat",
                  "torch.reshape", "torch.flatten", "torch.movedim",
                  "torch.permute", "torch.flip", "torch.roll"}
_KEEPING_METHODS = {"contiguous", "clone", "detach", "reshape", "view",
                    "permute", "flatten", "unsqueeze", "squeeze",
                    "expand", "narrow", "transpose", "repeat", "flip",
                    "roll", "index_select"}


class _Ctx:
    """Parameter bindings of one call path into a function: param name
    -> (caller FuncNode, argument expression, the caller's _Ctx)."""

    def __init__(self, binds=None, sites=()):
        self.binds: Dict[str, Tuple[FuncNode, Optional[ast.AST],
                                    "_Ctx"]] = binds or {}
        self.sites: Tuple[Tuple[str, int, str], ...] = tuple(sites)


@register
class CudaLaunchOperand(ProjectRule):
    """``cuda_build.launch`` hands raw pointers and ints to a C entry
    point through ctypes, which checks nothing behind a ``c_void_p``: a
    tensor that arrives as int64 or float, or on another device than the
    output, is read as int32 limbs on the launch device and silently
    computes garbage, and a call with one pointer or int too few or too
    many shifts every argument after it. Fires in two cases, per call
    path into each ``launch`` call:

    * a tensor reaching ``launch`` (``out`` or an element of ``inputs``)
      whose int32 dtype and device nothing proves: a
      ``cuda_build.check_operands`` call covering it on the path (in its
      function, or in a helper it is passed to), a constructor pinning
      ``dtype=torch.int32`` and ``device=``, a dtype- and device-keeping
      chain (``stack``/``cat``/``reshape``/``contiguous``/indexing) over
      proven tensors, or a project helper whose returns are all proven;
    * a call whose pointer count (``out`` plus the inputs) or int count
      differs from the entry point's row in ``cuda_build.ENTRY_POINTS``,
      names an entry point that is not there, or cannot be resolved to
      one statically."""

    id = "cuda-launch-operand"
    group = "replaced"
    replaces = "pallas-operand-dtype"
    summary = ("cuda_build.launch operand not proven int32 on the launch "
               "device, or pointer/int counts that differ from "
               "cuda_build.ENTRY_POINTS")

    _MAX_DEPTH = 8

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        self._project = project
        self._checked_memo: Dict[Tuple[str, str], bool] = {}
        self._pins_memo: Dict[str, bool] = {}
        self._rev = project.calls.callers
        table = self._entry_points(project)
        seen: Set[Tuple[str, int, str]] = set()
        for dotted in sorted(project.graphs):
            mg = project.graphs[dotted]
            info = mg.info
            if not (_is_drynx_pkg(info) and project.in_focus(info.relpath)):
                continue
            for qual in sorted(mg.functions):
                fn = mg.functions[qual]
                for call in _own_calls(fn.node):
                    if not is_launch_call(call, info.launch_aliases):
                        continue
                    for f in self._check(fn, call, table):
                        k = (f.file, f.line, f.message)
                        if k not in seen:
                            seen.add(k)
                            yield f

    @staticmethod
    def _entry_points(project: ProjectInfo):
        for mg in project.graphs.values():
            if mg.dotted.split(".")[-1] != "cuda_build":
                continue
            for a in mg.info.module_assigns.get("ENTRY_POINTS", ()):
                try:
                    return ast.literal_eval(a.value)
                except ValueError:
                    return None
        return None

    # -- one launch call ---------------------------------------------------

    def _check(self, fn: FuncNode, call: ast.Call, table
               ) -> Iterator[Finding]:
        rel = self._rel(fn)
        launch_hop = chain_hop(rel, call.lineno, "cuda_build.launch")
        args = {n: (call.args[i] if i < len(call.args) else None)
                for i, n in enumerate(_LAUNCH_ARGS)}
        for kw in call.keywords:
            if kw.arg in args:
                args[kw.arg] = kw.value
        for ctx in self._contexts(fn, 0):
            sites = [chain_hop(*s) for s in ctx.sites]
            trail = [launch_hop] + sites
            # the call site that fixes this path's arguments: the
            # outermost one, else the launch itself
            where = ctx.sites[-1] if ctx.sites else (rel, call.lineno, "")
            lib = self._resolve_str(fn, args["name"], ctx)
            entry = self._resolve_str(fn, args["entry"], ctx)
            inputs = self._resolve_seq(fn, args["inputs"], ctx)
            ints = self._resolve_seq(fn, args["ints"], ctx)
            operands = [("out", (fn, args["out"], ctx))]
            operands += [(f"input {i}", op)
                         for i, op in enumerate(inputs or ())]
            for what, (ofn, expr, octx) in operands:
                proof: List[str] = []
                if expr is not None and self._prove(ofn, expr, octx, proof,
                                                    0, set()):
                    continue
                try:
                    src = ast.unparse(expr) if expr is not None else "?"
                except Exception:
                    src = "<operand>"
                if len(src) > 48:
                    src = src[:45] + "..."
                node = expr if expr is not None else call
                yield self.finding(
                    self._info(ofn), node,
                    f"{what} of a launch of '{entry or '?'}' ('{src}' in "
                    f"'{ofn.qual}') is not proven int32 on the launch "
                    f"device — pass it through cuda_build.check_operands "
                    f"or build it with dtype=torch.int32, device=",
                    call_chain=trail[:6],
                    anchors=((rel, call.lineno),))
            message = self._count_problem(table, lib, entry, inputs, ints)
            if message is not None:
                info = self._project.modules[where[0]]
                yield Finding(
                    rule=self.id, file=where[0], line=where[1],
                    message=message, line_text=info.line_text(where[1]),
                    call_chain=tuple(trail[:6]),
                    anchors=((rel, call.lineno),))

    @staticmethod
    def _count_problem(table, lib, entry, inputs, ints) -> Optional[str]:
        if table is None:
            return ("cuda_build.ENTRY_POINTS is not a literal table — "
                    "launches cannot be checked against it")
        if lib is None or entry is None:
            return ("launch target (library, entry point) cannot be "
                    "resolved statically — pass string literals through "
                    "to cuda_build.launch")
        row = table.get(lib, {}).get(entry)
        if row is None:
            return (f"'{lib}.{entry}' is not an entry point of "
                    f"cuda_build.ENTRY_POINTS")
        if inputs is None or ints is None:
            return (f"launch of '{lib}.{entry}' passes a pointer or int "
                    f"list whose length cannot be resolved statically — "
                    f"ENTRY_POINTS declares {row[0]} pointers, {row[1]} "
                    f"ints")
        n_ptrs, n_ints = len(inputs) + 1, len(ints)
        if (n_ptrs, n_ints) != tuple(row):
            return (f"launch of '{lib}.{entry}' passes {n_ptrs} pointers "
                    f"and {n_ints} ints; cuda_build.ENTRY_POINTS declares "
                    f"{row[0]} and {row[1]} — ctypes shifts every "
                    f"argument after the difference")
        return None

    # -- call paths --------------------------------------------------------

    def _rel(self, fn: FuncNode) -> str:
        return self._project.graphs[fn.module].info.relpath

    def _info(self, fn: FuncNode) -> ModuleInfo:
        return self._project.graphs[fn.module].info

    def _contexts(self, fn: FuncNode, depth: int) -> List[_Ctx]:
        """One _Ctx per call path into fn that binds its parameters,
        outward through the callers while parameters stay unbound."""
        if depth >= 3:
            return [_Ctx()]
        callers = sorted(self._rev.get(fn.fid, ()))
        if not callers:
            return [_Ctx()]
        params = self._params(fn)
        out: List[_Ctx] = []
        for cfid in callers:
            caller = self._project.calls.functions[cfid]
            for site in self._project.calls.callees(cfid):
                if site.callee != fn.fid:
                    continue
                bound = self._bind(fn, site.node, params)
                for outer in self._contexts(caller, depth + 1):
                    binds = {p: (caller, e, outer) for p, e in bound.items()}
                    out.append(_Ctx(binds, ((self._rel(caller),
                                             site.lineno, fn.qual),)
                                    + outer.sites))
        return out or [_Ctx()]

    @staticmethod
    def _params(fn: FuncNode) -> List[str]:
        a = fn.node.args
        return [x.arg for x in (a.posonlyargs + a.args)
                if x.arg not in ("self", "cls")]

    @staticmethod
    def _bind(fn: FuncNode, call: ast.Call, params: List[str]
              ) -> Dict[str, Optional[ast.AST]]:
        """param -> argument expression at this call (None: unknowable,
        e.g. behind a *splat); a param left out takes its default."""
        out: Dict[str, Optional[ast.AST]] = {}
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                for p in params[i:]:
                    out[p] = None
                break
            if i < len(params):
                out[params[i]] = a
        for kw in call.keywords:
            if kw.arg is None:
                for p in params:
                    out.setdefault(p, None)
            elif kw.arg in params:
                out[kw.arg] = kw.value
        return out

    def _lookup(self, fn: FuncNode, name: str, ctx: _Ctx):
        """(fn, expr, ctx) that defines `name` in fn on this path: the
        caller's argument, the parameter's default, or the last simple
        local assignment; None when none is known."""
        if name in ctx.binds:
            caller, expr, cctx = ctx.binds[name]
            return None if expr is None else (caller, expr, cctx)
        a = fn.node.args
        pos = a.posonlyargs + a.args
        defaults = dict(zip([x.arg for x in pos[len(pos) - len(a.defaults):]],
                            a.defaults))
        defaults.update({x.arg: d for x, d in zip(a.kwonlyargs, a.kw_defaults)
                         if d is not None})
        if name in defaults and name not in self._assigned(fn):
            return fn, defaults[name], _Ctx()
        last = None
        for stmt in ast.walk(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == name:
                if last is None or stmt.lineno > last.lineno:
                    last = stmt
        if last is not None:
            return fn, last.value, ctx
        return None

    @staticmethod
    def _assigned(fn: FuncNode) -> Set[str]:
        return {t.id for s in ast.walk(fn.node) if isinstance(s, ast.Assign)
                for t in s.targets if isinstance(t, ast.Name)}

    def _resolve_str(self, fn, expr, ctx, depth=0) -> Optional[str]:
        if expr is None or depth > self._MAX_DEPTH:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            got = self._lookup(fn, expr.id, ctx)
            if got is not None:
                return self._resolve_str(*got, depth + 1)
        return None

    def _resolve_seq(self, fn, expr, ctx, depth=0):
        """The elements of a tuple/list expression on this path, each as
        (fn, expr, ctx), splicing *starred parts; None when unknown."""
        if expr is None or depth > self._MAX_DEPTH:
            return None
        if isinstance(expr, (ast.Tuple, ast.List)):
            out = []
            for e in expr.elts:
                if isinstance(e, ast.Starred):
                    inner = self._resolve_seq(fn, e.value, ctx, depth + 1)
                    if inner is None:
                        return None
                    out.extend(inner)
                else:
                    out.append((fn, e, ctx))
            return out
        if isinstance(expr, ast.Name):
            got = self._lookup(fn, expr.id, ctx)
            if got is not None:
                return self._resolve_seq(*got, depth + 1)
        return None

    # -- the prover ----------------------------------------------------------

    def _prove(self, fn: FuncNode, expr: ast.AST, ctx: _Ctx,
               trail: List[str], depth: int, visiting: Set[tuple]) -> bool:
        if depth > self._MAX_DEPTH:
            return False
        if isinstance(expr, ast.Subscript):
            return self._prove(fn, expr.value, ctx, trail, depth + 1,
                               visiting)
        if isinstance(expr, ast.IfExp):
            return all(self._prove(fn, e, ctx, trail, depth + 1, visiting)
                       for e in (expr.body, expr.orelse))
        if isinstance(expr, (ast.Tuple, ast.List)):
            return bool(expr.elts) and all(
                self._prove(fn, e, ctx, trail, depth + 1, visiting)
                for e in expr.elts)
        if isinstance(expr, ast.Name):
            if self._checked(fn, expr.id, 0):
                trail.append(chain_hop(self._rel(fn), fn.node.lineno,
                                       f"check_operands({expr.id})"))
                return True
            vkey = (fn.fid, expr.id, id(ctx))
            if vkey in visiting:
                return False
            visiting.add(vkey)
            try:
                got = self._lookup(fn, expr.id, ctx)
                if got is None:
                    return False
                return self._prove(*got, trail, depth + 1, visiting)
            finally:
                visiting.discard(vkey)
        if isinstance(expr, ast.Call):
            return self._prove_call(fn, expr, ctx, trail, depth, visiting)
        return False

    def _prove_call(self, fn, call, ctx, trail, depth, visiting) -> bool:
        d = _dotted(call.func) or ""
        kws = {kw.arg: kw.value for kw in call.keywords}
        if d.startswith("torch.") and "dtype" in kws:
            if _dotted(kws["dtype"]) in _INT32 and "device" in kws:
                trail.append(chain_hop(self._rel(fn), call.lineno,
                                       f"{d}(dtype=int32, device=)"))
                return True
            return False
        if d in _KEEPING_FUNCS:
            # the tensor, or the list of tensors of stack/cat
            return bool(call.args) and self._prove(
                fn, call.args[0], ctx, trail, depth + 1, visiting)
        if isinstance(call.func, ast.Attribute) and call.func.attr == "to":
            dtype = kws.get("dtype") or next(
                (x for x in call.args if _is_dtype_expr(x)), None)
            moved = "device" in kws or any(not _is_dtype_expr(x)
                                           for x in call.args)
            if _dotted(dtype) in _INT32 and moved:
                trail.append(chain_hop(self._rel(fn), call.lineno,
                                       ".to(device, int32)"))
                return True
            return False
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _KEEPING_METHODS:
            if call.func.attr == "view" and call.args \
                    and _is_dtype_expr(call.args[0]):
                return False
            return self._prove(fn, call.func.value, ctx, trail, depth + 1,
                               visiting)
        site = next((s for s in self._project.calls.callees(fn.fid)
                     if s.node is call), None)
        if site is not None:
            callee = self._project.calls.functions[site.callee]
            if self._fn_pins(callee, depth + 1, visiting):
                trail.append(chain_hop(self._rel(callee), callee.node.lineno,
                                       f"{callee.qual}() pins int32"))
                return True
        return False

    def _fn_pins(self, fn: FuncNode, depth: int, visiting: Set[tuple]
                 ) -> bool:
        """True when every return of fn is proven whatever its inputs."""
        if fn.fid in self._pins_memo:
            return self._pins_memo[fn.fid]
        vkey = ("pins", fn.fid)
        if vkey in visiting or depth > self._MAX_DEPTH:
            return False
        visiting.add(vkey)
        returns = [r.value for r in _own_returns(fn.node)
                   if r.value is not None]
        ok = bool(returns) and all(
            self._prove(fn, r, _Ctx(), [], depth + 1, visiting)
            for r in returns)
        visiting.discard(vkey)
        self._pins_memo[fn.fid] = ok
        return ok

    def _checked(self, fn: FuncNode, name: str, depth: int) -> bool:
        """fn passes `name` to cuda_build.check_operands, directly or
        through a project helper that checks the parameter it lands in."""
        key = (fn.fid, name)
        if key in self._checked_memo:
            return self._checked_memo[key]
        self._checked_memo[key] = False          # recursion cut
        ok = False
        sites = {id(s.node): s.callee
                 for s in self._project.calls.callees(fn.fid)}
        for call in _own_calls(fn.node):
            leaf = (_dotted(call.func) or "").split(".")[-1]
            if leaf == "check_operands":
                if any(isinstance(n, ast.Name) and n.id == name
                       for a in call.args for n in ast.walk(a)):
                    ok = True
                    break
                continue
            callee_fid = sites.get(id(call))
            if callee_fid is None or depth >= 3:
                continue
            callee = self._project.calls.functions[callee_fid]
            for p, e in self._bind(callee, call,
                                   self._params(callee)).items():
                if isinstance(e, ast.Name) and e.id == name \
                        and self._checked(callee, p, depth + 1):
                    ok = True
                    break
            if ok:
                break
        self._checked_memo[key] = ok
        return ok


# ---------------------------------------------------------------------------
# Value-level dataflow rules (drynx_tpu_torch/analysis/dataflow.py): both are
# thin wrappers over one shared engine run — dataflow_for() memoizes on a
# content-hash fingerprint of the whole project, so the abstract
# interpreter executes once per tree version no matter how many rules (or
# repeated analyze_project calls) consume it.

def _raw_to_finding(rule_id: str, project: ProjectInfo, raw) -> Finding:
    mod = project.modules.get(raw.file)
    return Finding(rule=rule_id, file=raw.file, line=raw.line,
                   message=raw.message,
                   line_text=mod.line_text(raw.line) if mod else "",
                   call_chain=raw.chain, anchors=raw.anchors)


@register
class CiphertextDtypeLaunder(ProjectRule):
    """A ciphertext limb tensor that was provably int32 (or a uint32
    boundary array) loses the dtype (``.float()``, ``.to(torch.float32)``,
    ``astype(float32)``, float-constant arithmetic, true division — often
    hidden inside a flatten/transform/unflatten round trip) and then
    reaches ``cuda_build.launch``, a kernel wrapper or a serialization
    point. The kernels compute exact Montgomery limb arithmetic: one
    float hop silently corrupts carries and changes the proof
    transcript. The finding renders the whole value-flow chain (pin site,
    laundering hop, sink) and is suppressible at any hop; re-pinning with
    ``.to(torch.int32)`` at the boundary clears the taint, and
    ``# drynx: declassify[dtype]`` marks deliberate byte-packing."""

    id = "ciphertext-dtype-launder"
    engine = "dataflow"
    group = "adapted"
    summary = ("int32 limb value reaches a launch, a kernel wrapper or "
               "serialization after a dtype-laundering hop (value "
               "dataflow)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .dataflow import dataflow_for
        df = dataflow_for(project, getattr(project, "focus", None))
        for raw in df.dtype_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class SecretFlowToSink(ProjectRule):
    """The dataflow successor to the regex ``secret-logging`` rule:
    secrecy is seeded at *definition sites* — ``keygen()`` (ElGamal
    secret), ``secrets.randbelow()`` (Schnorr nonce), DP cleartext loads —
    and propagated per value through assignments, tuples, dataclass
    fields, f-strings and interprocedural summaries. It fires when a
    secret value reaches ``print``/``log.*``/TOML-or-serialized
    output/exception messages/transport ``send`` calls, with the full
    value-flow chain rendered. Where the regex rule flags the same line,
    this finding absorbs it (one leak, one report). Deliberate key-store
    writes are ``noqa``'d with a reason; protocol outputs that are public
    by construction are marked ``# drynx: declassify[secret]`` at the
    defining assignment."""

    id = "secret-flow-to-sink"
    engine = "dataflow"
    summary = ("secret value (keygen/nonce/DP cleartext) reaches a "
               "log/print/serialization/exception/send sink (value "
               "dataflow)")
    absorbs = ("secret-logging",)

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .dataflow import dataflow_for
        df = dataflow_for(project, getattr(project, "focus", None))
        for raw in df.secret_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


# ---------------------------------------------------------------------------
# Concurrency rules (drynx_tpu_torch/analysis/concurrency.py): three thin
# wrappers over one shared engine run — concurrency_for() memoizes on the
# same content-hash fingerprint as the dataflow engine, so thread-entry
# discovery, the interprocedural lock-set walk and the lock-order graph
# are computed once per tree version for all three rules (and for the
# DRYNX_LOCK_TRACE runtime cross-check).

@register
class UnguardedSharedMutation(ProjectRule):
    """A module global, class attribute or shared container is mutated
    from two concurrent contexts (thread targets, executor submissions,
    ``fan_out`` worker callables, timers — or one multi-instance entry
    racing with itself) and the lock sets provably held at the mutation
    sites share no common lock. That is the textbook data race: lost
    counter increments, torn dict updates, iteration-during-mutation.
    The finding names every mutating context and the locks each holds;
    it is suppressible at the mutation site *or* at the thread entry
    (dual anchors). Fix by guarding all mutating paths with one named
    lock (see ``resilience.policy.named_lock``)."""

    id = "unguarded-shared-mutation"
    engine = "concurrency"
    summary = ("shared state mutated from multiple thread contexts with "
               "no common lock held (interprocedural lock-set analysis)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .concurrency import concurrency_for
        cc = concurrency_for(project)
        for raw in cc.unguarded_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class LockOrderInversion(ProjectRule):
    """Two locks are acquired in opposite nesting orders on different
    code paths — the classic ABBA deadlock: each thread holds one lock
    and blocks forever waiting for the other. The engine records every
    nested acquisition (``with`` or bare ``acquire()``) per thread entry,
    unions the edges into a lock-order graph over the stable diagnostic
    lock names, and reports each cycle once with the full acquisition
    chain rendered as a SARIF codeFlow (one threadFlow location per
    hop). Re-entering an ``RLock`` already held is not an edge. Fix by
    picking one global order (document it next to the named_lock defs)
    or collapsing to a single lock."""

    id = "lock-order-inversion"
    engine = "concurrency"
    summary = ("named locks acquired in conflicting order on different "
               "paths — ABBA deadlock cycle in the lock-order graph")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .concurrency import concurrency_for
        cc = concurrency_for(project)
        for raw in cc.cycle_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class BlockingCallUnderLock(ProjectRule):
    """A blocking operation — socket/frame I/O (``recv_msg``,
    ``send_frame``, ``sendall``...), ``time.sleep``, subprocess spawns,
    a bare ``join()`` — is reachable while a lock is held. Under load
    every thread contending on that lock serializes behind the wait:
    with the proof-device lock or a ConnPool lock this invisibly
    flattens the serving tier to one in-flight operation. The finding
    carries the interprocedural path from the thread entry to the call.
    Fix by moving the wait outside the critical section (snapshot under
    the lock, operate after release); where the serialization *is* the
    design — e.g. a per-connection lock serializing one socket
    conversation — suppress at the site with a reason."""

    id = "blocking-call-under-lock"
    engine = "concurrency"
    summary = ("socket/sleep/subprocess/join reachable while holding a "
               "lock — serializes every contending thread")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .concurrency import concurrency_for
        cc = concurrency_for(project)
        for raw in cc.blocking_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


# ---------------------------------------------------------------------------
# Determinism rules (drynx_tpu_torch/analysis/determinism.py): two thin
# wrappers over one shared nondeterminism-taint run — determinism_for()
# memoizes on the same content-hash fingerprint, so the interprocedural
# source->sink walk is computed once per tree version for both rules
# (and for the DRYNX_DET_TRACE runtime cross-check).

@register
class NondetFlowToTranscript(ProjectRule):
    """A nondeterministic *value* — a wall-clock read, unseeded RNG
    draw, or object identity (``id()``/``hash()`` under hash
    randomization) — flows into a byte-identity sink: transcript
    serialization, a digest, a ProofDB/``pane:``/``ckpt:`` write, a
    skipchain append, a wire v2 frame encode, or an fsync'd journal
    line. Those surfaces back the repo's byte-identical-transcript
    equivalence claims, so any such flow makes two same-seed runs
    diverge. The finding carries the full source->sink chain as a
    SARIF codeFlow with dual anchors (suppressible at the source or
    the sink). Fix by deriving the value from survey inputs (seeded
    ``fold_in``); a *deliberate* nondeterministic surface — e.g. a
    block's wall-clock ``sample_time``, excluded from the transcript
    by design — is declared with ``# drynx: deterministic[reason]``
    at the source line."""

    id = "nondet-flow-to-transcript"
    engine = "determinism"
    summary = ("wall-clock/RNG/identity value flows into a "
               "byte-identity sink (transcript, digest, ProofDB, "
               "skipchain, wire encode, journal)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .determinism import determinism_for
        det = determinism_for(project, getattr(project, "focus", None))
        for raw in det.nondet_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class UnorderedIterationAtSink(ProjectRule):
    """Bytes reach a byte-identity sink in a nondeterministic *order*:
    a value derived from an unsorted directory listing, a ``set``'s
    iteration order, or thread-completion order (``as_completed``) is
    written to a sink — or the sink call itself sits inside a loop
    over such an iterate, so the write sequence varies run to run even
    though each individual write is deterministic. Fix by sorting the
    iterate (``sorted(...)`` with a total key), canonicalizing
    (``canon_points``/``fold_cts``), or gathering into an
    index-addressed structure (the roster-order ``fan_out`` result
    list) before serializing."""

    id = "unordered-iteration-at-sink"
    engine = "determinism"
    summary = ("listing/set/thread-completion order reaches a "
               "byte-identity sink — write order varies run to run")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .determinism import determinism_for
        det = determinism_for(project, getattr(project, "focus", None))
        for raw in det.unordered_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)

# ---------------------------------------------------------------------------
# Typestate rules (drynx_tpu_torch/analysis/typestate.py): four thin wrappers
# over one shared resource-lifecycle run — typestate_for() memoizes on
# the same content-hash fingerprint, so the interprocedural automaton
# walk (instance tracking through parameters, returns, aliases, branch
# joins and try/finally edges) is computed once per tree version for
# all four protocols (and for the DRYNX_PROTO_TRACE runtime cross-check).

@register
class AtomicDurableWrite(ProjectRule):
    """A durable artifact (ledger/journal/checkpoint/bench/slab/.npz
    path) is written without the crash-consistent tmp-write -> fsync ->
    rename protocol: an in-place ``open(final, "w")``, a rename before
    the data hit the disk (no ``os.fsync`` between the last write and
    the publish), a write after the file was already published, or a
    tmp file that is flushed but never renamed into place. Any of these
    can leave a torn or missing artifact after a crash — the pool
    store's replay and the proof transcript both assume publishes are
    all-or-nothing. Append-mode opens of durable paths are only legal
    in modules that declare a replay routine (the journal idiom).
    Fix with the ``_atomic_write_npz`` shape; a deliberately relaxed
    write (scratch diagnostics) is declared with
    ``# drynx: protocol[reason]`` at the open or the violation site."""

    id = "atomic-durable-write"
    engine = "typestate"
    summary = ("durable-path write skips the tmp-write -> fsync -> "
               "rename crash-consistency protocol (typestate)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .typestate import typestate_for
        ts = typestate_for(project, getattr(project, "focus", None))
        for raw in ts.atomic_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class SlabConsumptionOrder(ProjectRule):
    """A claimed pool slab (the ``os.rename`` claim-move that fences
    out concurrent consumers) is consumed out of order: read before its
    consumption was journaled in the fsync'd ledger, unlinked before it
    was read, or claimed and then leaked without the final unlink. The
    ledger append IS the commit point — a crash between claim and
    append must leave evidence for replay, so reading or deleting
    first reintroduces the double-spend/lost-slab windows the pool
    store's recovery protocol exists to close. The required order is
    claim-rename -> ledger append -> read -> unlink, machine-checked
    per instance across calls and exception edges."""

    id = "slab-consumption-order"
    engine = "typestate"
    summary = ("claimed slab read/unlinked before the fsync'd ledger "
               "append, or never unlinked (typestate)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .typestate import typestate_for
        ts = typestate_for(project, getattr(project, "focus", None))
        for raw in ts.slab_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class ConnCheckoutDiscipline(ProjectRule):
    """A connection checked out of a ``ConnPool`` (or constructed
    directly) fails to reach exactly one terminal — ``put``/``discard``
    back to the pool or ``close`` — on some path, including exception
    edges: a return/raise that abandons the socket, or a conn that a
    transport failure (``CallTimeout``/``TransportError``/``OSError``
    handler) marked suspect being reused or returned to the pool as if
    healthy. Leaks starve the pool under load; returning a suspect
    conn poisons a later checkout with a dead socket. The walker
    tracks each instance through helper calls, aliases and
    try/finally, so release-in-a-helper and retry-loop idioms are
    recognized; the finding's codeFlow shows the path that leaks."""

    id = "conn-checkout-discipline"
    engine = "typestate"
    summary = ("pool conn misses put/discard/close on some path, or is "
               "reused after a transport failure (typestate)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .typestate import typestate_for
        ts = typestate_for(project, getattr(project, "focus", None))
        for raw in ts.conn_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)


@register
class SealCommitOnce(ProjectRule):
    """A streaming pane is sealed twice under one pane key, a pane's
    proof blob is committed twice, or a checkpoint loaded for resume is
    saved again without re-entering a phase (a blind save would
    overwrite the resume evidence — the ``phase_entries`` counters —
    with stale state). Seal and commit are at-most-once per instance
    per path: the VN verify cache and the epsilon ledger both key on
    the pane identity, so a double seal double-charges and a double
    commit forks the audit trail. The checkpoint clause enforces
    load -> enter -> save ordering per ``SurveyCheckpoint`` instance."""

    id = "seal-commit-once"
    engine = "typestate"
    summary = ("pane sealed/committed twice under one key, or a "
               "resumed checkpoint saved without re-entering a phase "
               "(typestate)")

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        from .typestate import typestate_for
        ts = typestate_for(project, getattr(project, "focus", None))
        for raw in ts.seal_raw:
            if project.in_focus(raw.file):
                yield _raw_to_finding(self.id, project, raw)

