"""AST lint framework enforcing the port's torch/CUDA/crypto invariants.

Drynx's security argument rests on every node computing over ciphertexts
correctly; in the port the equivalent hazards are *silent* Python/torch
bug classes — raw ``pickle.loads`` on attacker-controlled proof bytes,
implicit-dtype tensors corrupting int32 limb arithmetic, a ctypes launch
whose pointers do not match the kernel's C signature. The rules in
:mod:`.rules` mechanically block those classes so later changes can refactor
the crypto freely.

Framework pieces:

* :class:`Finding` — one violation, ``file:line`` + rule id + message.
* :class:`Rule` + :func:`register` — the rule registry (:data:`RULES`).
* :class:`ModuleInfo` — parsed file + the shared derived facts rules need
  (the ``cuda_build.launch`` call sites and the functions that make them).
* inline suppression — ``# drynx: noqa[rule-id]`` (or bare ``noqa`` for all
  rules) on the offending line.
* baseline — ``drynx_tpu_torch/analysis/lint_baseline.json`` grandfathers
  pre-existing findings. Entries are keyed on (rule, file, stripped line
  text) rather than line numbers so unrelated edits don't invalidate
  them; each carries a ``why``.

No torch import here: the analyzer must run (and fail loudly) even on a
box without the CUDA stack.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# Repo root = parent of the drynx_tpu_torch package (this file is
# drynx_tpu_torch/analysis/core.py). Baseline keys and reported paths are
# relative to it so results are stable regardless of the caller's cwd.
REPO_ROOT = Path(__file__).resolve().parents[2]

_NOQA_RE = re.compile(r"#\s*drynx:\s*noqa(?:\[([A-Za-z0-9_,\- ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # posix path relative to REPO_ROOT when possible
    line: int          # 1-based
    message: str
    line_text: str     # stripped source line (baseline key component)
    # Project-rule extras. call_chain renders the path that made the finding
    # fire ("file:line:symbol" hops — import chain for flag taint, call
    # chain for transitive host syncs, dtype-proof trail for launch
    # operands). anchors are extra (file, line) suppression points: a
    # callgraph finding is suppressible at the sync site OR the launch
    # entry.
    call_chain: Tuple[str, ...] = ()
    anchors: Tuple[Tuple[str, int], ...] = ()

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.line_text)

    def render(self) -> str:
        out = f"{self.file}:{self.line}: [{self.rule}] {self.message}"
        if self.call_chain:
            out += "\n    call chain: " + " -> ".join(self.call_chain)
        return out

    def to_json(self) -> Dict[str, object]:
        """Stable JSON shape for --format json (call_chain always a list)."""
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "line_text": self.line_text,
                "call_chain": list(self.call_chain)}


class Rule:
    """Base class: subclasses set ``id``/``summary`` and implement run()."""

    id: str = ""
    summary: str = ""
    project = False    # ProjectRule flips this; --list-rules marks it
    engine = "lint"    # which analysis engine backs the rule; --list-rules
    #                    groups by it (lint/project/dataflow/concurrency/
    #                    determinism/typestate)
    seed_only = False  # kept as a seed list for a dataflow successor rule
    # how the rule relates to the reference analyzer's rule set:
    # kept | adapted | replaced (``replaces`` names the reference rule)
    group = "kept"
    replaces = ""
    absorbs: Tuple[str, ...] = ()  # rule ids this rule's findings dedupe

    def run(self, mod: "ModuleInfo") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: "ModuleInfo", node: ast.AST, message: str,
                call_chain: Sequence[str] = (),
                anchors: Sequence[Tuple[str, int]] = ()) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=self.id, file=mod.relpath, line=line,
                       message=message, line_text=mod.line_text(line),
                       call_chain=tuple(call_chain), anchors=tuple(anchors))


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    RULES[rule.id] = rule
    return cls


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_launch_call(call: ast.Call, aliases: Set[str] = frozenset()) -> bool:
    """True for a call of utils/cuda_build.launch: ``cuda_build.launch(...)``
    through any module path, or a name imported from cuda_build."""
    d = _dotted(call.func) or ""
    parts = d.split(".")
    if len(parts) >= 2 and parts[-2:] == ["cuda_build", "launch"]:
        return True
    return len(parts) == 1 and parts[0] in aliases


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound inside the function (params + assignment targets),
    used to tell a captured module global from a local shadow."""
    bound: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        bound.add(a.arg)
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                            ast.For, ast.comprehension)):
            tgts = []
            if isinstance(sub, ast.Assign):
                tgts = sub.targets
            elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                tgts = [sub.target]
            elif isinstance(sub, ast.For):
                tgts = [sub.target]
            else:
                tgts = [sub.target]
            for t in tgts:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        bound.add(n.id)
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and sub is not fn:
            bound.add(sub.name)
        elif isinstance(sub, ast.Global):
            bound.difference_update(sub.names)
    return bound


class ModuleInfo:
    """One parsed source file + the derived facts the rules share."""

    def __init__(self, source: str, relpath: str):
        self.source = source
        self.relpath = relpath
        self.lines = source.splitlines()
        self.content_hash = hashlib.sha256(source.encode("utf-8")).hexdigest()
        self.tree = ast.parse(source)
        self._analyze()

    # -- derived facts ----------------------------------------------------

    def _analyze(self) -> None:
        self.functions: List[ast.AST] = [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

        # Local names bound to utils/cuda_build.launch by a
        # `from ...cuda_build import launch [as x]`.
        self.launch_aliases: Set[str] = {
            a.asname or a.name
            for n in ast.walk(self.tree) if isinstance(n, ast.ImportFrom)
            and (n.module or "").split(".")[-1] == "cuda_build"
            for a in n.names if a.name == "launch"}

        # Functions that call cuda_build.launch: the kernel wrappers'
        # launch helpers. One DFS over the module with an
        # enclosing-function stack (re-walking every function subtree is
        # quadratic under nesting); the innermost enclosing function is
        # the one whose body launches.
        launch_set: Set[ast.AST] = set()
        self.launch_calls: List[ast.Call] = []

        def _scan(node: ast.AST, stack: Tuple[ast.AST, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Call) \
                        and is_launch_call(child, self.launch_aliases):
                    self.launch_calls.append(child)
                    if stack:
                        launch_set.add(stack[-1])
                if isinstance(child,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _scan(child, stack + (child,))
                else:
                    _scan(child, stack)

        _scan(self.tree, ())
        self.launch_functions = [f for f in self.functions
                                 if f in launch_set]

        # Module-level simple assignments: name -> [assign nodes]
        self.module_assigns: Dict[str, List[ast.Assign]] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_assigns.setdefault(t.id, []).append(node)

    # -- helpers ----------------------------------------------------------

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def noqa_match(self, rule: str, line: int) -> bool:
        raw = ""
        if 1 <= line <= len(self.lines):
            raw = self.lines[line - 1]
        m = _NOQA_RE.search(raw)
        if not m:
            return False
        if m.group(1) is None:
            return True
        allowed = {r.strip() for r in m.group(1).split(",")}
        return rule in allowed

    def suppressed(self, finding: Finding) -> bool:
        if self.noqa_match(finding.rule, finding.line):
            return True
        # same-file extra anchors (launch entry of a callgraph finding)
        return any(file == self.relpath and self.noqa_match(finding.rule, ln)
                   for file, ln in finding.anchors)


# ---------------------------------------------------------------------------
# Scanning
# ---------------------------------------------------------------------------

# Parse results are cached on (content sha256, relpath): the per-module pass
# and the project pass (and repeated runs in one process, e.g. the test
# suite) share one ModuleInfo per file version instead of re-parsing.
_INFO_CACHE: Dict[Tuple[str, str], "ModuleInfo"] = {}
_INFO_CACHE_MAX = 4096


def module_info_for(source: str, relpath: str) -> "ModuleInfo":
    """ModuleInfo for (source, relpath), memoized on the content hash.
    Raises SyntaxError like the constructor."""
    key = (hashlib.sha256(source.encode("utf-8")).hexdigest(), relpath)
    info = _INFO_CACHE.get(key)
    if info is None:
        if len(_INFO_CACHE) >= _INFO_CACHE_MAX:
            _INFO_CACHE.clear()
        info = ModuleInfo(source, relpath)
        _INFO_CACHE[key] = info
    return info


def suppressed_at(finding: Finding, modules: Dict[str, "ModuleInfo"]) -> bool:
    """True when a noqa for the rule sits on the finding line OR on any of
    its extra anchors (e.g. the launch entry of a callgraph finding)."""
    for file, line in ((finding.file, finding.line), *finding.anchors):
        mod = modules.get(file)
        if mod is not None and mod.noqa_match(finding.rule, line):
            return True
    return False


def _rel(path: Path) -> str:
    p = path.resolve()
    try:
        return p.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return p.as_posix()


def iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def analyze_source(source: str, relpath: str,
                   rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run (a subset of) the rules over one source string. Test entrypoint;
    also the per-file worker for analyze_paths."""
    from . import rules as _rules  # noqa: F401  (side effect: registration)

    try:
        mod = module_info_for(source, relpath)
    except SyntaxError as e:
        return [Finding(rule="parse-error", file=relpath,
                        line=e.lineno or 1,
                        message=f"file does not parse: {e.msg}",
                        line_text="")]
    selected = (RULES.values() if rules is None
                else [RULES[r] for r in rules])
    out: List[Finding] = []
    for rule in selected:
        for f in rule.run(mod):
            if not mod.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.file, f.line, f.rule))
    return out


def analyze_paths(paths: Sequence[Path],
                  rules: Optional[Iterable[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            source = path.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(
                rule="parse-error", file=_rel(path), line=1,
                message=f"unreadable file: {e}", line_text=""))
            continue
        findings.extend(analyze_source(source, _rel(path), rules=rules))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BaselineEntry:
    rule: str
    file: str
    line_text: str
    count: int
    why: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.line_text)


def load_baseline(path: Path) -> List[BaselineEntry]:
    path = Path(path)
    if not path.exists():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = []
    for e in data.get("entries", []):
        entries.append(BaselineEntry(
            rule=e["rule"], file=e["file"], line_text=e["line_text"],
            count=int(e.get("count", 1)), why=e.get("why", "")))
    return entries


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[BaselineEntry],
                   ) -> Tuple[List[Finding], int, List[BaselineEntry]]:
    """Returns (unbaselined findings, #matched, stale entries).

    A stale entry matched fewer findings than its count — the debt it
    grandfathers no longer exists and the entry should be pruned.
    """
    budget: Dict[Tuple[str, str, str], int] = {}
    for e in baseline:
        budget[e.key()] = budget.get(e.key(), 0) + e.count
    remaining = dict(budget)
    unmatched: List[Finding] = []
    matched = 0
    for f in findings:
        if remaining.get(f.key(), 0) > 0:
            remaining[f.key()] -= 1
            matched += 1
        else:
            unmatched.append(f)
    stale: List[BaselineEntry] = []
    for e in baseline:
        if remaining.get(e.key(), 0) > 0:
            stale.append(e)
            remaining[e.key()] = 0
    return unmatched, matched, stale
