"""Whole-program graphs for the project-level lint rules.

Two structures, both pure-``ast`` (no torch import, same contract as the rest
of :mod:`drynx_tpu_torch.analysis`):

* **import graph** — per module, where each local name came from:
  ``from x import y [as z]`` bindings and ``import x.y [as z]`` module
  aliases, with relative imports resolved against the module's package.
  ``resolve_import`` follows re-export chains (``a`` imports from ``b``
  which imports from ``c``) to the *defining* module, returning the hop
  list so findings can render the chain.

* **callgraph** — edges between module-level (and nested) functions:
  direct ``f()`` calls, ``mod.f()`` calls through module aliases and
  ``self.m()`` method calls within a class; and the *launch entries*: the
  functions that call ``utils/cuda_build.launch`` (the kernel wrappers'
  launch helpers) and every function that reaches one through the
  callgraph (the wrappers of ``crypto/cuda_ops.py`` and
  ``crypto/cuda_pairing.py`` and their callers).

Both are deliberately approximate (a linter, not an interpreter): unknown
receivers, dynamic dispatch and star-imports resolve to nothing rather
than to everything.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import ModuleInfo, _dotted

def module_name(relpath: str) -> str:
    """Dotted module name for a repo-relative posix path.
    ``a/b/c.py`` -> ``a.b.c``; ``a/b/__init__.py`` -> ``a.b``."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


@dataclasses.dataclass(frozen=True)
class ImportBinding:
    """Local name <- (module, name) from a ``from module import name``."""
    target_module: str
    target_name: str
    lineno: int


@dataclasses.dataclass(frozen=True)
class ModuleAlias:
    """Local alias <- module from an ``import module [as alias]``."""
    target_module: str
    lineno: int


@dataclasses.dataclass
class FuncNode:
    module: str                 # dotted module name
    qual: str                   # dotted nesting, e.g. "Cls.m" or "outer.inner"
    node: ast.AST               # FunctionDef / AsyncFunctionDef

    @property
    def fid(self) -> str:
        return f"{self.module}:{self.qual}"


class ModuleGraph:
    """Per-module slice of the graphs: import bindings + function table."""

    def __init__(self, info: ModuleInfo, dotted: str, is_package: bool):
        self.info = info
        self.dotted = dotted
        self.is_package = is_package
        # local name -> binding (walked over the WHOLE tree: the repo
        # imports lazily inside functions to break cycles)
        self.froms: Dict[str, ImportBinding] = {}
        self.aliases: Dict[str, ModuleAlias] = {}
        self.functions: Dict[str, FuncNode] = {}       # qual -> node
        self.by_name: Dict[str, List[str]] = {}        # bare name -> [quals]
        self._collect_imports()
        self._collect_functions()

    # -- imports ----------------------------------------------------------

    def _package(self, level: int) -> Optional[str]:
        """Base package for a level-N relative import, or None if it
        escapes the scanned tree."""
        base = self.dotted if self.is_package else (
            self.dotted.rsplit(".", 1)[0] if "." in self.dotted else "")
        for _ in range(level - 1):
            if "." not in base:
                return base or None
            base = base.rsplit(".", 1)[0]
        return base or None

    def _collect_imports(self) -> None:
        for node in ast.walk(self.info.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = self._package(node.level)
                    if base is None:
                        continue
                    target = f"{base}.{node.module}" if node.module else base
                else:
                    target = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.froms.setdefault(
                        a.asname or a.name,
                        ImportBinding(target, a.name, node.lineno))
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases.setdefault(
                            a.asname, ModuleAlias(a.name, node.lineno))
                    else:
                        # `import a.b.c` binds the ROOT name `a`
                        root = a.name.split(".")[0]
                        self.aliases.setdefault(
                            root, ModuleAlias(root, node.lineno))

    # -- functions --------------------------------------------------------

    def _collect_functions(self) -> None:
        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    fn = FuncNode(self.dotted, qual, child)
                    self.functions[qual] = fn
                    self.by_name.setdefault(child.name, []).append(qual)
                    visit(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.info.tree, "")

    def lookup_function(self, name: str) -> Optional[FuncNode]:
        """Bare name -> the outermost function with that name, if any."""
        quals = self.by_name.get(name)
        if not quals:
            return None
        qual = min(quals, key=lambda q: (q.count("."), q))
        return self.functions[qual]


class ImportGraph:
    """Cross-module name resolution over the scanned module set."""

    def __init__(self, modules: Dict[str, ModuleGraph]):
        self.modules = modules
        # Dotted-suffix index: running the linter on a subtree (or the
        # fixture package) gives relpath-derived names like
        # `tests.fixtures.lintpkg.flags` while the sources say
        # `lintpkg.flags` — a unique suffix still resolves. Ambiguous
        # suffixes map to None.
        self._suffix: Dict[str, Optional[str]] = {}
        for name in modules:
            parts = name.split(".")
            for i in range(len(parts)):
                suf = ".".join(parts[i:])
                if suf in self._suffix and self._suffix[suf] != name:
                    self._suffix[suf] = None
                else:
                    self._suffix[suf] = name

    def canon(self, name: str) -> Optional[str]:
        """Canonical scanned-module name for a dotted import target:
        exact match, else unique dotted-suffix match, else None."""
        if name in self.modules:
            return name
        return self._suffix.get(name)

    def resolve(self, module: str, name: str,
                ) -> Tuple[str, str, List[Tuple[str, int]]]:
        """Follow ``from x import y`` chains from (module, name) to the
        defining module. Returns (def_module, def_name, hops) where hops
        are (module_relpath, import_lineno) pairs, outermost first. When
        the name is not an import binding (or leaves the scanned set),
        the walk stops at the last resolvable module."""
        hops: List[Tuple[str, int]] = []
        seen: Set[Tuple[str, str]] = set()
        while True:
            mg = self.modules.get(module)
            if mg is None or (module, name) in seen:
                return module, name, hops
            seen.add((module, name))
            b = mg.froms.get(name)
            if b is None:
                return module, name, hops
            hops.append((mg.info.relpath, b.lineno))
            target = self.canon(b.target_module)
            if target is None:
                return b.target_module, b.target_name, hops
            # `from pkg import mod` binds a submodule, not a symbol
            sub = self.canon(f"{target}.{b.target_name}")
            if sub is not None and \
                    b.target_name not in _symbols(self.modules[target]):
                return sub, "", hops
            module, name = target, b.target_name

    def module_for_alias(self, module: str, alias: str) -> Optional[str]:
        """Local alias -> dotted module it names (``import x.y as z`` or
        ``from pkg import mod``)."""
        mg = self.modules.get(module)
        if mg is None:
            return None
        a = mg.aliases.get(alias)
        if a is not None:
            return self.canon(a.target_module) or a.target_module
        b = mg.froms.get(alias)
        if b is not None:
            target = self.canon(b.target_module)
            if target is not None and \
                    b.target_name not in _symbols(self.modules[target]):
                sub = self.canon(f"{target}.{b.target_name}")
                return sub or f"{target}.{b.target_name}"
        return None


def _symbols(mg: ModuleGraph) -> Set[str]:
    """Names a module defines (assigns, functions, classes, imports)."""
    out = set(mg.info.module_assigns)
    out.update(mg.by_name)
    out.update(mg.froms)
    out.update(mg.aliases)
    for node in mg.info.tree.body:
        if isinstance(node, ast.ClassDef):
            out.add(node.name)
    return out


@dataclasses.dataclass(frozen=True)
class CallSite:
    caller: str                 # fid
    callee: str                 # fid
    node: ast.Call
    lineno: int


class CallGraph:
    """Function-level call edges + the launch-entry set."""

    def __init__(self, modules: Dict[str, ModuleGraph], imports: ImportGraph):
        self.modules = modules
        self.imports = imports
        self.functions: Dict[str, FuncNode] = {}
        for mg in modules.values():
            for fn in mg.functions.values():
                self.functions[fn.fid] = fn
        self.calls: Dict[str, List[CallSite]] = {}
        self._build_edges()
        # functions whose own body calls cuda_build.launch
        self.launchers: Set[str] = set()
        for mg in modules.values():
            launching = set(map(id, mg.info.launch_functions))
            for fn in mg.functions.values():
                if id(fn.node) in launching:
                    self.launchers.add(fn.fid)
        # the reverse callgraph: callee fid -> caller fids
        self.callers: Dict[str, Set[str]] = {}
        for caller, sites in self.calls.items():
            for s in sites:
                self.callers.setdefault(s.callee, set()).add(caller)
        # the kernel wrappers: the launchers and their direct callers (a
        # wrapper checks its operands, then hands them to its module's
        # launch helper); the launch entries: every function that
        # reaches a launcher
        self.wrappers: Set[str] = set(self.launchers).union(
            *(self.callers.get(f, ()) for f in self.launchers))
        self.launch_entries: Set[str] = set(self.launchers)
        queue = list(self.launchers)
        while queue:
            for caller in self.callers.get(queue.pop(), ()):
                if caller not in self.launch_entries:
                    self.launch_entries.add(caller)
                    queue.append(caller)

    # -- resolution -------------------------------------------------------

    def _resolve_name(self, mg: ModuleGraph, scope: Sequence[str],
                      name: str) -> Optional[FuncNode]:
        # nested def in an enclosing scope first, outermost module def next
        for depth in range(len(scope), 0, -1):
            qual = ".".join((*scope[:depth], name))
            if qual in mg.functions:
                return mg.functions[qual]
        fn = mg.lookup_function(name)
        if fn is not None and "." not in fn.qual:
            return fn
        # imported function (through any number of re-export hops)
        def_mod, def_name, _ = self.imports.resolve(mg.dotted, name)
        target = self.modules.get(def_mod)
        if target is not None and def_mod != mg.dotted:
            got = target.lookup_function(def_name)
            if got is not None and "." not in got.qual:
                return got
        return fn

    def _resolve_attribute(self, mg: ModuleGraph,
                           attr: ast.Attribute) -> Optional[FuncNode]:
        d = _dotted(attr)
        if not d:
            return None
        parts = d.split(".")
        # self.m() inside class C -> C.m in this module
        if parts[0] in ("self", "cls") and len(parts) == 2:
            for qual, fn in mg.functions.items():
                if qual.endswith(f".{parts[1]}") and qual.count(".") >= 1:
                    return fn
            return None
        # module alias: longest alias prefix, then a function in it
        for cut in range(len(parts) - 1, 0, -1):
            alias = ".".join(parts[:cut])
            if cut == 1:
                target = self.imports.module_for_alias(mg.dotted, alias) \
                    or self.imports.canon(alias)
            else:
                target = self.imports.canon(alias)
            if target is None:
                continue
            rest = parts[cut:]
            # absolute dotted path may include submodules: a.b.c.f
            while len(rest) > 1:
                nxt = self.imports.canon(f"{target}.{rest[0]}")
                if nxt is None:
                    break
                target, rest = nxt, rest[1:]
            tm = self.modules.get(target)
            if tm is not None and len(rest) == 1:
                got = tm.lookup_function(rest[0])
                if got is not None and "." not in got.qual:
                    return got
        return None

    def resolve_call(self, mg: ModuleGraph, scope: Sequence[str],
                     call: ast.Call) -> Optional[FuncNode]:
        if isinstance(call.func, ast.Name):
            return self._resolve_name(mg, scope, call.func.id)
        if isinstance(call.func, ast.Attribute):
            return self._resolve_attribute(mg, call.func)
        return None

    # -- edges ------------------------------------------------------------

    def _build_edges(self) -> None:
        for mg in self.modules.values():
            for fn in mg.functions.values():
                scope = tuple(fn.qual.split(".")[:-1])
                sites: List[CallSite] = []
                for call in _own_calls(fn.node):
                    callee = self.resolve_call(
                        mg, (*scope, fn.qual.split(".")[-1]), call)
                    if callee is not None and callee.fid != fn.fid:
                        sites.append(CallSite(fn.fid, callee.fid, call,
                                              call.lineno))
                if sites:
                    self.calls[fn.fid] = sites

    def callees(self, fid: str) -> List[CallSite]:
        return self.calls.get(fid, [])


def _own_calls(fn: ast.AST) -> Iterator[ast.Call]:
    """Call nodes lexically in fn's body, NOT descending into nested
    function/class definitions (those are their own callgraph nodes)."""
    def visit(node: ast.AST) -> Iterator[ast.Call]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from visit(child)

    yield from visit(fn)


def _own_returns(fn: ast.AST) -> Iterator[ast.Return]:
    """Return statements lexically in fn's body, not in nested defs."""
    def visit(node: ast.AST) -> Iterator[ast.Return]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Return):
                yield child
            yield from visit(child)

    yield from visit(fn)


def _calls_with_scope(mg: ModuleGraph) -> Iterator[Tuple[Tuple[str, ...],
                                                         ast.Call]]:
    """(enclosing function scope, Call) for every call in the module."""
    def visit(node: ast.AST, scope: Tuple[str, ...]):
        for child in ast.iter_child_nodes(node):
            ns = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ns = scope + (child.name,)
            elif isinstance(child, ast.Call):
                yield scope, child
            yield from visit(child, ns)

    yield from visit(mg.info.tree, ())
