"""Project-level analysis: ProjectInfo, ProjectRule and the whole-program pass.

``analyze_project`` parses every file once (content-hash cached, shared
with the per-module pass), builds the import graph and callgraph from
:mod:`.graph`, then runs the per-module rules file by file AND the
project rules over the whole :class:`ProjectInfo`. Project findings may
carry a ``call_chain`` (rendered in text/JSON output) and extra
``anchors`` — a callgraph finding is suppressible with ``# drynx:
noqa[rule]`` at the sync site *or* at the launch entry it is reachable
from.

Still pure ``ast``, still no torch import.
"""
from __future__ import annotations

from pathlib import Path
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Set,
                    Tuple)

from .core import (RULES, Finding, ModuleInfo, Rule, _rel,
                   iter_py_files, module_info_for, suppressed_at)
from .graph import CallGraph, ImportGraph, ModuleGraph, module_name


class ProjectInfo:
    """The whole scanned package: per-file ModuleInfo + both graphs."""

    def __init__(self, infos: Sequence[ModuleInfo]):
        self.modules: Dict[str, ModuleInfo] = {i.relpath: i for i in infos}
        self.graphs: Dict[str, ModuleGraph] = {}
        for info in infos:
            dotted = module_name(info.relpath)
            is_pkg = info.relpath.endswith("__init__.py")
            self.graphs[dotted] = ModuleGraph(info, dotted, is_pkg)
        self.by_relpath: Dict[str, ModuleGraph] = {
            mg.info.relpath: mg for mg in self.graphs.values()}
        self.imports = ImportGraph(self.graphs)
        self.calls = CallGraph(self.graphs, self.imports)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_sources(cls, pairs: Iterable[Tuple[str, str]]) -> "ProjectInfo":
        """Build from (relpath, source) pairs — the test entrypoint."""
        return cls([module_info_for(src, rel) for rel, src in pairs])

    @classmethod
    def from_paths(cls, paths: Sequence[Path],
                   ) -> Tuple["ProjectInfo", List[Finding]]:
        """Build from files/dirs; unparseable files come back as
        parse-error findings instead of ProjectInfo members."""
        infos: List[ModuleInfo] = []
        errors: List[Finding] = []
        for path in iter_py_files(paths):
            rel = _rel(path)
            try:
                source = path.read_text(encoding="utf-8")
                infos.append(module_info_for(source, rel))
            except (OSError, UnicodeDecodeError) as e:
                errors.append(Finding(rule="parse-error", file=rel, line=1,
                                      message=f"unreadable file: {e}",
                                      line_text=""))
            except SyntaxError as e:
                errors.append(Finding(rule="parse-error", file=rel,
                                      line=e.lineno or 1,
                                      message=f"file does not parse: {e.msg}",
                                      line_text=""))
        return cls(infos), errors

    # -- derived facts ----------------------------------------------------

    def in_focus(self, relpath: str) -> bool:
        """True when the file is inside the current focus set (or no
        focus is active). ``--changed-only`` narrows the focus to the
        impacted set; rules consult this to skip out-of-focus modules."""
        focus = getattr(self, "focus", None)
        return focus is None or relpath in focus

    def impacted_relpaths(self, changed: Iterable[str]) -> Set[str]:
        """The *impacted set* of a change: the changed files plus every
        transitive importer (reverse import-graph closure) — a change to
        params.py re-runs the project rules on everything that imports
        it, directly or through re-exports."""
        rev: Dict[str, Set[str]] = {}
        for dotted, mg in self.graphs.items():
            deps: Set[str] = set()
            for b in mg.froms.values():
                t = self.imports.canon(b.target_module)
                if t is not None:
                    deps.add(t)
                    # `from pkg import mod` may bind a submodule
                    sub = self.imports.canon(f"{t}.{b.target_name}")
                    if sub is not None:
                        deps.add(sub)
            for a in mg.aliases.values():
                t = self.imports.canon(a.target_module)
                if t is not None:
                    deps.add(t)
            for dep in deps:
                rev.setdefault(dep, set()).add(dotted)
        by_rel = {mg.info.relpath: dotted
                  for dotted, mg in self.graphs.items()}
        queue = [by_rel[rel] for rel in changed if rel in by_rel]
        seen: Set[str] = set(queue)
        while queue:
            cur = queue.pop()
            for importer in rev.get(cur, ()):
                if importer not in seen:
                    seen.add(importer)
                    queue.append(importer)
        out = {self.graphs[d].info.relpath for d in seen}
        out.update(rel for rel in changed if rel in self.modules)
        return out

    # -- golden-test shape -------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        """Deterministic JSON view of both graphs (golden-test surface).
        Only structure — no AST nodes, no absolute paths."""
        imports: Dict[str, object] = {}
        for dotted in sorted(self.graphs):
            mg = self.graphs[dotted]
            imports[dotted] = {
                "file": mg.info.relpath,
                "froms": {n: {"module": b.target_module,
                              "name": b.target_name, "line": b.lineno}
                          for n, b in sorted(mg.froms.items())},
                "aliases": {n: {"module": a.target_module, "line": a.lineno}
                            for n, a in sorted(mg.aliases.items())},
            }
        callgraph = {
            fid: sorted({s.callee for s in sites})
            for fid, sites in sorted(self.calls.calls.items())}
        return {"imports": imports, "callgraph": callgraph,
                "launch_entries": sorted(self.calls.launch_entries)}


class ProjectRule(Rule):
    """A rule that needs the whole project. ``run`` (per-module) defaults
    to nothing; subclasses that keep a lexical component may override both.
    ``--list-rules`` marks these ``[project]``."""

    project = True
    engine = "project"

    def run(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def run_project(self, project: ProjectInfo) -> Iterator[Finding]:
        raise NotImplementedError


def chain_hop(relpath: str, lineno: int, symbol: str) -> str:
    """One rendered call-chain hop: ``file:line:symbol``."""
    return f"{relpath}:{lineno}:{symbol}"


def analyze_project(paths: Sequence[Path],
                    rules: Optional[Iterable[str]] = None,
                    changed: Optional[Sequence[str]] = None,
                    ) -> List[Finding]:
    """Whole-program pass: per-module rules on every file + project rules
    over the ProjectInfo, noqa applied at the finding line or any anchor.

    ``changed`` (relpaths) narrows the pass to the *impacted set* — the
    changed files plus their transitive importers via the reverse import
    graph. The graphs and summaries are still built whole-program (a
    partial file set has no meaningful import graph); only reporting and
    the per-module scan are restricted, which is what keeps
    ``--changed-only`` under the fast-tier budget.
    """
    from . import rules as _rules  # noqa: F401  (side effect: registration)

    project, findings = ProjectInfo.from_paths(paths)
    focus: Optional[Set[str]] = None
    if changed is not None:
        focus = project.impacted_relpaths(changed)
        project.focus = focus
        findings = [f for f in findings if f.file in focus]
    selected = list(RULES.values() if rules is None
                    else [RULES[r] for r in rules])
    for relpath in sorted(project.modules):
        if focus is not None and relpath not in focus:
            continue
        mod = project.modules[relpath]
        for rule in selected:
            findings.extend(rule.run(mod))
    for rule in selected:
        if rule.project:
            found = rule.run_project(project)
            findings.extend(f for f in found
                            if focus is None or f.file in focus)
    findings = [f for f in findings
                if not suppressed_at(f, project.modules)]
    # absorb: a rule may declare it supersedes another's findings at the
    # same (file, line) — the dataflow secret-flow rule wins over the
    # regex seed rule so one leak is reported once.
    winners: Dict[str, Set[Tuple[str, int]]] = {}
    for f in findings:
        rule = RULES.get(f.rule)
        for victim in getattr(rule, "absorbs", ()):
            winners.setdefault(victim, set()).add((f.file, f.line))
    findings = [f for f in findings
                if (f.file, f.line) not in winners.get(f.rule, set())]
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
