"""CLI for the static analyzer.

    python -m drynx_tpu_torch.analysis [paths...]  # lint (default: drynx_tpu_torch/)
    python -m drynx_tpu_torch.analysis --list-rules
    python -m drynx_tpu_torch.analysis --format json drynx_tpu_torch/crypto
    python -m drynx_tpu_torch.analysis --changed-only    # pre-commit fast tier

By default the whole-program pass runs too (import graph + callgraph, the
``[project]`` rules); ``--no-project`` restricts to the per-module rules.
Project findings carry a call chain, rendered as indented text and as a
stable ``call_chain`` list in ``--format json``.

Exit codes: 0 = clean (all findings baselined/suppressed), 1 = unbaselined
findings (or stale baseline entries under --strict-baseline), 2 = usage.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import (REPO_ROOT, RULES, analyze_paths, apply_baseline,
                   load_baseline)
from .project import analyze_project
from .rules import NOT_APPLICABLE  # (imports register the rule set)

try:  # keep the linter usable even if the resilience package breaks
    from ..resilience.policy import SUBPROCESS_TIMEOUT_S
except Exception:  # pragma: no cover
    SUBPROCESS_TIMEOUT_S = 30.0

DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m drynx_tpu_torch.analysis",
        description="AST lint pass enforcing the drynx_tpu_torch port's "
                    "torch/CUDA/crypto invariants")
    ap.add_argument("paths", nargs="*", type=Path,
                    default=None, help="files/dirs to scan "
                    "(default: the drynx_tpu_torch package)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help=f"baseline JSON (default {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail when baseline entries no longer match "
                         "anything (prune reminder)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="ID",
                    help="run only this rule (repeatable)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--list-rules", action="store_true")
    proj = ap.add_mutually_exclusive_group()
    proj.add_argument("--project", dest="project", action="store_true",
                      default=True,
                      help="run the whole-program pass too (default)")
    proj.add_argument("--no-project", dest="project", action="store_false",
                      help="per-module rules only (no import graph / "
                           "callgraph)")
    ap.add_argument("--changed-only", action="store_true",
                    help="fast tier: restrict reporting to the *impacted "
                         "set* of the files changed vs git HEAD — the "
                         "changed files plus their transitive importers "
                         "via the reverse import graph (full scan fallback "
                         "when git is unavailable)")
    return ap


def _changed_files() -> Optional[List[Path]]:
    """Python files changed vs HEAD (staged + unstaged + untracked), or
    None when git is unavailable / not a repo."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            capture_output=True, text=True, cwd=REPO_ROOT,
            timeout=SUBPROCESS_TIMEOUT_S)
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, cwd=REPO_ROOT,
            timeout=SUBPROCESS_TIMEOUT_S)
        names = diff.stdout.splitlines()
        if untracked.returncode == 0:
            names += untracked.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    out = []
    for n in dict.fromkeys(names):
        p = REPO_ROOT / n
        if n.endswith(".py") and p.exists():
            out.append(p)
    return out


def _relpath(p: Path) -> str:
    try:
        return p.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return p.resolve().as_posix()


def _is_under(p: Path, root: Path) -> bool:
    try:
        p.resolve().relative_to(Path(root).resolve())
        return True
    except ValueError:
        return False


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        # grouped by backing engine: the lexical per-module rules, the
        # callgraph [project] rules, then one section per whole-program
        # engine (dataflow/concurrency/determinism/typestate); each rule
        # says how it relates to the reference analyzer's rule, and the
        # reference rules with no counterpart close the list
        order = ["lint", "project", "dataflow", "concurrency",
                 "determinism", "typestate"]
        by_engine: Dict[str, List[Tuple[str, object]]] = {}
        for rid, rule in sorted(RULES.items()):
            by_engine.setdefault(rule.engine, []).append((rid, rule))
        for engine in order + sorted(set(by_engine) - set(order)):
            if engine not in by_engine:
                continue
            print(f"[{engine}]")
            for rid, rule in by_engine[engine]:
                mark = " [project]" if rule.project else ""
                if rule.seed_only:
                    mark += " [seed-only]"
                group = rule.group + (f": {rule.replaces}"
                                      if rule.replaces else "")
                print(f"  {rid}{mark} ({group}): {rule.summary}")
        print("[n/a]")
        for rid, why in sorted(NOT_APPLICABLE.items()):
            print(f"  {rid} (n/a): {why}")
        return 0

    for rid in args.rules or ():
        if rid not in RULES:
            print(f"unknown rule {rid!r}; --list-rules shows the registry",
                  file=sys.stderr)
            return 2

    project_mode = args.project
    changed_rel: Optional[List[str]] = None
    if args.changed_only:
        changed = _changed_files()
        if changed is not None:
            # the deliberately-broken lint fixtures must not redden the
            # pre-commit tier when they themselves are edited
            changed = [p for p in changed
                       if "tests/fixtures" not in _relpath(p)]
        if changed is None:
            print("git unavailable; falling back to a full scan",
                  file=sys.stderr)
            paths = args.paths or [REPO_ROOT / "drynx_tpu_torch"]
        elif not changed:
            print("no changed python files", file=sys.stderr)
            return 0
        else:
            # scan the whole package (graphs/summaries need it), but
            # report only the impacted set: changed files + transitive
            # importers via the reverse import graph. Changed files
            # outside the package scan roots are linted too.
            scan = args.paths or [REPO_ROOT / "drynx_tpu_torch"]
            paths = list(scan) + [p for p in changed
                                  if not any(_is_under(p, s)
                                             for s in scan)]
            changed_rel = [_relpath(p) for p in changed]
            if not project_mode:
                paths = changed
    else:
        paths = args.paths or [REPO_ROOT / "drynx_tpu_torch"]
    for p in paths:
        if not Path(p).exists():
            print(f"no such path: {p}", file=sys.stderr)
            return 2

    if project_mode:
        findings = analyze_project(paths, rules=args.rules,
                                   changed=changed_rel)
    else:
        findings = analyze_paths(paths, rules=args.rules)
    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    unbaselined, matched, stale = apply_baseline(findings, baseline)

    if args.format == "sarif":
        from .sarif import to_sarif
        print(json.dumps(to_sarif(unbaselined), indent=2))
    elif args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in unbaselined],
            "baselined": matched,
            "stale_baseline_entries": [e.__dict__ for e in stale],
        }, indent=2))
    else:
        for f in unbaselined:
            print(f.render())
        for e in stale:
            print(f"stale baseline entry (prune it): [{e.rule}] {e.file}: "
                  f"{e.line_text!r}", file=sys.stderr)
        summary = (f"{len(unbaselined)} finding(s) ({matched} baselined) in "
                   f"{len({f.file for f in findings})} file(s) with findings")
        print(summary, file=sys.stderr)

    if unbaselined:
        return 1
    if stale and args.strict_baseline:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
