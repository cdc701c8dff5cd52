"""SARIF 2.1.0 output for CI annotation.

``python -m drynx_tpu_torch.analysis --format sarif`` emits one run with the
triggered rules' metadata and every finding as a ``result``; findings
that carry a call/value chain render it as a SARIF ``codeFlow`` (one
``threadFlow`` whose locations are the chain hops), so code-scanning UIs
show the same pin -> launder -> sink / read -> import -> definition
trails the text output renders as ``call chain:`` lines.

Pure stdlib, deterministic output (rules and findings arrive sorted).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .core import RULES, Finding

_TOOL_NAME = "drynx-tpu-analysis"
_SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def _parse_hop(hop: str) -> Optional[Tuple[str, int, str]]:
    """``file:line:symbol`` -> parts (symbol may itself contain colons)."""
    parts = hop.split(":", 2)
    if len(parts) == 3 and parts[1].isdigit():
        return parts[0], int(parts[1]), parts[2]
    return None


def _location(file: str, line: int,
              message: Optional[str] = None) -> Dict[str, object]:
    loc: Dict[str, object] = {
        "physicalLocation": {
            "artifactLocation": {"uri": file},
            "region": {"startLine": max(1, line)},
        }
    }
    if message is not None:
        loc["message"] = {"text": message}
    return loc


def to_sarif(findings: Sequence[Finding]) -> Dict[str, object]:
    """A complete SARIF log dict for ``json.dumps``."""
    rule_ids = sorted({f.rule for f in findings})
    rules_meta: List[Dict[str, object]] = []
    for rid in rule_ids:
        rule = RULES.get(rid)
        meta: Dict[str, object] = {"id": rid}
        if rule is not None and rule.summary:
            meta["shortDescription"] = {"text": rule.summary}
        rules_meta.append(meta)
    index = {rid: i for i, rid in enumerate(rule_ids)}

    results: List[Dict[str, object]] = []
    for f in findings:
        res: Dict[str, object] = {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [_location(f.file, f.line)],
        }
        hops = [h for h in (_parse_hop(h) for h in f.call_chain)
                if h is not None]
        if hops:
            res["codeFlows"] = [{
                "threadFlows": [{
                    "locations": [
                        {"location": _location(file, line, symbol)}
                        for file, line, symbol in hops],
                }],
            }]
        results.append(res)

    return {
        "$schema": _SARIF_SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": _TOOL_NAME,
                "informationUri":
                    "https://github.com/drynx-tpu/drynx-tpu",
                "rules": rules_meta,
            }},
            "results": results,
        }],
    }
