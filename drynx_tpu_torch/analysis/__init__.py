"""drynx_tpu_torch.analysis — the port of drynx_tpu/analysis: an AST-based
lint pass over drynx_tpu_torch/ enforcing the port's torch/CUDA/crypto
invariants (unsafe-pickle, implicit-dtype, host-roundtrip-in-decode,
host-sync-in-hot-path, secret-logging, hardcoded-timeout, thread-build,
cuda-launch-operand, ciphertext-dtype-launder, secret-flow-to-sink,
unguarded-shared-mutation, lock-order-inversion, blocking-call-under-lock,
nondet-flow-to-transcript, unordered-iteration-at-sink,
atomic-durable-write, slab-consumption-order, conn-checkout-discipline,
seal-commit-once), and the runtime recorders that cross-check it
(locktrace, dettrace, prototrace; their workloads in crosscheck).

Per-module rules walk one file; ``[project]`` rules get a
:class:`ProjectInfo` (import graph + callgraph over the whole package).
Run ``python -m drynx_tpu_torch.analysis``; ``--list-rules`` says how each
rule relates to the reference's. Deliberately framework-free: importing
it loads neither torch nor JAX.
"""
from .core import (REPO_ROOT, RULES, BaselineEntry, Finding, ModuleInfo,
                   Rule, analyze_paths, analyze_source, apply_baseline,
                   load_baseline, module_info_for)
from .project import ProjectInfo, ProjectRule, analyze_project
from .dataflow import Dataflow, Secret, dataflow_for
from .concurrency import Concurrency, concurrency_for
from .determinism import Determinism, determinism_for
from .typestate import Typestate, typestate_for
from .sarif import to_sarif
from . import rules as _rules  # noqa: F401  (populate the registry)
from .cli import DEFAULT_BASELINE, main

__all__ = ["REPO_ROOT", "RULES", "BaselineEntry", "Finding", "ModuleInfo",
           "Rule", "ProjectInfo", "ProjectRule", "Dataflow", "Secret",
           "Concurrency", "concurrency_for",
           "Determinism", "determinism_for",
           "Typestate", "typestate_for",
           "analyze_paths", "analyze_project", "analyze_source",
           "apply_baseline", "dataflow_for", "load_baseline",
           "module_info_for", "to_sarif", "DEFAULT_BASELINE", "main"]
