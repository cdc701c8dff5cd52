"""The kernel warm-up registry (see registry.py's docstring).

Public surface:
  Profile, BENCH          -- survey shape parameters of the entries
  query_profile(cluster, q)
                          -- a query's shape on a cluster
  build_registry(profile) -- enumerate the entries (nothing driven)
  precompile(profile)     -- the serial warm-up driver
  STATS, CompileStats     -- per-entry status and time
  COLD_EVENTS, ColdEvents -- library loads and table builds, by thread

CLI: python -m drynx_tpu_torch.precompile [--list | --build | --cpu]
"""
from .registry import (BENCH, Entry, Profile, build_registry, precompile,
                       query_profile)
from .stats import COLD_EVENTS, STATS, ColdEvents, CompileStats

__all__ = ["BENCH", "Entry", "Profile", "build_registry", "precompile",
           "query_profile", "STATS", "CompileStats", "COLD_EVENTS",
           "ColdEvents"]
