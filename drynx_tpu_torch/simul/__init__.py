"""Simulation harness: TOML-grid-driven survey runs with phase-timer CSV.

The reference's simul/ (onet simulation, drynx_simul.go + runfiles/drynx.toml)
maps to: each row of the TOML grid is one run configuration (roster sizes,
operation, proofs, ranges, DiffP); every run executes the full survey on an
in-process cluster and appends one CSV row of per-phase wall-clock seconds —
the same artifact the reference's parse_time_data pipeline consumes.
"""
from .runner import SimulationConfig, run_simulation, run_file  # noqa: F401
