"""Query model: Operation / Query / SurveyQuery + validation + proof sizing.

A copy of drynx_tpu/service/query.py. Mirrors the semantics of the
reference's lib/structs.go:
  Operation            lib/structs.go:200-208  (ChooseOperation :591-641)
  Query                lib/structs.go:177-198
  SurveyQuery          lib/structs.go:231-256
  CheckParameters      lib/structs.go:446-533
  QueryToProofsNbrs    lib/structs.go:536-567
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..encoding import output_size
from ..models.logreg import LRParams

VALID_OPS = ["sum", "mean", "variance", "cosim", "bool_OR", "bool_AND",
             "min", "max", "frequency_count", "union", "inter", "lin_reg",
             "r2", "log_reg"]

OBFUSCATION_OPS = {"bool_AND", "bool_OR", "min", "max", "union", "inter"}


@dataclasses.dataclass
class Operation:
    name: str
    nbr_input: int = 0
    nbr_output: int = 0
    query_min: int = 0
    query_max: int = 0
    lr_params: Optional[LRParams] = None


@dataclasses.dataclass
class DiffPParams:
    """Differential-privacy / DRO parameters (reference QueryDiffP)."""

    noise_list_size: int = 0
    lap_mean: float = 0.0
    lap_scale: float = 0.0
    quanta: float = 0.0
    scale: float = 0.0
    limit: float = 0.0

    def enabled(self) -> bool:
        # reference AddDiffP: noise applied iff params set
        return (self.noise_list_size > 0 and self.lap_scale != 0.0
                and self.scale != 0.0)


@dataclasses.dataclass
class Query:
    operation: Operation
    ranges: Optional[list] = None       # [(u, l)] per output, or None
    proofs: int = 0                     # 0 = off, 1 = on
    obfuscation: bool = False
    diffp: DiffPParams = dataclasses.field(default_factory=DiffPParams)
    cutting_factor: int = 0
    dp_data_min: int = 0                # dummy-data generation bounds
    dp_data_max: int = 0
    sigs_present: bool = False          # input-validation signatures set
    # Group-by: candidate values per group attribute (reference
    # AllPossibleGroups, protocols/data_collection_protocol.go:186-196);
    # e.g. [[0, 1], [10, 20, 30]] = 2 attributes, 6 groups. None = ungrouped.
    group_by: Optional[list] = None

    def n_groups(self) -> int:
        if not self.group_by:
            return 1
        n = 1
        for vals in self.group_by:
            n *= len(vals)
        return n


@dataclasses.dataclass
class SurveyQuery:
    survey_id: str
    query: Query
    server_ids: list                    # CN identities
    server_to_dp: dict                  # CN id -> [DP ids]
    vn_ids: list = dataclasses.field(default_factory=list)
    client_pub: object = None
    id_to_public: dict = dataclasses.field(default_factory=dict)
    threshold: float = 0.0
    aggregation_proof_threshold: float = 0.0
    obfuscation_proof_threshold: float = 0.0
    range_proof_threshold: float = 0.0
    key_switching_proof_threshold: float = 0.0
    # Resilience knobs (ROBUSTNESS.md): 0 = require
    # every DP (the reference's one-shot behavior); N > 0 lets the survey
    # complete over any >= N responding DPs. vn_quorum is the fraction of
    # VNs whose complete bitmaps commit the audit block (1.0 = all).
    min_dp_quorum: int = 0
    vn_quorum: float = 1.0


def choose_operation(name: str, query_min: int = 0, query_max: int = 0,
                     dims: int = 1, cutting_factor: int = 0,
                     lr_params: Optional[LRParams] = None) -> Operation:
    """Set input/output sizes per operation (reference ChooseOperation,
    lib/structs.go:591-641)."""
    if name not in VALID_OPS:
        raise ValueError(f"unknown operation {name!r}")
    if name == "log_reg":
        if lr_params is None:
            raise ValueError("log_reg needs lr_params")
        nbr_out = lr_params.num_coeffs()
        nbr_in = int(lr_params.n_features) + 1
    else:
        nbr_out = output_size(name, query_min, query_max, dims)
        nbr_in = {"cosim": 2, "lin_reg": dims + 1}.get(name, 1)
    if cutting_factor:
        nbr_out *= cutting_factor
    return Operation(name=name, nbr_input=nbr_in, nbr_output=nbr_out,
                     query_min=query_min, query_max=query_max,
                     lr_params=lr_params)


def _ranges_bits(ranges) -> bool:
    return all(u == 2 and l == 1 for (u, l) in ranges)


def _ranges_zeros(ranges) -> bool:
    return all(u == 0 and l == 0 for (u, l) in ranges)


def check_parameters(sq: SurveyQuery, diffp: bool) -> tuple[bool, str]:
    """Validation mirroring reference CheckParameters (lib/structs.go:446).
    Returns (ok, message)."""
    msg = []
    q = sq.query
    if q.proofs == 1:
        if q.obfuscation:
            if sq.obfuscation_proof_threshold == 0:
                msg.append("obfuscation threshold is 0 while obfuscation on")
            if q.operation.name not in OBFUSCATION_OPS:
                msg.append("obfuscation for a non-accepted operation")
            if q.ranges is not None and not _ranges_bits(q.ranges):
                msg.append("obfuscation+proofs but ranges not 0/1")
        elif sq.obfuscation_proof_threshold != 0:
            msg.append("obfuscation threshold set without obfuscation")
        if q.ranges is None:
            msg.append("proofs but no ranges")
        else:
            if not q.sigs_present and not _ranges_zeros(q.ranges):
                msg.append("proofs but no signatures")
            if _ranges_zeros(q.ranges) and q.sigs_present:
                msg.append("ranges zero but signatures set")
            if q.sigs_present and len(q.ranges) != q.operation.nbr_output:
                msg.append("ranges length does not match nbr output")
    elif q.proofs == 0:
        if (sq.key_switching_proof_threshold or sq.obfuscation_proof_threshold
                or sq.range_proof_threshold or sq.threshold):
            msg.append("no proofs but a threshold is nonzero")
        if q.ranges is not None or q.sigs_present:
            msg.append("no proofs but ranges or signatures set")
        if sq.vn_ids:
            msg.append("no proofs but VN roster set")
    else:
        msg.append("unsupported proof type")

    d = q.diffp
    if not diffp:
        if (d.limit or d.scale or d.quanta or d.noise_list_size
                or d.lap_mean or d.lap_scale):
            msg.append("no diffP but parameters not 0")
    else:
        if ((d.limit == 0 and d.quanta == 0) or d.scale == 0
                or d.noise_list_size == 0 or d.lap_scale == 0):
            msg.append("diffP but parameters are 0")

    if (q.operation.query_min != q.dp_data_min
            or q.operation.query_max != q.dp_data_max):
        msg.append("min/max inconsistent between DP data gen and operation")

    n_dps = sum(len(v) for v in sq.server_to_dp.values())
    if not 0 <= sq.min_dp_quorum <= n_dps:
        msg.append(f"min_dp_quorum {sq.min_dp_quorum} outside [0, {n_dps}]")
    if not 0.0 < sq.vn_quorum <= 1.0:
        msg.append(f"vn_quorum {sq.vn_quorum} outside (0, 1]")

    # the diagnostics quote only public query bookkeeping (quorums,
    # thresholds, proof flags); the object-level taint on ``sq`` is an
    # artifact of the client identity riding in the same aggregate
    return (len(msg) == 0, "; ".join(msg))  # drynx: declassify[secret]


def query_to_proofs_nbrs(sq: SurveyQuery) -> list[int]:
    """[range, shuffle, aggregation, obfuscation, keyswitch] proof counts
    (reference QueryToProofsNbrs, lib/structs.go:536-567)."""
    nbr_dps = sum(len(v) for v in sq.server_to_dp.values())
    nbr_servers = len(sq.server_ids) if sq.query.proofs else 0
    prf_range = nbr_dps
    prf_shuffle = nbr_servers if sq.query.diffp.enabled() else 0
    prf_aggr = nbr_servers
    prf_obf = nbr_servers if sq.query.obfuscation else 0
    prf_ks = nbr_servers
    return [prf_range, prf_shuffle, prf_aggr, prf_obf, prf_ks]


__all__ = ["VALID_OPS", "OBFUSCATION_OPS", "Operation", "DiffPParams",
           "Query", "SurveyQuery", "choose_operation", "check_parameters",
           "query_to_proofs_nbrs"]
