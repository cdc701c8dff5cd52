"""Client API — the querier's view of the system.

The port's counterpart of drynx_tpu/service/api.py, which mirrors the
reference's services/api.go + api_skipchain.go surface: NewDrynxClient
(:39), GenerateSurveyQuery (:58), SendSurveyQuery (:105),
SendEndVerification / SendGet{Genesis,Block,LatestBlock,Proofs}
(api_skipchain.go:16-106), over the in-process cluster.
"""
from __future__ import annotations

from typing import Optional

from ..resilience import policy as pol
from .query import SurveyQuery
from .service import LocalCluster, SurveyResult


class DrynxClient:
    """Querier client bound to a cluster (reference API, api.go:31-56).

    With no cluster given it builds a `LocalCluster` from `cluster_kwargs`
    on `device` (the card unless the CPU is named)."""

    def __init__(self, cluster: Optional[LocalCluster] = None,
                 name: str = "client", device=None, **cluster_kwargs):
        if cluster is None:
            cluster = LocalCluster(device=device, **cluster_kwargs)
        self.cluster = cluster
        self.name = name
        self.public = cluster.client.public

    # -- query construction (api.go:58-103)
    def generate_survey_query(self, op_name: str, **kwargs) -> SurveyQuery:
        return self.cluster.generate_survey_query(op_name, **kwargs)

    # -- main path (api.go:105-133): returns decoded result
    def send_survey_query(self, sq: SurveyQuery, seed: int = 0) -> SurveyResult:
        return self.cluster.run_survey(sq, seed=seed)

    # -- VN/skipchain side (api_skipchain.go)
    def send_end_verification(self, survey_id: str,
                              timeout: float = pol.END_VERIFICATION_TIMEOUT_S,
                              quorum: float = 1.0):
        return self.cluster.vns.end_verification(survey_id, timeout=timeout,
                                                 quorum=quorum)

    def get_genesis(self):
        return self.cluster.vns.root.chain.genesis()

    def get_latest_block(self):
        return self.cluster.vns.root.chain.latest()

    def get_block(self, index: int):
        return self.cluster.vns.root.chain.block(index)

    def get_block_for_survey(self, survey_id: str):
        return self.cluster.vns.root.chain.block_for_survey(survey_id)

    def get_proofs(self, survey_id: str, vn_index: int = 0):
        return self.cluster.vns.vns[vn_index].stored_proofs(survey_id)


__all__ = ["DrynxClient"]
