"""Survey orchestration: CN / DP / VN roles and the in-process cluster.

The port's counterpart of drynx_tpu/service/service.py (the reference's
services/service.go HandleSurveyQuery / StartService and the onet
LocalTest harness, services/service_test.go:29-66). Phases per survey:

  DP encode + encrypt  ->  collective aggregation  ->  obfuscation (the
  zero/non-zero operations, when asked)  ->  DRO noise (when asked)  ->
  key switch to the querier  ->  decrypt + decode (+ gradient descent for
  log_reg)

With proofs on, every DP proves its ciphertexts' ranges, every CN proves
the aggregate, its obfuscation, its shuffle of the noise list and its
key-switch contribution, each
proof travels in a Schnorr-signed envelope to every verifying node (VN),
and the root VN commits the survey's bitmap to the audit chain. All
ciphertext work is batched over DPs and servers and runs through the
kernels of `crypto.cuda_ops` and `crypto.cuda_pairing` on the cluster's
device (the card unless the CPU is named). On the card the proofs are built and
delivered on worker threads, one at a time under one lock, while the main
path goes on; on the CPU they run inline. A survey's randomness is drawn
on the main thread from one generator seeded by `seed`, in a fixed order,
before any proof thread starts, so its payload bytes do not depend on
thread scheduling.

A grouped survey (`group_by`) encodes every DP's statistics per group of
the query's group grid, flattens them group-major and proves group g's
value i against the query's spec i; the querier decodes per group. A
cutting factor cf > 1 tiles every DP's vector cf times (the reference's
scale-test knob): every ciphertext and proof is made cf times, and the
querier decodes the first replica.

A held survey (`execute_survey(hold_range=True)`) keeps its DPs' range
payloads at the VNs until `VNGroup.flush_cross_survey` checks several
held surveys in one RLC batch (`range_proof.
verify_cross_survey_payloads_joint`); `finalize_survey` flushes a held
survey alone if no cross flush took it.

The DRO noise phase (reference service.py:852-915) encrypts the
deterministic noise list, passes it through every CN's shuffle and
re-randomization in roster order, and adds one noise ciphertext to each
result. A CN's zero-encryptions come from its prewarmed entries
(`prewarm_dro`, `load_shuffle_precomp`; consumed once, their files
deleted), else from the persistent crypto pool (`LocalCluster(pool=...)`,
slabs claimed once), else are computed fresh.

Before its first proofs-on survey a cluster on the card runs the kernel
warm-up registry once (the reference's default, `precompile="auto"`):
`compilecache.precompile` builds and loads the libraries, launches each
kernel once and builds the range proofs' tables, on the calling thread,
before any proof thread starts; the survey's `PrecompileTraceExec` timer
holds its seconds.

Every DP dispatch and every delivery to a VN goes through
`transport.local_call`, so an installed fault plan (`resilience.faults`)
decides who answers, as a TCP dispatch would: a killed, refusing or
dropped DP is absent, and the survey runs over the responders when they
meet `min_dp_quorum` (the VNs' expected proof counts lowered to them); a
faulted VN misses its proofs, and `vn_quorum` < 1 commits the block from
the VNs that reported. Each survey keeps a phase checkpoint
(`store.SurveyCheckpoint`: phase entries, responders, absent, resumes),
durable with `attach_checkpoint_store`; a re-entry of the same survey id
counts a resume. `probe_liveness` pings the DPs through the same hooks,
for the server's resume lane.

Two free functions remain from the earlier slices and serve the cluster:
`collect_with_range_proofs` (the DPs' encryption and range proofs, one
batched creation) and `verify_collected_range_proofs` (the VN's joint
check of the DPs' payloads).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import secrets
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import flagship
from .. import pool as pool_mod
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..encoding import stats as st
from ..encoding import tiles
from ..models import logreg as lr
from ..parallel import collective as col
from ..parallel import dro
from ..proofs import aggregation as agg_proof
from ..proofs import keyswitch as ks_proof
from ..proofs import obfuscation as obf_proof
from ..proofs import range_proof as rp
from ..proofs import requests as rq
from ..proofs import shuffle as shuffle_proof
from ..proofs.safe_pickle import safe_loads
from ..resilience import faults
from ..resilience import policy as pol
from ..utils import log
from ..utils.device import resolve
from ..utils.timers import PhaseTimers
from . import topology as topo
from . import transport as tr
from .proof_collection import VerifyCache, VerifyingNode, VNGroup
from .store import ProofDB, SurveyCheckpoint
from .query import (DiffPParams, Operation, SurveyQuery, Query,
                    check_parameters, choose_operation, query_to_proofs_nbrs)


# ---------------------------------------------------------------------------
# The range-proof phases as free functions
# ---------------------------------------------------------------------------

def make_range_sigs(u: int, n_servers: int, seed: int = 5,
                    device=None) -> list[rp.RangeSig]:
    """One digit-signature set of base u per computing node, drawn from a
    numpy seed, with its GT tables built on the host and moved to the
    device (the card unless the CPU is named)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    sigs = [rp.init_range_sig(u, rng) for _ in range(n_servers)]
    rp.sig_gt_pow_tables(sigs, dev)    # built here, outside any timed path
    return sigs


def signed_offset(stats: torch.Tensor, ranges) -> int:
    """u^l/2 for the survey's first (u, l) spec (0 when it is empty): the
    shift that makes signed log-reg coefficients a provable [0, u^l)
    statement. Raises when a value does not fit."""
    u0, l0 = ranges[0]
    if not u0:
        return 0
    offset = int(u0) ** int(l0) // 2
    if int(stats.abs().max()) >= offset:
        raise ValueError("log-reg encoding exceeds the range proof "
                         f"bound u^l/2 = {offset}")
    return offset


def encrypt_tiled(base_table, pub_tbl, stats, enc_rs):
    """The DPs' encryption of stats (n_dps, V) with blinding enc_rs
    (n_dps, V, 16), one dispatch per tile of `tiles.plan_tiles(V,
    auto_tile(V))` along the value axis above the threshold, else one
    (reference service.py:764-775). enc_rs is drawn at full size and
    sliced, and the encryption is element-wise, so the tiled ciphertexts
    equal one dispatch's byte for byte."""
    V = int(stats.shape[-1])
    tile = tiles.auto_tile(V)
    if not tile:
        return eg.encrypt_ints_with_tables(base_table, pub_tbl, stats, enc_rs)
    return torch.cat([eg.encrypt_ints_with_tables(
        base_table, pub_tbl, stats[..., a:b], enc_rs[..., a:b, :])
        for a, b in tiles.plan_tiles(V, tile).tiles], dim=-4)


def collect_with_range_proofs(dp_stats, enc_rs, ranges, sigs_by_u: dict,
                              coll_pub_table,
                              generator: torch.Generator | None = None,
                              draws: dict | None = None):
    """Encrypt every DP's log-reg stats and prove their ranges, on the
    device of `coll_pub_table`.

    dp_stats: int64 (n_dps, V) fixed-point stats; enc_rs: (n_dps, V, 16)
    encryption blinding scalars; ranges: [(u, l)] per value; sigs_by_u:
    {u: [RangeSig per CN]}; randomness from `generator`, or the draws of
    each (u, l) spec. Returns (cts (n_dps, V, 2, 3, 16), [RangeProofList
    per DP]); DP i's payload is lists[i].to_bytes().
    """
    dev = coll_pub_table.device
    stats = dp_stats.to(dev, torch.int64)
    stats = stats + signed_offset(stats, ranges)
    enc_rs = enc_rs.to(dev)
    cts = eg.encrypt_ints_with_tables(eg.BASE_TABLE.table.to(dev),
                                      coll_pub_table, stats, enc_rs)
    lists = rp.create_range_proof_lists_batched(
        stats, enc_rs, cts, ranges, sigs_by_u, coll_pub_table, generator,
        draws)
    return cts, lists


def verify_collected_range_proofs(payloads, ranges, sigs_by_u: dict,
                                  coll_pub_table) -> list[bool]:
    """The verifying node's joint check of the DPs' range-proof payloads
    (their raw bytes, as `collect_with_range_proofs` serializes them) on
    the device of `coll_pub_table`: one bool per payload. The RLC weights
    are drawn fresh for every call."""
    sigs_pub_by_u = {u: [s.public for s in sigs]
                     for u, sigs in sigs_by_u.items()}
    return rp.verify_range_proof_payloads_joint(payloads, ranges,
                                                sigs_pub_by_u, coll_pub_table)


# ---------------------------------------------------------------------------
# Roles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeIdentity:
    name: str
    secret: int
    public: tuple  # affine int pair


def _new_identity(name: str, rng: np.random.Generator) -> NodeIdentity:
    x, pub = eg.keygen(rng)
    return NodeIdentity(name=name, secret=x, public=pub)


class DataProvider:
    """DP role: local data -> sufficient statistics (reference GenerateData,
    data_collection_protocol.go:178-374)."""

    def __init__(self, ident: NodeIdentity, data=None, groups=None):
        self.ident = ident
        self.data = data  # op-dependent host array (or (X, y) for log_reg)
        self.groups = groups  # int64 (rows, n_attrs) group labels, or None

    def local_stats(self, op: Operation, rng, group_by=None) -> torch.Tensor:
        """The DP's int64 statistics on the CPU: (V,) ungrouped, (n_groups,
        V) when the query groups (reference GenerateData encodes per group,
        data_collection_protocol.go:254-267)."""
        if op.name == "log_reg":
            X, y = self.data
            return lr.encode_clear(X, y, op.lr_params)
        data = self.data
        if data is None:  # dummy data like createFakeDataForOperation
            data = rng.integers(op.query_min, max(op.query_max, 1),
                                size=(32,)).astype(np.int64)
        if group_by:
            groups = self.groups
            if groups is None:  # dummy group labels (fake-data path)
                groups = np.stack(
                    [rng.choice(np.asarray(vals), size=len(data))
                     for vals in group_by], axis=-1).astype(np.int64)
            return st.encode_clear_grouped(op.name, data, groups,
                                           st.group_grid(group_by),
                                           op.query_min, op.query_max)
        return st.encode_clear(op.name, data, op.query_min, op.query_max)


class Survey:
    """Mutable per-survey state on the root CN (reference ServiceDrynx
    survey map, service.go:82-108)."""

    def __init__(self, sq: SurveyQuery):
        self.sq = sq
        self.timers = PhaseTimers()
        self.proof_threads: list[threading.Thread] = []
        self.proof_errors: list[BaseException] = []
        # a streaming engine's pane or advance survey: its range payloads
        # verify through the engine's digest-keyed memo
        self.stream = None


class LocalCluster:
    """In-process roster: CNs, DPs (mapped to CNs round robin), VNs and the
    querier, on one device (the card unless the CPU is named).

    `seed` draws the identities, the collective key, the client key and the
    range-proof signatures with numpy's default_rng and the host curve
    arithmetic, as the reference does: one seed gives the same keys in both
    packages. The VNs' proof stores live in a temporary directory that
    `close()` removes. `pool` (a `pool.CryptoPool`) is activated before any
    table is built: it serves the fixed-base and signature tables and the
    DRO phase's zero-encryption slabs (reference service.py:143-151,
    :202-209). On a CUDA device the warm-up registry runs before the
    first proofs-on survey (where proofs are built on threads), as the
    reference's "auto" default does on its kernel backend (reference
    :128-134); a CPU cluster is warmed by calling `compilecache.precompile`
    with it. `link` (a `transport.LinkModel`) sleeps a link's delay and
    bandwidth time where the reference sends a message (the DPs' upload,
    each proof's delivery); `share_verify_cache=False` gives each VN a
    cache that keeps nothing, so every delivery is verified (reference
    :127, :193-199).
    """

    def __init__(self, n_cns: int = 3, n_dps: int = 5, n_vns: int = 3,
                 seed: int = 1, dlog_limit: int = 10000, device=None,
                 pool=None, link=None, share_verify_cache: bool = True):
        self._aot_warmed = False
        self.device = dev = resolve(device)
        # where the reference pays a network message (the DPs' ciphertext
        # upload, a proof's delivery to the VNs), an active link model
        # sleeps its delay and bandwidth time
        self.link = link if link is not None else tr.LinkModel()
        self.pool = pool
        self._pool_digest: Optional[str] = None
        if pool is not None:
            pool_mod.activate(pool)
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.cns = [_new_identity(f"cn{i}", rng) for i in range(n_cns)]
        self.dp_idents = [_new_identity(f"dp{i}", rng) for i in range(n_dps)]
        self.vn_idents = [_new_identity(f"vn{i}", rng) for i in range(n_vns)]
        self.client = _new_identity("client", rng)

        # collective key over the CN roster; fixed-base tables on the device
        self.coll_pub = col.collective_key([c.public for c in self.cns])
        self.coll_tbl = eg.pub_table(self.coll_pub)
        self.client_tbl = eg.pub_table(self.client.public)
        for tbl in (self.coll_tbl, self.client_tbl):
            tbl.table = tbl.table.to(dev)
        self.base_table = eg.BASE_TABLE.table.to(dev)
        self.client_pt = C.from_ref(self.client.public).to(dev)
        self.coll_pt = C.from_ref(self.coll_pub).to(dev)
        self.dlog = eg.DecryptionTable(limit=dlog_limit).to(dev)
        # the DRO slabs' key: the collective-key table's digest (every
        # tenant is content-addressed, so a shared pool never serves an
        # artifact to the wrong key)
        if pool is not None:
            self._pool_digest = pool_mod.key_digest(self.coll_tbl.table)
        # prewarmed shuffle precomputations, {(CN index, size): [(precomp,
        # file or None)]}, each consumed once
        self._shuffle_precomp: dict = {}

        # DP -> CN mapping (reference repartitionDPs round robin)
        self.server_to_dp: dict = {}
        for i, dp in enumerate(self.dp_idents):
            cn = self.cns[i % n_cns].name
            self.server_to_dp.setdefault(cn, []).append(dp.name)

        self.dps: dict[str, DataProvider] = {
            d.name: DataProvider(d) for d in self.dp_idents}

        pubs = {n.name: n.public
                for n in self.cns + self.dp_idents + [self.client]}
        self.vns: Optional[VNGroup] = None
        self._vn_dir = None
        if n_vns > 0:
            self._vn_dir = tempfile.TemporaryDirectory(prefix="drynx_vn_")
            # co-located VNs share ONE verification cache: identical
            # payloads (the aggregation and key-switch bodies every CN
            # relays, the joint range flush) verify once per process, as
            # real VNs on separate machines would in parallel (see
            # VerifyCache); share_verify_cache=False caches nothing, so
            # every delivery is verified
            shared_cache = VerifyCache()
            self.vns = VNGroup([
                VerifyingNode(v.name, f"{self._vn_dir.name}/{v.name}.db",
                              pubs, verify_fns=self._verify_fns(), seed=i,
                              verify_cache=(shared_cache
                                            if share_verify_cache
                                            else VerifyCache(maxsize=0)))
                for i, v in enumerate(self.vn_idents)])

        self.range_sigs: dict[int, list[rp.RangeSig]] = {}
        self.surveys: dict[str, Survey] = {}
        # per-survey phase checkpoints; attach_checkpoint_store makes them
        # durable, and the server's resume lane reads them
        self.checkpoints: dict[str, SurveyCheckpoint] = {}
        self.checkpoint_db: Optional[ProofDB] = None
        # (plan, monotonic time, {DP: alive}) of the last probe
        self._probe_cache: Optional[tuple] = None
        # serializes proof threads' device work (see _async_proof)
        self._proof_device_lock = pol.named_lock("proof_device_lock")

    def close(self) -> None:
        """Remove the VNs' proof stores, and deactivate the cluster's pool
        if it is still the active one."""
        if self._vn_dir is not None:
            self._vn_dir.cleanup()
        if self.pool is not None and pool_mod.active_pool() is self.pool:
            pool_mod.activate(None)

    # ------------------------------------------------------------------
    # Proof payload verifiers installed at the VNs
    # ------------------------------------------------------------------
    def _sigs_pub_by_u(self) -> dict:
        return {u: [s.public for s in sigs]
                for u, sigs in self.range_sigs.items()}

    def _verify_fns(self):
        def vrange(data: bytes, survey_id: str) -> bool:
            survey = self.surveys.get(survey_id)
            if survey is None:
                return False
            if survey.stream is not None:
                # a pane blob recurs across a stream's life: the engine's
                # digest-keyed memo checks each once (service/streaming.py)
                return survey.stream.verify_pane_blob(data)
            lst = rp.RangeProofList.from_bytes(data, self.device)
            return rp.verify_range_proof_list(
                lst, self._ranges_per_value(survey.sq.query),
                self._sigs_pub_by_u(), self.coll_tbl.table)

        def vrange_joint(datas: list, survey_id: str) -> list:
            survey = self.surveys.get(survey_id)
            if survey is None:
                return [False] * len(datas)
            return verify_collected_range_proofs(
                datas, self._ranges_per_value(survey.sq.query),
                self.range_sigs, self.coll_tbl.table)

        def vrange_cross(payloads_by_sid: dict) -> dict:
            # several held surveys' payloads in one RLC check; a survey the
            # CN no longer knows verifies all-False
            expected_by_sid = {}
            for sid in payloads_by_sid:
                survey = self.surveys.get(sid)
                expected_by_sid[sid] = (
                    None if survey is None
                    else self._ranges_per_value(survey.sq.query))
            return rp.verify_cross_survey_payloads_joint(
                payloads_by_sid, expected_by_sid, self._sigs_pub_by_u(),
                self.coll_tbl.table)

        def vagg(data: bytes, _sid: str) -> bool:
            proof = safe_loads(data)
            return bool(np.all(agg_proof.verify_aggregation_proof(
                proof, self.device)))

        def vobf(data: bytes, _sid: str) -> bool:
            proof = safe_loads(data)
            return bool(np.all(obf_proof.verify_obfuscation_proofs(
                proof, self.device)))

        def vks(data: bytes, _sid: str) -> bool:
            proof = safe_loads(data)
            return bool(np.all(ks_proof.verify_keyswitch_proofs(
                proof, self.client_tbl.table)))

        def vshuffle(data: bytes, _sid: str) -> bool:
            # the (in, out) the envelope carries; CN i's input is not
            # chained to CN i-1's output, as in the reference (:303-309)
            proof, in_cts, out_cts = safe_loads(data)
            # the lists come unpickled on the host: one upload
            return shuffle_proof.verify_shuffle(
                proof, torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
                    in_cts).to(self.device),
                torch.from_numpy(out_cts), self.coll_pt)

        # each computed verification lands in its Verify<Type> timer and in
        # AllProofs (cache hits add nothing)
        def _timed(name, fn):
            def wrapped(data, sid, _fn=fn, _name=name):
                t0 = time.perf_counter()
                try:
                    return _fn(data, sid)
                finally:
                    sv = self.surveys.get(sid)
                    if sv is not None:
                        dt = time.perf_counter() - t0
                        sv.timers.add(_name, dt)
                        sv.timers.add("AllProofs", dt)
            return wrapped

        def _timed_cross(fn):
            # one check serves the batch: its time is split evenly over the
            # batched surveys' timers
            def wrapped(payloads_by_sid, _fn=fn):
                t0 = time.perf_counter()
                try:
                    return _fn(payloads_by_sid)
                finally:
                    share = ((time.perf_counter() - t0)
                             / max(1, len(payloads_by_sid)))
                    for sid in payloads_by_sid:
                        sv = self.surveys.get(sid)
                        if sv is not None:
                            sv.timers.add("VerifyRange", share)
                            sv.timers.add("AllProofs", share)
            return wrapped

        return {"range": _timed("VerifyRange", vrange),
                "range_joint": _timed("VerifyRange", vrange_joint),
                "range_cross": _timed_cross(vrange_cross),
                "aggregation": _timed("VerifyAggregation", vagg),
                "obfuscation": _timed("VerifyObfuscation", vobf),
                "keyswitch": _timed("VerifyKeySwitch", vks),
                "shuffle": _timed("VerifyShuffle", vshuffle)}

    # ------------------------------------------------------------------
    # Survey query construction (reference API.GenerateSurveyQuery, api.go:58)
    # ------------------------------------------------------------------
    def generate_survey_query(self, op_name: str, query_min: int = 0,
                              query_max: int = 0, dims: int = 1,
                              proofs: int = 0, obfuscation: bool = False,
                              ranges=None, diffp: Optional[DiffPParams] = None,
                              lr_params=None, thresholds: float = 1.0,
                              cutting_factor: int = 0, group_by=None,
                              min_dp_quorum: int = 0, vn_quorum: float = 1.0,
                              survey_id: Optional[str] = None) -> SurveyQuery:
        op = choose_operation(op_name, query_min, query_max, dims,
                              cutting_factor, lr_params)
        if group_by and op_name == "log_reg":
            raise ValueError("group_by is not supported for log_reg")
        if group_by and cutting_factor > 1 and proofs:
            # the replica-major tiling of the statistics and the
            # group-major tiling of the ranges would interleave differently
            raise ValueError(
                "cutting_factor > 1 with group_by and proofs is unsupported")
        if (op_name == "log_reg" and proofs and ranges
                and len(set(map(tuple, ranges))) > 1):
            # the signed-encoding shift derives ONE offset from the spec;
            # per-index specs would shift values out of range
            raise ValueError(
                "log_reg range proofs require a uniform (u, l) spec")
        if proofs and ranges is None:
            # default range: values fit in [0, 16^4)
            ranges = [(16, 4)] * op.nbr_output
        q = Query(operation=op, ranges=ranges, proofs=proofs,
                  obfuscation=obfuscation,
                  diffp=diffp or DiffPParams(),
                  cutting_factor=cutting_factor,
                  dp_data_min=query_min, dp_data_max=query_max,
                  sigs_present=proofs == 1 and ranges is not None
                  and not all(u == 0 and l == 0 for (u, l) in ranges),
                  group_by=group_by)
        sq = SurveyQuery(
            survey_id=survey_id or f"survey-{secrets.token_hex(4)}",
            query=q,
            server_ids=[c.name for c in self.cns],
            server_to_dp=self.server_to_dp,
            vn_ids=[v.name for v in self.vn_idents] if proofs else [],
            client_pub=self.client.public,
            id_to_public={n.name: n.public for n in
                          self.cns + self.dp_idents + self.vn_idents},
            threshold=thresholds if proofs else 0.0,
            aggregation_proof_threshold=thresholds if proofs else 0.0,
            obfuscation_proof_threshold=(thresholds if proofs and obfuscation
                                         else 0.0),
            range_proof_threshold=thresholds if proofs else 0.0,
            key_switching_proof_threshold=thresholds if proofs else 0.0,
            min_dp_quorum=min_dp_quorum, vn_quorum=vn_quorum)
        ok, msg = check_parameters(sq, q.diffp.enabled())
        if not ok:
            raise ValueError(f"invalid survey parameters: {msg}")
        return sq

    # ------------------------------------------------------------------
    # Range-proof signature setup (reference InitRangeProofSignature — once
    # per (server, base u) at query setup)
    # ------------------------------------------------------------------
    def ensure_range_sigs(self, u: int) -> list[rp.RangeSig]:
        if u not in self.range_sigs:
            self.range_sigs[u] = [rp.init_range_sig(u, self.rng)
                                  for _ in self.cns]
            # the one-time GT tables, built here rather than inside the
            # first proof creation
            rp.sig_gt_pow_tables(self.range_sigs[u], self.device)
        return self.range_sigs[u]

    @staticmethod
    def _ranges_per_value(q) -> list:
        """The (u, l) spec of every output index: the query's ranges, tiled
        across the group-by groups (group g's value i takes spec i). The
        query's ranges already span the cutting-factor replicas
        (choose_operation multiplies nbr_output by cf, check_parameters
        holds len(ranges) to it)."""
        return list(q.ranges) * (q.n_groups() if q.group_by else 1)

    # ------------------------------------------------------------------
    # Checkpoints and liveness (reference :571-620)
    # ------------------------------------------------------------------
    def attach_checkpoint_store(self, path: str) -> None:
        """Make survey checkpoints durable: phase records persist to a
        `store.ProofDB` at `path`, so a restarted root reads them back."""
        self.checkpoint_db = ProofDB(path)

    def checkpoint_for(self, survey_id: str) -> Optional[SurveyCheckpoint]:
        """The survey's checkpoint, from memory or else the durable store
        (None when neither holds one)."""
        ck = self.checkpoints.get(survey_id)
        if ck is None:
            ck = SurveyCheckpoint.load(self.checkpoint_db, survey_id)
            if ck is not None:
                self.checkpoints[survey_id] = ck
        return ck

    def probe_liveness(self) -> dict:
        """{DP name: alive}: one ping per DP over `transport.fan_out`, each
        through `local_call`, so the installed fault plan's hooks decide
        reachability; without a plan every DP is alive. The verdicts are
        cached for `PROBE_TTL_S` and keyed to the plan object: a call
        within it reuses them, a new plan probes again."""
        names = [d.name for d in self.dp_idents]  # drynx: declassify[secret]
        plan = faults.fault_plan()
        if plan is None:
            return {n: True for n in names}
        now = time.monotonic()
        if (self._probe_cache is not None
                and self._probe_cache[0] is plan
                and now - self._probe_cache[1] < pol.PROBE_TTL_S):
            return dict(self._probe_cache[2])
        outs = tr.fan_out(
            names, lambda n: tr.local_call(n, "ping", lambda: True))
        alive = {n: err is None for n, (_, err) in zip(names, outs)}
        self._probe_cache = (plan, time.monotonic(), alive)
        return alive

    # ------------------------------------------------------------------
    # The kernel warm-up (reference :524-563)
    # ------------------------------------------------------------------
    def _warm_kernels(self, tm: PhaseTimers, q) -> None:
        """Run the warm-up registry for `q`'s shape once per cluster, on
        the calling thread under the proof-device lock, before any proof
        thread of the survey starts; its seconds go to the
        `PrecompileTraceExec` timer. It runs on a CUDA device only, where
        the proofs are built on threads."""
        from .. import compilecache as cc

        if self._aot_warmed or self.device.type != "cuda":
            return
        profile = cc.query_profile(self, q)
        with self._proof_device_lock:
            t0 = time.perf_counter()
            cc.precompile(profile, mode="execute", cluster=self,
                          log=lambda m: log.lvl2(f"precompile: {m}"))
            tm.add("PrecompileTraceExec", time.perf_counter() - t0)
            self._aot_warmed = True

    # ------------------------------------------------------------------
    # The shuffle precomputation (reference :435-482)
    # ------------------------------------------------------------------
    def prewarm_dro(self, noise_size: int, n_surveys: int = 1,
                    seed: int = 0, cache_dir: Optional[str] = None) -> None:
        """Pre-fill the shuffle-precomputation pool: one fresh entry per
        (CN, survey), on the cluster's device. The reference does this at
        survey setup and persists it (service.go:316-317) so the timed DRO
        phase only permutes + adds. With cache_dir set, each entry is also
        written to disk (the reference's `.npz` members) so a restarted
        process re-loads it (load_shuffle_precomp); entries are consumed
        once, and the backing file is deleted when an entry is used."""
        gen = torch.Generator(device=self.device).manual_seed(
            secrets.randbits(63) ^ seed)
        for ci in range(len(self.cns)):
            for _ in range(n_surveys):
                pc = dro.precompute_rerandomization(
                    self.coll_tbl.table, noise_size, gen,
                    base_tbl=self.base_table)
                path = None
                if cache_dir is not None:
                    os.makedirs(cache_dir, exist_ok=True)
                    path = os.path.join(
                        cache_dir, f"precomp_{ci}_{noise_size}_"
                        f"{secrets.token_hex(6)}.npz")
                    dro.save_precompute(path, pc)
                self._shuffle_precomp.setdefault(
                    (ci, noise_size), []).append((pc, path))

    def load_shuffle_precomp(self, cache_dir: str) -> int:
        """Re-load persisted precomputation entries (either package's)
        after a restart, onto the cluster's device. Returns the number of
        entries loaded."""
        n = 0
        for path in sorted(glob.glob(os.path.join(cache_dir,
                                                  "precomp_*.npz"))):
            stem = os.path.basename(path)[len("precomp_"):-len(".npz")]
            ci_s, size_s, _ = stem.split("_", 2)
            pc = dro.load_precompute(path, self.device)
            self._shuffle_precomp.setdefault(
                (int(ci_s), int(size_s)), []).append((pc, path))
            n += 1
        return n

    def _take_precomp(self, ci: int, size: int):
        """CN ci's zero-encryptions for a noise list of `size`: a prewarmed
        entry (its file claimed, then deleted), else a slab of the
        persistent pool (moved to the device once), else None. Each is
        consumed once: reusing a re-randomization mask across surveys would
        let a proof observer cancel the masks and recover both
        permutations."""
        entries = self._shuffle_precomp.get((ci, size))
        while entries:
            pc, path = entries.pop()
            if path is None:
                return pc
            # a persisted entry is claimed by renaming its file before use,
            # as the pool's store claims a slab: another process that
            # loaded the same file loses the rename and skips the entry
            claimed = path + ".claimed"
            try:
                os.rename(path, claimed)
            except FileNotFoundError:
                continue
            # the entry is already in memory and no ledger records prewarmed
            # entries: the rename is the claim, the unlink its cleanup
            os.unlink(claimed)  # drynx: protocol[claimed prewarm entry already loaded]
            return pc
        if self.pool is not None:
            got = self.pool.try_consume_dro(self._pool_digest, size)
            if got is not None:
                return dro.to_device(got[0], got[1], self.device)
        return None

    # ------------------------------------------------------------------
    # The full survey (reference SendSurveyQuery path, SURVEY.md §3.1)
    # ------------------------------------------------------------------
    def run_survey(self, sq: SurveyQuery, seed: int = 0) -> "SurveyResult":
        return self.finalize_survey(self.execute_survey(sq, seed))

    def _draw(self, gen, n_dps: int, V: int, ranges, proofs_on: bool,
              obfuscation: bool, n_noise: int = 0):
        """The survey's randomness, in a fixed order: encryption, range
        proofs (per (u, l) spec: s, t, m, v as create_range_proofs draws
        them), key switch, key-switch proofs (wr, wx), then per CN the
        obfuscation scalars s and, with proofs, their proof's w (None
        without), then with `n_noise` > 0 the DRO draws: the noise's
        encryption scalars, and per CN the permutation, fresh blinding
        scalars (drawn whether or not a precomputation serves the CN) and,
        with proofs, its prover's 128-bit rng seed (None without). Each
        group comes after the ones before it, so a survey without
        obfuscation or noise draws what it drew before."""
        dev, ns = self.device, len(self.cns)
        draw = lambda shape: eg.random_scalars(shape, gen, dev)
        enc_rs = draw((n_dps, V))
        range_draws = {}
        if proofs_on:
            for (u, l), idx in rp.group_ranges(ranges).items():
                nv = n_dps * len(idx)
                range_draws[(u, l)] = [draw(s) for s in
                                       ((nv, l), (nv, l), (nv, l),
                                        (ns, nv, l))]
        ks_rs = draw((ns, V))
        ks_draws = [draw((ns, V)), draw((ns, V))] if proofs_on else None
        obf_draws = [(draw((V,)), draw((V,)) if proofs_on else None)
                     for _ in range(ns)] if obfuscation else []
        dro_draws = None
        if n_noise > 0:
            noise_r = draw((n_noise,))
            per_cn = []
            for _ in range(ns):
                perm = torch.randperm(n_noise, generator=gen,
                                      device=gen.device)
                r = draw((n_noise,))
                seed = None
                if proofs_on:
                    words = torch.randint(0, 1 << 16, (8,), generator=gen,
                                          device=gen.device)
                    seed = int.from_bytes(
                        words.cpu().numpy().astype("<u2").tobytes(), "little")
                per_cn.append((perm, r, seed))
            dro_draws = (noise_r, per_cn)
        return enc_rs, range_draws, ks_rs, ks_draws, obf_draws, dro_draws

    def execute_survey(self, sq: SurveyQuery, seed: int = 0,
                       hold_range: bool = False, tenant: str = "default",
                       responders: Optional[list] = None
                       ) -> "PendingSurvey":
        """Phases through decrypt + decode; returns a PendingSurvey whose
        proof verification `finalize_survey` completes. `tenant` tags the
        PendingSurvey and SurveyResult for the server's fair queueing.

        `responders` restricts the DPs to the named ones (the server's
        resume carries the live set of a probe); a DP outside it, or one
        that the fault plan keeps from answering, is absent, and the
        survey runs over the rest if they meet the query's
        `min_dp_quorum` (all DPs when 0), else raises RuntimeError. Each
        phase entered is recorded in the survey's checkpoint; a second
        entry of a survey id not done counts a resume."""
        q = sq.query
        survey = Survey(sq)
        self.surveys[sq.survey_id] = survey
        op = q.operation
        tm = survey.timers
        dev = self.device
        proofs_on = q.proofs == 1 and self.vns is not None

        ck = self.checkpoint_for(sq.survey_id)
        if ck is None:
            ck = SurveyCheckpoint(survey_id=sq.survey_id)
            self.checkpoints[sq.survey_id] = ck
        elif not ck.done:
            ck.resumes += 1

        def mark(phase: str) -> None:
            ck.enter(phase)
            ck.save(self.checkpoint_db)

        mark("probe")
        # the DP dispatch, through the fault plane's hooks: a DP the plan
        # keeps from answering is absent (reference :663-708)
        plan = faults.fault_plan()
        allowed = None if responders is None else {str(n)
                                                  for n in responders}
        dp_idents: list = []
        absent: list[str] = []
        for d in self.dp_idents:
            # DP names are public routing metadata even though the
            # identity objects also carry the node's secret scalar
            name = d.name  # drynx: declassify[secret]
            if allowed is not None and name not in allowed:
                absent.append(name)
                continue
            if plan is not None:
                try:
                    tr.local_call(name, "survey_query", lambda: None)
                except tr.TransportError:
                    absent.append(name)
                    continue
            dp_idents.append(d)
        responders = [d.name for d in dp_idents]
        need = (sq.min_dp_quorum if sq.min_dp_quorum > 0
                else len(self.dp_idents))
        if len(responders) < need:
            raise RuntimeError(
                f"survey {sq.survey_id}: only {len(responders)}/"
                f"{len(self.dp_idents)} DPs responded (quorum {need}); "
                f"absent: {sorted(absent)}")
        ck.responders = list(responders)
        ck.absent = sorted(absent)
        log.lvl1(f"survey {sq.survey_id}: op={op.name} "
                 f"dps={len(responders)}/{len(self.dp_idents)} "
                 f"cns={len(self.cns)} proofs={int(proofs_on)} "
                 f"resumes={ck.resumes} device={dev}")

        if proofs_on:
            nbrs = query_to_proofs_nbrs(sq)
            # an absent DP owes one range proof; the rest are the CNs'
            self.vns.register_survey(
                sq.survey_id, sum(nbrs) - len(absent),
                {"range": sq.range_proof_threshold,
                 "shuffle": sq.threshold,
                 "aggregation": sq.aggregation_proof_threshold,
                 "obfuscation": sq.obfuscation_proof_threshold,
                 "keyswitch": sq.key_switching_proof_threshold},
                expected_range=nbrs[0] - len(absent), hold_range=hold_range)
            # the warm-up runs here, on the calling thread, before any
            # proof thread of this survey exists
            self._warm_kernels(tm, q)

        # --- DP phase: encode + encrypt (+ range proofs) ----------------
        mark("collect")
        tm.start("DataCollectionProtocol")
        dp_stats = torch.stack([
            self.dps[d.name].local_stats(op, self.rng, q.group_by)
            for d in dp_idents])                     # (n_dps, V) or (n_dps,G,Vg)
        # group-major: group g's values at [g*Vg, (g+1)*Vg), so the
        # element-wise homomorphic sum is the per-group aggregation
        dp_stats = dp_stats.reshape(dp_stats.shape[0], -1)
        cf = max(int(q.cutting_factor), 1)
        # the cutting factor replicates every value, and so every
        # ciphertext and proof, cf times (reference lib/structs.go:637-639)
        dp_stats = dp_stats.repeat(1, cf).to(dev)
        n_dps, V = dp_stats.shape
        # Sound range proofs for signed encodings: log-reg coefficients can
        # be negative, which a [0, u^l) digit proof cannot express, so each
        # plaintext is shifted by u^l/2 and the key switch subtracts the
        # public n_dps * offset again (reference service.py:746-760)
        range_offset = 0
        if proofs_on and op.name == "log_reg" and q.ranges:
            range_offset = signed_offset(dp_stats, q.ranges)
            dp_stats = dp_stats + range_offset
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_noise = (int(q.diffp.noise_list_size) if q.diffp.enabled() else 0)
        ranges_v = self._ranges_per_value(q) if q.ranges else []
        (enc_rs, range_draws, ks_rs, ks_draws, obf_draws,
         dro_draws) = self._draw(gen, n_dps, V, ranges_v, proofs_on,
                                 q.obfuscation, n_noise)
        cts = encrypt_tiled(self.base_table, self.coll_tbl.table, dp_stats,
                            enc_rs)                 # (n_dps, V, 2,3,16)
        _sync(dev)
        if self.link.active:
            # the DPs upload on independent links at once: one delay and
            # one payload's serialization (V ciphertexts of 128 bytes)
            self.link.charge(V * 128)
        tm.end("DataCollectionProtocol")

        if proofs_on:
            sigs_by_u = {u: self.ensure_range_sigs(u)
                         for (u, _l) in rp.group_ranges(ranges_v)}
            # ONE device-batched creation for all DPs (their per-value
            # transcripts are independent, so batching changes no proof);
            # each DP's payload still ships and verifies separately
            dp_lists = _once(lambda: rp.create_range_proof_lists_batched(
                dp_stats, enc_rs, cts, ranges_v, sigs_by_u,
                self.coll_tbl.table, draws=range_draws))
            for i, dp in enumerate(dp_idents):
                self._async_proof(survey, "range", dp,
                                  lambda i=i: dp_lists()[i].to_bytes())

        # --- Aggregation phase (reference AggregationPhase :775) --------
        mark("aggregate")
        tm.start("AggregationPhase")
        agg = topo.fold_cts(cts)                             # (V, 2, 3, 16)
        _sync(dev)
        tm.end("AggregationPhase")
        if proofs_on:
            # each CN signs its own request but the (transparent) proof body
            # is identical — build and serialize it ONCE, not per CN
            agg_bytes = _once(lambda: pickle.dumps(
                agg_proof.create_aggregation_proof(cts, agg)))
            for cn in self.cns:
                self._async_proof(survey, "aggregation", cn, agg_bytes)

        # --- Obfuscation (zero/non-zero operations; reference :829-851) -
        # each CN multiplies both components of every ciphertext by its
        # own secret scalar, proving it with proofs on; the key switch
        # takes the result
        work = agg
        if q.obfuscation:
            mark("obfuscate")
            tm.start("ObfuscationPhase")
            for cn, (s, w) in zip(self.cns, obf_draws):
                if proofs_on:
                    pr = obf_proof.create_obfuscation_proofs(work, s,
                                                             draws=w)
                    self._async_proof(survey, "obfuscation", cn,
                                      lambda pr=pr: pickle.dumps(pr))
                    work = pr.obf
                else:
                    work = eg.ct_scalar_mul(work, s)
            _sync(dev)
            tm.end("ObfuscationPhase")

        # --- DRO noise (reference :852-915) ------------------------------
        # the noise list, encrypted, passes through every CN's shuffle and
        # re-randomization in roster order; one noise ciphertext is added
        # per result (service.go:600-604)
        if dro_draws is not None:
            mark("dro")
            tm.start("DROPhase")
            d = q.diffp
            noise = dro.generate_noise_values(
                d.noise_list_size, d.lap_mean, d.lap_scale, d.quanta,
                d.scale, d.limit)
            noise_r, per_cn = dro_draws
            n_cts = dro.encrypt_noise(self.coll_tbl, noise, r=noise_r,
                                      base_tbl=self.base_table)
            S = int(n_cts.shape[0])
            for ci, (cn, (perm, r, rng_seed)) in enumerate(zip(self.cns,
                                                               per_cn)):
                pc = self._take_precomp(ci, S)
                if pc is None:
                    pc = dro.precompute_rerandomization(
                        self.coll_tbl.table, S, base_tbl=self.base_table,
                        r=r)
                out_cts, perm, rs = dro.shuffle_rerandomize(
                    n_cts, self.coll_tbl.table, precomp=pc, perm=perm)
                if proofs_on:
                    pr = shuffle_proof.prove_shuffle(
                        n_cts, out_cts, perm, shuffle_proof.limbs_to_ints(rs),
                        self.coll_pt, np.random.default_rng(rng_seed))
                    self._async_proof(
                        survey, "shuffle", cn,
                        lambda pr=pr, a=n_cts, b=out_cts: pickle.dumps(
                            (pr, a.cpu().numpy(), b.cpu().numpy())))
                n_cts = out_cts
            idx = torch.arange(V, device=dev) % S
            work = eg.ct_add(work, n_cts[idx])
            _sync(dev)
            tm.end("DROPhase")

        # --- Key switch to the querier's key ----------------------------
        mark("keyswitch")
        tm.start("KeySwitchingPhase")
        srv_x, u_pts, w_pts, switched = self._key_switch(work, ks_rs)
        # the public aggregate shift (one offset per responder) times B
        total = range_offset * n_dps
        if total:
            corr = eg.fixed_base_mul(self.base_table, eg.int_to_scalar(
                torch.tensor([total], dtype=torch.int64, device=dev)))
            c2 = C.add(switched[:, 1], C.neg(corr.expand(V, 3, -1)))
            switched = torch.stack([switched[:, 0], c2], dim=-3)
        _sync(dev)
        tm.end("KeySwitchingPhase")
        if proofs_on:
            t0 = time.perf_counter()
            pr = ks_proof.create_keyswitch_proofs(
                work[:, 0], srv_x, ks_rs, self.client_pt,
                self.client_tbl.table, u_pts, w_pts, draws=ks_draws)
            tm.add("AllProofs", time.perf_counter() - t0)
            ks_bytes = _once(lambda: pickle.dumps(pr))
            for cn in self.cns:
                self._async_proof(survey, "keyswitch", cn, ks_bytes)

        # --- Querier decrypt + decode -----------------------------------
        mark("decrypt")
        tm.start("Decryption")
        dec = self._decrypt(switched)
        if cf > 1:
            # only the first replica is decoded (the others are the scale
            # test's padding and decrypt to the same values)
            v0 = V // cf
            dec = st.DecryptedVector(values=dec.values[:v0],
                                     found=dec.found[:v0],
                                     is_zero=dec.is_zero[:v0])
        tm.end("Decryption")

        if op.name == "log_reg":
            tm.start("GradientDescent")
            # the discrete-log lookup returns host values: one upload
            Ts = lr.unpack(torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
                dec.values).to(dev), op.lr_params)
            result = lr.train(Ts, op.lr_params).cpu().numpy()
            tm.end("GradientDescent")
        elif q.group_by:
            # per-group decode at the querier (reference api.go:124-128)
            result = st.decode_grouped(
                op.name, dec, st.group_grid(q.group_by), op.query_min,
                op.query_max,
                dims=(op.nbr_input - 1) if op.name == "lin_reg" else 1)
        else:
            result = st.decode(op.name, dec, op.query_min, op.query_max,
                               dims=(op.nbr_input - 1)
                               if op.name == "lin_reg" else 1)
        ck.done = True
        mark("done")
        return PendingSurvey(survey=survey, sq=sq, result=result,
                             decrypted=dec, responders=responders,
                             absent=sorted(absent), proofs_on=proofs_on,
                             hold_range=hold_range and proofs_on,
                             tenant=tenant, checkpoint=ck)

    def _key_switch(self, work, ks_rs):
        """Switch (V, 2, 3, 16) ciphertexts under the collective key to the
        querier's: each CN's contribution U = r B, W = r Q - x K, batched
        over (CNs, V) (the contributions commute, so their sums replace the
        CN chain). Returns (the CNs' secrets as limbs, U, W, the switched
        ciphertexts)."""
        srv_x = torch.stack([eg.secret_to_limbs(c.secret)
                             for c in self.cns]).to(self.device)
        u_pts, w_pts = col.keyswitch_contribution(
            work[None], srv_x[:, None, :], ks_rs, self.client_tbl.table,
            self.base_table)
        switched = col.keyswitch_finish(
            work, flagship._tree_reduce_points(u_pts),
            flagship._tree_reduce_points(w_pts))
        return srv_x, u_pts, w_pts, switched

    def _decrypt(self, switched) -> st.DecryptedVector:
        """The querier's decryption and discrete-log lookup."""
        xq = eg.secret_to_limbs(self.client.secret).to(self.device)
        pts = eg.decrypt_point(switched, xq)
        vals, found = self.dlog.lookup(pts)
        return st.DecryptedVector(
            values=vals.cpu().numpy().astype(np.int64),
            found=found.cpu().numpy(),
            is_zero=C.is_infinity(pts).cpu().numpy())

    def finalize_survey(self, pending: "PendingSurvey") -> "SurveyResult":
        """Join the survey's proof threads, end VN verification, and
        commit the audit block (the back half of run_survey). A proof
        thread that died fails the survey here with its exception."""
        survey, sq = pending.survey, pending.sq  # drynx: declassify[secret]
        sid = sq.survey_id
        tm = survey.timers
        block = None
        if pending.proofs_on:
            for t in survey.proof_threads:
                t.join(timeout=pol.COLD_COMPILE_WAIT_S)
            if survey.proof_errors:
                raise survey.proof_errors[0]
            if pending.hold_range:
                # a held survey that no cross flush took flushes alone
                self.vns.flush_cross_survey([sid])
            block = self.vns.end_verification(
                sid, timeout=pol.COLD_COMPILE_WAIT_S, quorum=sq.vn_quorum)
            log.lvl2(f"survey {sid}: audit block #{block.index} committed, "
                     f"{len(block.data.bitmap)} bitmap entries")
        log.lvl1(f"survey {sid}: done; phases: " + ", ".join(
            f"{k}={v:.3f}s" for k, v in tm.items()))
        ck = pending.checkpoint
        return SurveyResult(result=pending.result,
                            decrypted=pending.decrypted, block=block,
                            timers=tm, survey_id=sid,
                            responders=pending.responders,
                            absent=pending.absent, tenant=pending.tenant,
                            resumes=ck.resumes if ck else 0,
                            phases=dict(ck.phase_entries) if ck else {})

    # ------------------------------------------------------------------
    def _async_proof(self, survey: Survey, ptype: str, ident: NodeIdentity,
                     build) -> None:
        """Build a proof's bytes, sign the envelope and deliver it to the
        VNs (the reference's async goroutine pipeline).

        On the card this runs on a thread, and the device work of all proof
        threads (the build and the VNs' verification) is serialized by one
        lock, while the main phase path goes on. A thread that dies keeps
        its exception for `finalize_survey`. On the CPU it runs inline:
        overlap buys nothing there."""
        lock = self._proof_device_lock

        def work():
            with lock:
                t0 = time.perf_counter()
                data = build()
                survey.timers.add("AllProofs", time.perf_counter() - t0)
            req = rq.new_proof_request(
                ptype, survey.sq.survey_id, ident.name,
                f"{ptype}-{ident.name}", 0, data, ident.secret)
            if self.link.active:
                # to the VNs on parallel links: one delay and one
                # payload's serialization
                self.link.charge(len(data))
            with lock:
                self.vns.deliver(req)

        if self.device.type != "cuda":
            work()
            return

        def guarded():
            try:
                work()
            except Exception as e:
                log.warn(f"proof thread {ptype}/{ident.name} died: {e!r}")
                survey.proof_errors.append(e)

        t = threading.Thread(target=guarded, daemon=True)
        t.start()
        survey.proof_threads.append(t)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _once(build):
    """Memoize a zero-argument build function across the per-CN proof
    threads."""
    lock = threading.Lock()
    box: dict = {}

    def get():
        with lock:
            if "v" not in box:
                box["v"] = build()
            return box["v"]

    return get


@dataclasses.dataclass
class PendingSurvey:
    """A survey that ran through decrypt + decode but whose proof
    verification is not yet finalized (execute_survey/finalize_survey)."""
    survey: Survey
    sq: SurveyQuery
    result: object
    decrypted: st.DecryptedVector
    proofs_on: bool
    hold_range: bool = False
    tenant: str = "default"    # the server's fair-queueing key
    # which DPs contributed, and which were absent
    responders: list = dataclasses.field(default_factory=list)
    absent: list = dataclasses.field(default_factory=list)
    checkpoint: Optional[SurveyCheckpoint] = None   # the phase record


@dataclasses.dataclass
class SurveyResult:
    result: object
    decrypted: st.DecryptedVector
    block: object
    timers: PhaseTimers
    survey_id: str
    # which DPs contributed, and which were absent
    responders: list = dataclasses.field(default_factory=list)
    absent: list = dataclasses.field(default_factory=list)
    tenant: str = "default"
    # re-entries of the survey, and its checkpoint's entries of each phase
    # (a clean run: resumes 0, every phase entered once)
    resumes: int = 0
    phases: dict = dataclasses.field(default_factory=dict)


__all__ = ["make_range_sigs", "signed_offset", "collect_with_range_proofs",
           "verify_collected_range_proofs", "NodeIdentity", "DataProvider",
           "Survey", "LocalCluster", "PendingSurvey", "SurveyResult"]
