"""Streaming surveys: pane-delta aggregation with proof reuse.

The port's counterpart of drynx_tpu/service/streaming.py. A querier that
asks again and again for a statistic over a sliding window of arriving
rows should pay for the rows that changed, not for the whole window:

  * Arriving rows land in immutable fixed-width **panes**. Each pane is
    encoded (`stats.encode_clear`), encrypted and range-proved once, on
    the cluster's device.
  * A pane's range proofs are signed and delivered once, when it seals,
    under the stream-stable survey id `{stream_id}-p{pane_id}`, whose
    audit block is committed then. With a `ProofDB` attached the blobs
    are also stored under `store.pane_key`, and a restarted engine reuses
    them instead of proving again.
  * A window advance ships only the ciphertext delta: the new panes'
    folds are added, the expired panes' subtracted (`elgamal.ct_add`,
    `ct_sub`), then `topology.canon_points` gives the one canonical byte
    form, so the bytes equal a from-scratch `fold_cts` of the same window
    (`slide_window`). The advance's own survey carries only the CNs'
    aggregation proofs of the window fold.
  * The VNs check a pane blob through the engine's digest-keyed verdict
    memo (`verify_pane_blob`, reached from the cluster's `vrange` through
    `Survey.stream`), so identical blobs verify once a stream.
  * An optional `pool.EpsilonLedger` charges every DP's (DP, cohort)
    budget before an advance runs; a DiffP stream takes its DRO
    precomputation from the cluster's crypto pool, and computes it fresh
    only when the pool is short.

Only additive encodings stream (`ADDITIVE_OPS`): subtracting an expired
pane is exact only when the window statistic is the sum of the panes'
encodings. The frequency grid covers quantiles, medians and top-k as
decode modes (`decode_mode=`).

Pane randomness: the reference derives it with
`jax.random.fold_in(seed, pane_id)`; the port seeds a `torch.Generator`
on the cluster's device with a pure function of (engine seed, kind, pane
id) (`pane_seed`), and an advance's key-switch and DRO draws with one of
(engine seed, kind, first pane, last pane). A restarted port engine fed
the same rows therefore reproduces its own ciphertexts, proof blobs and
transcripts byte for byte, and an engine on another stream id with the
same seed produces the same pane ciphertexts. The bytes cannot equal the
reference's, whose draws come from JAX's generator.

A proofs-on engine warms its cluster's kernels when it is built, as the
reference's does (`cluster._warm_kernels`): the registry's entries for the
prototype query's shape, once per cluster.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import secrets
from typing import Optional

import numpy as np
import torch

from ..crypto import elgamal as eg
from ..encoding import stats as st
from ..parallel import dro
from ..proofs import aggregation as agg_proof
from ..proofs import range_proof as rp
from ..proofs import requests as rq
from ..resilience import policy as pol
from ..utils import log
from ..utils.timers import PhaseTimers
from . import topology as topo
from .service import Survey, _once, _sync, encrypt_tiled
from .store import pane_key

# DRYNX_PROTO_TRACE: report pane seal / proof-commit lifecycle events to
# the runtime protocol recorder (analysis/prototrace.py).
_PROTO_TRACE = os.environ.get("DRYNX_PROTO_TRACE", "0") == "1"

# Encodings whose window statistic is the exact sum of the panes'
# encodings, the precondition for subtracting an expired pane.
ADDITIVE_OPS = ("frequency_count", "sum")

# The kinds of a stream's draws, one generator seed each (pane_seed).
_ENC, _PROOF, _KEYSWITCH, _DRO = 1, 2, 3, 4


def pane_seed(seed: int, kind: int, *ids: int) -> int:
    """A 63-bit generator seed, a pure function of the engine seed, the
    kind of draw and the pane ids."""
    msg = "/".join(str(int(x)) for x in (seed, kind, *ids)).encode()
    return int.from_bytes(hashlib.sha256(msg).digest()[:8], "little") >> 1


def slide_window(window_ct, expired: list, added: list) -> torch.Tensor:
    """A window fold moved by the delta: every expired pane's fold
    subtracted, every new pane's added, then the canonical form. Equal
    byte for byte to `topology.fold_cts` of the new window's folds (the
    group is abelian and canon_points maps a point to one form)."""
    cur = window_ct
    for fold in expired:
        cur = eg.ct_sub(cur, fold)
    for fold in added:
        cur = eg.ct_add(cur, fold)
    return topo.canon_points(cur)


@dataclasses.dataclass
class Pane:
    """One sealed, immutable pane: its canonical ciphertext fold (on the
    cluster's device) and each DP's range-proof blob."""

    pane_id: int
    fold: torch.Tensor             # (V, 2, 3, 16), canon_points form
    blobs: dict                    # DP name -> RangeProofList bytes
    proofs_reused: bool = False    # the blobs came from the ProofDB
    block: object = None           # the pane's audit block (proofs on)


@dataclasses.dataclass
class StreamAdvance:
    """The result of one window advance."""

    survey_id: str
    result: object
    decrypted: st.DecryptedVector
    window: tuple                  # (first pane id, last pane id)
    panes_new: int                 # panes added to the window
    panes_expired: int             # panes subtracted from it
    block: object = None           # the advance's audit block (proofs on)


class StreamEngine:
    """A pane-based streaming survey over a LocalCluster.

    Every DP is fed the same number of rows (panes seal in lockstep, so
    the panes' folds add element-wise), and a restarted engine fed the
    same rows reproduces its panes byte for byte (see the module
    docstring)."""

    def __init__(self, cluster, op_name: str = "frequency_count",
                 query_min: int = 0, query_max: int = 0, *,
                 stream_id: Optional[str] = None,
                 pane_width: Optional[int] = None,
                 window_panes: Optional[int] = None,
                 ranges=None, proofs: int = 1, diffp=None,
                 decode_mode: Optional[str] = None,
                 pane_db=None, epsilon_ledger=None,
                 epsilon_per_advance: Optional[float] = None,
                 seed: int = 0):
        if op_name not in ADDITIVE_OPS:
            raise ValueError(
                f"streaming requires an additive encoding, got {op_name!r} "
                f"(supported: {ADDITIVE_OPS})")
        self.cluster = cluster
        self.op_name = op_name
        self.query_min = int(query_min)
        self.query_max = int(query_max)
        self.decode_mode = decode_mode
        self.stream_id = stream_id or f"stream-{secrets.token_hex(4)}"
        self.pane_width = int(pane_width or pol.PANE_WIDTH)
        self.window_panes = int(window_panes or pol.STREAM_WINDOW_PANES)
        if self.pane_width <= 0 or self.window_panes <= 0:
            raise ValueError("pane_width and window_panes must be positive")
        self.proofs_on = proofs == 1 and cluster.vns is not None
        # the prototype query: the ranges, thresholds and DiffP every
        # advance's query takes again
        self.sq_proto = cluster.generate_survey_query(
            op_name, query_min, query_max, proofs=proofs, ranges=ranges,
            diffp=diffp, survey_id=f"{self.stream_id}-proto")
        q = self.sq_proto.query
        self.ranges = list(q.ranges) if q.ranges is not None else None
        self._ranges_v = (cluster._ranges_per_value(q)
                          if self.ranges is not None else [])
        self.V = int(st.output_size(op_name, self.query_min, self.query_max))
        self.pane_db = pane_db
        self.epsilon_ledger = epsilon_ledger
        self.epsilon_per_advance = float(
            pol.EPSILON_PER_ADVANCE if epsilon_per_advance is None
            else epsilon_per_advance)
        # the accountant's key: the (roster, query) population a budget
        # protects, stable across restarts
        self.cohort = hashlib.sha256(json.dumps(
            {"op": op_name, "min": self.query_min, "max": self.query_max,
             "dps": sorted(d.name for d in cluster.dp_idents)},
            sort_keys=True).encode()).hexdigest()[:16]
        self.seed = int(seed)
        self._buffers: dict[str, list] = {d.name: []
                                          for d in cluster.dp_idents}
        self._buffered: dict[str, int] = {d.name: 0
                                          for d in cluster.dp_idents}
        self._panes: list[Pane] = []
        self._win_first = 0
        self._win_last = -1            # an empty window
        self.window_ct: Optional[torch.Tensor] = None  # noise-free fold
        self._last_sid: Optional[str] = None
        self._verify_lock = pol.named_lock("stream_verify_memo_lock")
        self._verify_memo: dict[bytes, bool] = {}
        self.timers = PhaseTimers()
        self.counters = {"panes_sealed": 0, "proofs_created": 0,
                         "proofs_reused": 0, "pane_verifies": 0,
                         "pane_verify_hits": 0, "advances": 0,
                         "epsilon_charges": 0}
        if self.proofs_on:
            for u, _l in rp.group_ranges(self._ranges_v):
                cluster.ensure_range_sigs(u)
            cluster._warm_kernels(self.timers, q)

    # -- feeding and sealing ------------------------------------------------

    def feed(self, rows_by_dp: dict) -> None:
        """Buffer arriving rows per DP (values in [query_min, query_max]
        for the grid ops). Panes seal at the next `advance()`; feeding does
        no device work."""
        for name, rows in rows_by_dp.items():
            if name not in self._buffers:
                raise KeyError(f"unknown DP {name!r}")
            a = np.asarray(rows, dtype=np.int64).reshape(-1)
            self._buffers[name].append(a)
            self._buffered[name] += int(a.shape[0])

    def sealable_panes(self) -> int:
        """Complete panes buffered at every DP."""
        if not self._buffered:
            return 0
        return min(self._buffered.values()) // self.pane_width

    def _take_pane_rows(self, name: str) -> np.ndarray:
        buf = (np.concatenate(self._buffers[name]) if self._buffers[name]
               else np.zeros((0,), dtype=np.int64))
        rows, rest = buf[:self.pane_width], buf[self.pane_width:]
        self._buffers[name] = [rest] if rest.size else []
        self._buffered[name] = int(rest.shape[0])
        return rows

    def _generator(self, kind: int, *ids: int) -> torch.Generator:
        return torch.Generator(device=self.cluster.device).manual_seed(
            pane_seed(self.seed, kind, *ids))

    def pane_sid(self, pane_id: int) -> str:
        """The stream-stable survey id a pane's proofs live under at the
        VNs, the same across advances and restarts: a re-delivered blob
        hits the VNs' (type, survey, digest) cache."""
        return f"{self.stream_id}-p{pane_id}"

    def _seal_next_pane(self) -> Pane:
        pid = len(self._panes)
        cluster = self.cluster
        dp_idents = cluster.dp_idents
        tm = self.timers
        tm.start("PaneSeal")
        stats = torch.stack([
            st.encode_clear(self.op_name, self._take_pane_rows(d.name),
                            self.query_min, self.query_max)
            for d in dp_idents]).to(cluster.device)
        with cluster._proof_device_lock:
            enc_rs = eg.random_scalars(stats.shape, self._generator(_ENC, pid),
                                       cluster.device)
            cts = encrypt_tiled(cluster.base_table, cluster.coll_tbl.table,
                                stats, enc_rs)
            fold = topo.fold_cts(cts)
        blobs: dict = {}
        reused = False
        if self.proofs_on:
            if self.pane_db is not None:
                stored = {d.name: self.pane_db.get(
                    pane_key(self.stream_id, pid, d.name))
                    for d in dp_idents}
                if all(v is not None for v in stored.values()):
                    blobs, reused = stored, True
                    self.counters["proofs_reused"] += len(dp_idents)
            if not blobs:
                sigs_by_u = {u: cluster.ensure_range_sigs(u)
                             for u, _l in rp.group_ranges(self._ranges_v)}
                with cluster._proof_device_lock:
                    lists = rp.create_range_proof_lists_batched(
                        stats, enc_rs, cts, self._ranges_v, sigs_by_u,
                        cluster.coll_tbl.table,
                        generator=self._generator(_PROOF, pid))
                    blobs = {d.name: lists[i].to_bytes()
                             for i, d in enumerate(dp_idents)}
                self.counters["proofs_created"] += len(dp_idents)
                if self.pane_db is not None:
                    for d in dp_idents:
                        self.pane_db.put(pane_key(self.stream_id, pid,
                                                  d.name), blobs[d.name])
                    self.pane_db.sync()
        pane = Pane(pane_id=pid, fold=fold, blobs=blobs,
                    proofs_reused=reused)
        if self.proofs_on:
            pane.block = self._deliver_pane_proofs(pane)
        self._panes.append(pane)
        self.counters["panes_sealed"] += 1
        if _PROTO_TRACE:
            from ..analysis import prototrace
            prototrace.record(prototrace.new_instance("seal"), "seal")
        tm.end("PaneSeal")
        return pane

    def _deliver_pane_proofs(self, pane: Pane):
        """Ship one sealed pane's range proofs to the VNs and commit its
        audit block: the only time its proofs ride an envelope, so an
        advance re-signs and re-checks nothing for the panes it carries."""
        cluster = self.cluster
        psid = self.pane_sid(pane.pane_id)
        survey = Survey(self.sq_proto)
        survey.stream = self
        cluster.surveys[psid] = survey
        cluster.vns.register_survey(
            psid, len(cluster.dp_idents),
            {"range": self.sq_proto.range_proof_threshold},
            expected_range=0)
        with cluster._proof_device_lock:
            for d in cluster.dp_idents:
                req = rq.new_proof_request(
                    "range", psid, d.name, f"range-{d.name}-p{pane.pane_id}",
                    0, pane.blobs[d.name], d.secret)
                cluster.vns.deliver(req)
        block = cluster.vns.end_verification(psid,
                                             timeout=pol.VN_GROUP_WAIT_S)
        if _PROTO_TRACE:
            from ..analysis import prototrace
            prototrace.record(prototrace.new_instance("seal"), "commit")
        return block

    # -- epsilon accounting ---------------------------------------------------

    def charge_epsilon(self) -> None:
        """Charge one advance's epsilon to every DP's (DP, cohort) budget;
        raises `pool.EpsilonExhausted` before any device work when a budget
        cannot cover it (charges already made for other DPs of the same
        advance stay spent, the conservative direction)."""
        if self.epsilon_ledger is None:
            return
        for d in self.cluster.dp_idents:
            self.epsilon_ledger.charge(d.name, self.cohort,
                                       self.epsilon_per_advance)
            self.counters["epsilon_charges"] += 1

    # -- the VNs' pane verdict memo -------------------------------------------

    def verify_pane_blob(self, data: bytes) -> bool:
        """Range-check one pane blob, memoized by its digest for the
        stream's life. Sound because a blob is immutable and
        self-contained: its Fiat-Shamir transcripts bind the ciphertexts
        it carries."""
        dg = hashlib.sha256(data).digest()
        with self._verify_lock:
            if dg in self._verify_memo:
                self.counters["pane_verify_hits"] += 1
                return self._verify_memo[dg]
        cluster = self.cluster
        lst = rp.RangeProofList.from_bytes(data, cluster.device)
        ok = bool(rp.verify_range_proof_list(
            lst, self._ranges_v, cluster._sigs_pub_by_u(),
            cluster.coll_tbl.table))
        with self._verify_lock:
            self._verify_memo[dg] = ok
            self.counters["pane_verifies"] += 1
        return ok

    # -- the window advance ---------------------------------------------------

    def advance(self, precharged: bool = False) -> StreamAdvance:
        """Seal the buffered panes, slide the window over them and run the
        survey's tail (delta fold, DRO noise for a DiffP stream, key switch,
        decryption, decode), delivering only the CNs' aggregation proofs.
        `precharged=True` skips the engine's own epsilon charge."""
        for _ in range(self.sealable_panes()):
            self._seal_next_pane()
        if not self._panes:
            raise ValueError(
                f"stream {self.stream_id}: no sealed panes "
                f"(feed at least pane_width={self.pane_width} rows per DP)")
        new_last = len(self._panes) - 1
        new_first = max(0, len(self._panes) - self.window_panes)
        if not precharged:
            self.charge_epsilon()
        tm = self.timers
        cluster = self.cluster
        dev = cluster.device

        # --- the delta fold ------------------------------------------------
        tm.start("DeltaFold")
        expired = list(range(self._win_first,
                             min(new_first, self._win_last + 1)))
        added = list(range(max(self._win_last + 1, new_first), new_last + 1))
        with cluster._proof_device_lock:
            if self.window_ct is None:
                agg = topo.fold_cts(torch.stack(
                    [self._panes[i].fold
                     for i in range(new_first, new_last + 1)]))
            else:
                agg = slide_window(self.window_ct,
                                   [self._panes[i].fold for i in expired],
                                   [self._panes[i].fold for i in added])
            _sync(dev)
        self.window_ct = agg
        tm.end("DeltaFold")

        # --- the advance's survey: the CNs' aggregation proofs only --------
        sid = f"{self.stream_id}-w{new_first}-{new_last}"
        sq = cluster.generate_survey_query(
            self.op_name, self.query_min, self.query_max,
            proofs=1 if self.proofs_on else 0, ranges=self.ranges,
            diffp=self.sq_proto.query.diffp, survey_id=sid)
        survey = Survey(sq)
        survey.stream = self
        cluster.surveys[sid] = survey
        if self.proofs_on:
            tm.start("ProofDeliver")
            cluster.vns.register_survey(
                sid, len(cluster.cns),
                {"aggregation": sq.aggregation_proof_threshold},
                expected_range=0)
            stack = torch.stack([self._panes[i].fold
                                 for i in range(new_first, new_last + 1)])
            agg_bytes = _once(lambda: pickle.dumps(
                agg_proof.create_aggregation_proof(stack, agg)))
            with cluster._proof_device_lock:
                for cn in cluster.cns:
                    req = rq.new_proof_request(
                        "aggregation", sid, cn.name, f"aggregation-{cn.name}",
                        0, agg_bytes(), cn.secret)
                    cluster.vns.deliver(req)
            tm.end("ProofDeliver")

        # --- DRO noise: the pool first, fresh precomputation last ----------
        work = agg
        q = sq.query
        if q.diffp.enabled():
            tm.start("DROPhase")
            d = q.diffp
            noise = dro.generate_noise_values(
                d.noise_list_size, d.lap_mean, d.lap_scale, d.quanta,
                d.scale, d.limit)
            gen = self._generator(_DRO, new_first, new_last)
            with cluster._proof_device_lock:
                n_cts = dro.encrypt_noise(cluster.coll_tbl, noise, gen,
                                          base_tbl=cluster.base_table)
                S = int(n_cts.shape[0])
                for ci in range(len(cluster.cns)):
                    pc = None
                    if cluster.pool is not None:
                        got = cluster.pool.try_consume_dro(
                            cluster._pool_digest, S)
                        if got is not None:
                            pc = dro.to_device(got[0], got[1], dev)
                    if pc is None:
                        log.lvl2(f"stream {self.stream_id}: pool short, "
                                 f"fresh DRO precompute (cn {ci})")
                        pc = dro.precompute_rerandomization(
                            cluster.coll_tbl.table, S, gen,
                            base_tbl=cluster.base_table)
                    n_cts, _perm, _rs = dro.shuffle_rerandomize(
                        n_cts, cluster.coll_tbl.table, gen, precomp=pc)
                idx = torch.arange(self.V, device=dev) % S
                work = eg.ct_add(work, n_cts[idx])
            tm.end("DROPhase")

        # --- key switch, decryption, decode ---------------------------------
        tm.start("KeySwitchingPhase")
        with cluster._proof_device_lock:
            ks_rs = eg.random_scalars(
                (len(cluster.cns), self.V),
                self._generator(_KEYSWITCH, new_first, new_last), dev)
            *_, switched = cluster._key_switch(work, ks_rs)
            dec = cluster._decrypt(switched)
        tm.end("KeySwitchingPhase")
        result = st.decode(self.decode_mode or self.op_name, dec,
                           self.query_min, self.query_max)

        block = None
        if self.proofs_on:
            block = cluster.vns.end_verification(
                sid, timeout=pol.VN_GROUP_WAIT_S)
        # keep the survey map bounded: the latest advance's record and the
        # live window's pane records stay (an expired pane's proofs are
        # committed; nothing routes its id through vrange again)
        if self._last_sid is not None:
            cluster.surveys.pop(self._last_sid, None)
        for pid in expired:
            cluster.surveys.pop(self.pane_sid(pid), None)
        self._last_sid = sid
        self._win_first, self._win_last = new_first, new_last
        self.counters["advances"] += 1
        return StreamAdvance(survey_id=sid, result=result, decrypted=dec,
                             window=(new_first, new_last),
                             panes_new=len(added),
                             panes_expired=len(expired), block=block)


__all__ = ["StreamEngine", "StreamAdvance", "Pane", "ADDITIVE_OPS",
           "slide_window", "pane_seed"]
