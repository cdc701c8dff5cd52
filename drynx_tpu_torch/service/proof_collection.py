"""VN-side proof collection: receive signed proofs, verify (sampled), build
the per-survey bitmap, persist everything, and commit an audit block.

The port's counterpart of drynx_tpu/service/proof_collection.py, itself
mirroring the reference's ProofCollectionProtocol + VN service state
(protocols/proof_collection_protocol.go:84-406,
services/service_skipchain.go:31-170): each VN keeps, per survey, the
expected proof count (from query_to_proofs_nbrs), a bitmap mapping proof keys
to codes, and a proofdb bucket of raw proof bytes; when the counter reaches
zero the root VN aggregates every VN's bitmap into one DataBlock and appends
it to the audit chain.

In-process, delivery is a direct fan-out to each VerifyingNode through
`transport.local_call`, so an installed fault plan can kill, pause or delay
a VN: a faulted VN never sees the proof. A payload that makes its verifier
raise fails for itself (BM_FALSE); a fault of the program or the card
(`cuda_build.is_fault`) propagates out of `receive_proof`. A held survey's
range payloads stay buffered until `flush_ranges_cross` checks several
held surveys in one RLC batch. A quorum-degraded survey lowers the
counters to its responders (`adjust_expected`, or at registration), and
`end_verification(quorum=)` commits a block from the VNs that reported.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..proofs import requests as rq
from ..resilience import policy as rp
from ..utils import log
from ..utils.cuda_build import is_fault
from ..utils.timers import PhaseTimers
from .skipchain import DataBlock, SkipChain, bitmap_verifier
from .store import ProofDB
from . import transport as tr


@dataclasses.dataclass
class SurveyProofState:
    expected: int                      # total proofs this VN will receive
    bitmap: dict[str, int] = dataclasses.field(default_factory=dict)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # batched range verification: payloads buffered until all expected
    # range proofs arrived, then verified JOINTLY (one RLC / final exp for
    # the whole survey instead of one per DP payload)
    expected_range: int = 0
    pending_range: dict = dataclasses.field(default_factory=dict)
    range_flushed: bool = False
    # held: the buffered range payloads wait for a cross-survey flush
    # (flush_ranges_cross) instead of flushing when the last one arrives
    hold_range: bool = False


# One payload verification at a time per process: verification throughput
# comes from batching inside one call, not from thread overlap.
_VERIFY_DEVICE_LOCK = rp.named_lock("verify_device_lock")


class VerifyCache:
    """Process-local memoization of payload-verification verdicts, keyed by
    (proof type, survey, payload digest).

    Payload verification is a PURE function of (payload bytes, survey
    context). When several co-located VNs — one process simulating a whole
    roster (LocalCluster) — receive the SAME bytes,
    re-running the verification kernels is wasted wall-clock that real VNs
    would spend in PARALLEL on separate machines (the reference's 7 VNs
    each verify on their own box; its headline wall time counts that once).
    The cache is strictly per-process: distributed deployments (one node
    per process) still verify everything independently. Schnorr signature
    checks and the per-VN sampling draws are NOT cached.

    Soundness caveat: the joint-range RLC verdict is
    PROBABILISTIC — each verify draws a secret 62-bit weight vector — so
    sharing one cached verdict across co-located VNs collapses n_vns
    independent draws into one: the RLC soundness parameter is per-process
    (~2^-62 after the order-n gate, crypto/gt.gt_order_ok), not
    per-VN (~2^-62·n_vns). Distributed deployments keep independent draws.
    An undeduped control (``VerifyCache(maxsize=0)``) measures the
    per-VN-independent cost.
    """

    def __init__(self, maxsize: int = 256):
        self._d: dict = {}
        self._lock = rp.named_lock("verify_cache_lock")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        """Drop all memoized verdicts (hit/miss counters keep running).

        A benchmark calls this between timed runs: successive
        LocalCluster surveys over the same seed re-send byte-identical
        payloads, so without the clear every verify in run N>1 is a cache
        HIT from the warmup run and the timed number silently excludes
        verification compute entirely."""
        with self._lock:
            self._d.clear()

    def get_or_compute(self, key, compute):
        if self.maxsize == 0:      # caching disabled (undeduped control)
            return compute()
        with self._lock:
            if key in self._d:
                self.hits += 1
                v = self._d.pop(key)
                self._d[key] = v      # LRU refresh
                return v
        v = compute()
        with self._lock:
            self.misses += 1
            self._d[key] = v
            while len(self._d) > self.maxsize:
                self._d.pop(next(iter(self._d)))
        return v


class _LockedRng:
    """Thread-safe sampling draws: remote deliveries arrive on concurrent
    transport handler threads and np.random.Generator is NOT thread-safe —
    concurrent draws can corrupt generator state."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._lock = rp.named_lock("locked_rng_lock")

    def random(self) -> float:
        with self._lock:
            return float(self._rng.random())


class VerifyingNode:
    """One VN: verifies incoming proof envelopes and tracks bitmaps."""

    def __init__(self, name: str, db_path: str,
                 pubs: dict[str, tuple],
                 verify_fns: Optional[dict[str, Callable[[bytes], bool]]] = None,
                 seed: int = 0,
                 verify_cache: Optional[VerifyCache] = None):
        self.name = name
        self.db = ProofDB(db_path)
        self.pubs = pubs                      # sender id -> G1 affine pub
        self.verify_fns = verify_fns or {}    # proof type -> payload verifier
        self.rng = _LockedRng(np.random.default_rng(seed))
        # pass ONE shared cache to co-located VNs (LocalCluster) so
        # identical payloads verify once per process, not once per VN
        self.verify_cache = verify_cache or VerifyCache()
        self.surveys: dict[str, SurveyProofState] = {}
        self.local_bitmaps: dict[str, dict[str, int]] = {}
        self.chain = SkipChain(self.db,
                               [bitmap_verifier(self.local_bitmaps)])
        self._lock = rp.named_lock("verifying_node_lock")

    # -- reference HandleSurveyQueryToVN (service_skipchain.go:31-93)
    def register_survey(self, survey_id: str, expected_proofs: int,
                        thresholds: dict[str, float],
                        expected_range: int = 0,
                        hold_range: bool = False) -> None:
        with self._lock:
            self.surveys[survey_id] = SurveyProofState(
                expected=expected_proofs, expected_range=expected_range,
                hold_range=hold_range)
            self.thresholds = getattr(self, "thresholds", {})
            self.thresholds[survey_id] = thresholds

    # -- reference ProofCollectionProtocol.Dispatch + storeProof (:183-406)
    def receive_proof(self, req: rq.ProofRequest) -> int:
        st = self.surveys.get(req.survey_id)
        if st is None:
            raise KeyError(f"unknown survey {req.survey_id!r}")
        joint = self.verify_fns.get("range_joint")
        if (req.proof_type == "range" and st.expected_range > 1
                and joint is not None):
            return self._receive_range_buffered(req, st, joint)
        sample = self.thresholds.get(req.survey_id, {}).get(req.proof_type, 1.0)
        pub = self.pubs.get(req.sender_id)
        t0 = time.perf_counter()
        vfn = self.verify_fns.get(req.proof_type)
        if vfn is not None:
            import hashlib

            def vfn(data, sid, _base=vfn, _pt=req.proof_type):
                key = (_pt, sid, hashlib.sha256(data).digest())

                def compute():
                    with _VERIFY_DEVICE_LOCK:
                        return _base(data, sid)

                return self.verify_cache.get_or_compute(key, compute)
        code = (rq.BM_BADSIG if pub is None else rq.verify_proof_request(
            req, pub, sample, vfn, self.rng))
        self._echo_verify(req, t0, code)
        self._record(st, req.storage_key(), req.data, code)
        return code

    def _echo_verify(self, req, t0: float, code: int) -> None:
        if PhaseTimers.echo:
            import sys

            print(f"    [vn] {self.name} verify {req.proof_type} from "
                  f"{req.sender_id}: {time.perf_counter() - t0:.3f}s "
                  f"code={code}", file=sys.stderr, flush=True)

    def _record(self, st: SurveyProofState, key: str, data: bytes,
                code: int) -> None:
        with self._lock:
            st.bitmap[key] = code
            self.db.put(key, data)
            remaining = st.expected - len(st.bitmap)
        if code not in (rq.BM_TRUE, rq.BM_RECVD):
            log.warn(f"VN {self.name}: proof {key} -> code {code}")
        log.lvl3(f"VN {self.name}: {key} code={code}, "
                 f"{remaining} proofs outstanding")
        if remaining <= 0:
            st.done.set()

    def _receive_range_buffered(self, req: rq.ProofRequest,
                                st: SurveyProofState, joint) -> int:
        """Buffer range payloads; when the last expected one arrives, verify
        every sampled payload in ONE joint RLC check (the VN's dominant
        cost — reference timeline: 21.73 s of range verification per query).
        Signatures and the sampling draw stay per payload."""
        sample = self.thresholds.get(req.survey_id, {}).get("range", 1.0)
        pub = self.pubs.get(req.sender_id)
        bad_sig = pub is None or not rq.verify_signature(req, pub)
        if bad_sig:
            # record the code NOW but still count this delivery toward the
            # flush threshold (a tombstone) — otherwise one malformed
            # sender stalls the joint flush and denies the whole survey
            self._record(st, req.storage_key(), req.data, rq.BM_BADSIG)
        sampled = (not bad_sig) and bool(self.rng.random() <= sample)
        with self._lock:
            if st.range_flushed:  # late re-delivery: keep the flushed code
                return st.bitmap.get(req.storage_key(), rq.BM_RECVD)
            st.pending_range[req.storage_key()] = (req, sampled, bad_sig)
            pending = None
            if (not st.hold_range
                    and len(st.pending_range) >= st.expected_range):
                st.range_flushed = True
                pending = dict(st.pending_range)
        if pending is None:
            return rq.BM_BADSIG if bad_sig else rq.BM_RECVD
        self._flush_range(st, req.survey_id, pending, joint)
        return st.bitmap[req.storage_key()]

    def _flush_range(self, st: SurveyProofState, survey_id: str,
                     pending: dict, joint) -> None:
        """Joint-verify a snapshot of buffered range payloads and record
        their codes. The caller must have set st.range_flushed under the
        lock before snapshotting (exactly one flush per survey)."""
        t0 = time.perf_counter()
        keys = sorted(pending)
        to_verify = [k for k in keys if pending[k][1]]

        def compute():
            # exceptions PROPAGATE out of the cache (never memoized): a
            # transient crash in one VN's flush must not poison every
            # co-located VN's verdict for the process lifetime
            with _VERIFY_DEVICE_LOCK:
                return joint([pending[k][0].data for k in to_verify],
                             survey_id)

        results: list = []
        if to_verify:
            import hashlib

            h = hashlib.sha256()
            for k in to_verify:
                h.update(hashlib.sha256(pending[k][0].data).digest())
            try:
                results = self.verify_cache.get_or_compute(
                    ("range_joint", survey_id, h.digest()), compute)
            except Exception as e:
                if is_fault(e):
                    raise
                # malformed payloads are FAILED verifications for THIS
                # flush only (mirrors rq.verify_proof_request containment)
                import traceback

                log.warn(f"VN {self.name}: joint range verify raised: "
                         f"{traceback.format_exc(limit=8)}")
                results = [False] * len(to_verify)
        self._record_verdicts(st, pending, dict(zip(to_verify, results)))
        if PhaseTimers.echo:
            import sys

            print(f"    [vn] {self.name} JOINT range verify of "
                  f"{len(to_verify)}/{len(keys)} payloads: "
                  f"{time.perf_counter() - t0:.3f}s", file=sys.stderr,
                  flush=True)

    def _record_verdicts(self, st: SurveyProofState, pending: dict,
                         verdicts: dict) -> None:
        """Record a flushed survey's codes: BM_TRUE or BM_FALSE for each
        sampled payload by its verdict, BM_RECVD for one not sampled (a
        bad signature was recorded at arrival)."""
        for k in sorted(pending):
            r, was_sampled, was_bad = pending[k]
            if was_bad:
                continue
            code = (rq.BM_TRUE if verdicts.get(k)
                    else rq.BM_FALSE) if was_sampled else rq.BM_RECVD
            self._record(st, k, r.data, code)

    def range_ready(self, survey_id: str) -> bool:
        """True once every expected range payload is buffered (or the
        survey needs no joint flush): the gate before a cross flush."""
        st = self.surveys.get(survey_id)
        if st is None:
            return False
        with self._lock:
            if st.expected_range <= 1 or st.range_flushed:
                return True
            return len(st.pending_range) >= st.expected_range

    def flush_ranges_cross(self, survey_ids: list) -> list:
        """Flush several held surveys' buffered range payloads in one
        cross-survey check (verify_fns["range_cross"]): one RLC batch and
        one final exponentiation for the whole batch, the verdicts split
        back out per survey. Without a cross function each survey flushes
        jointly on its own. A survey not ready, unknown or already flushed
        is skipped. If the check raises, every payload of this flush gets
        BM_FALSE (never memoized); a fault of the program or the card
        propagates. Returns the survey ids flushed here."""
        cross = self.verify_fns.get("range_cross")
        joint = self.verify_fns.get("range_joint")
        snap: dict[str, dict] = {}
        with self._lock:
            for sid in survey_ids:
                st = self.surveys.get(sid)
                if st is None or st.range_flushed or st.expected_range <= 0:
                    continue
                if len(st.pending_range) < st.expected_range:
                    continue
                st.range_flushed = True
                snap[sid] = dict(st.pending_range)
        if not snap:
            return []
        if cross is None:
            for sid, pending in snap.items():
                self._flush_range(self.surveys[sid], sid, pending, joint)
            return list(snap)
        t0 = time.perf_counter()
        to_verify = {sid: [k for k in sorted(p) if p[k][1]]
                     for sid, p in snap.items()}
        payloads = {sid: [snap[sid][k][0].data for k in keys]
                    for sid, keys in to_verify.items() if keys}

        def compute():
            with _VERIFY_DEVICE_LOCK:
                return cross(payloads)

        verdicts_by_sid: dict[str, list] = {}
        if payloads:
            import hashlib

            h = hashlib.sha256()
            for sid in sorted(payloads):
                h.update(sid.encode())
                for data in payloads[sid]:
                    h.update(hashlib.sha256(data).digest())
            try:
                verdicts_by_sid = self.verify_cache.get_or_compute(
                    ("range_cross", h.digest()), compute)
            except Exception as e:
                if is_fault(e):
                    raise
                import traceback

                log.warn(f"VN {self.name}: cross-survey range verify "
                         f"raised: {traceback.format_exc(limit=8)}")
                verdicts_by_sid = {sid: [False] * len(p)
                                   for sid, p in payloads.items()}
        for sid, pending in snap.items():
            self._record_verdicts(self.surveys[sid], pending, dict(zip(
                to_verify[sid], verdicts_by_sid.get(sid, []))))
        if PhaseTimers.echo:
            import sys

            n_pay = sum(len(v) for v in payloads.values())
            print(f"    [vn] {self.name} CROSS-SURVEY range verify of "
                  f"{n_pay} payloads across {len(snap)} surveys: "
                  f"{time.perf_counter() - t0:.3f}s", file=sys.stderr,
                  flush=True)
        return list(snap)

    def adjust_expected(self, survey_id: str, drop: int,
                        expected_range: Optional[int] = None) -> None:
        """Quorum-degraded survey: `drop` DPs went absent, so their proofs
        never come. Lowers the expected-proof counter and (when given) the
        joint range flush's threshold to the responder set; fires the
        joint flush if the buffered payloads already meet it, and the done
        event if the bitmap already covers the counter (reference
        proof_collection.py:399)."""
        st = self.surveys.get(survey_id)
        if st is None:
            raise KeyError(f"unknown survey {survey_id!r}")
        joint = self.verify_fns.get("range_joint")
        pending = None
        with self._lock:
            st.expected = max(0, st.expected - int(drop))
            if expected_range is not None:
                st.expected_range = int(expected_range)
            if (not st.range_flushed and not st.hold_range
                    and joint is not None
                    and 0 < st.expected_range <= len(st.pending_range)):
                st.range_flushed = True
                pending = dict(st.pending_range)
        if pending is not None:
            self._flush_range(st, survey_id, pending, joint)
        with self._lock:
            if st.expected - len(st.bitmap) <= 0:
                st.done.set()

    def bitmap_for(self, survey_id: str) -> dict[str, int]:
        st = self.surveys[survey_id]
        return dict(st.bitmap)

    def stored_proofs(self, survey_id: str) -> dict[str, bytes]:
        """Reference HandleGetProofs (service_skipchain.go:240-320)."""
        out = {}
        for k in self.db.keys():
            ks = k.decode(errors="replace")
            if ks.startswith(survey_id + "/"):
                out[ks] = self.db.get(k)
        return out


class VNGroup:
    """The VN roster: root VN aggregates bitmaps and commits the block
    (reference service_skipchain.go:95-170)."""

    def __init__(self, vns: list[VerifyingNode]):
        if not vns:
            raise ValueError("empty VN roster")
        self.vns = vns
        self.root = vns[0]
        # {survey id: names of the VNs a delivery of it did not reach}
        self._missed: dict[str, set] = {}
        self._missed_lock = rp.named_lock("vn_missed_lock")

    def register_survey(self, survey_id: str, expected_proofs: int,
                        thresholds: dict[str, float],
                        expected_range: int = 0,
                        hold_range: bool = False) -> None:
        for vn in self.vns:
            vn.register_survey(survey_id, expected_proofs, thresholds,
                               expected_range=expected_range,
                               hold_range=hold_range)

    def deliver(self, req: rq.ProofRequest) -> list:
        """Star fan-out: every VN receives and verifies the proof; returns
        their codes. Each delivery goes through `transport.local_call`, so
        an installed fault plan can fault a VN: its slot is None, and its
        counter for the survey stays up (the straggler that
        `end_verification`'s quorum tolerates)."""
        codes: list = []
        for vn in self.vns:
            try:
                codes.append(tr.local_call(vn.name, req.proof_type,
                                           vn.receive_proof, req))
            except tr.TransportError as e:
                log.warn(f"VN {vn.name}: delivery faulted: {e}")
                with self._missed_lock:
                    self._missed.setdefault(req.survey_id, set()).add(
                        vn.name)
                codes.append(None)
        return codes

    def flush_cross_survey(self, survey_ids: list) -> list:
        """The cross-survey flush on every VN (held surveys only); the
        shared verification cache makes VNs 2..n hits for the same batch.
        Returns the root VN's flushed survey ids."""
        out = []
        for vn in self.vns:
            flushed = vn.flush_ranges_cross(survey_ids)
            if vn is self.root:
                out = flushed
        return out

    def end_verification(self, survey_id: str,
                         timeout: float = rp.VN_GROUP_WAIT_S,
                         quorum: float = 1.0):
        """Blocks until every VN's proof counter drained, or, with
        ``quorum`` < 1.0, until that fraction of VNs is done; then the root
        VN funnels the reporting VNs' bitmaps together and commits one
        audit block (reference HandleEndVerification + the
        bitmap-aggregation goroutine). All VNs share ONE deadline, so a
        straggler costs at most ``timeout``. A VN that a delivery of this
        survey did not reach never drains: once too few VNs are left to
        meet the quorum, the wait raises at once (the reference waits out
        its deadline), with the reference's TimeoutError naming the first
        VN not done."""
        # the epsilon guards float fractions: 2/3 * 3 == 2.0000000000000004,
        # which a bare ceil would round up to all 3 VNs
        need = max(1, math.ceil(quorum * len(self.vns) - 1e-9))
        deadline = time.monotonic() + timeout
        while True:
            ready = [vn for vn in self.vns
                     if vn.surveys[survey_id].done.is_set()]
            if len(ready) >= len(self.vns):
                break
            if need < len(self.vns) and len(ready) >= need:
                break  # quorum met; don't serialize behind stragglers
            with self._missed_lock:
                lost = len(self._missed.get(survey_id, ()))
            if (time.monotonic() >= deadline
                    or len(self.vns) - lost < need):
                if len(ready) >= need:
                    break
                straggler = next(vn for vn in self.vns
                                 if not vn.surveys[survey_id].done.is_set())
                raise TimeoutError(
                    f"VN {straggler.name}: proofs incomplete for "
                    f"{survey_id!r}")
            time.sleep(rp.POLL_INTERVAL_S)
        merged: dict[str, int] = {}
        for vn in ready:
            for k, v in vn.bitmap_for(survey_id).items():
                merged[f"{vn.name}:{k}"] = v
        # drynx: deterministic[sample_time is excluded from transcripts]
        block_data = DataBlock(survey_id=survey_id, sample_time=time.time(),
                               bitmap=merged)
        self.root.local_bitmaps[survey_id] = merged
        return self.root.chain.append(block_data)


__all__ = ["SurveyProofState", "VerifyingNode", "VNGroup", "VerifyCache"]
