"""Node roles over the TCP control plane, one `DrynxNode` per process.

The port's counterpart of drynx_tpu/service/node.py. The role (CN, DP or
VN) comes from the node's place in the roster, as in the reference's
single binary (cmd/README.md:13-18). With proofs on, every proof runs in
the process of the node that makes it:

  client --vn_register--> each VN      (expected counts, verify context)
  client --survey_query--> root CN
     root CN --range_sig--> each CN    (BB digit signatures per base u)
     root CN --survey_dp--> the DPs    (encode + encrypt; range proofs to
                                        the VNs, or up the relay tree)
     root CN folds the ciphertexts     (aggregation proof to the VNs)
     root CN --obf_contrib--> each CN  (obfuscation chain, with proofs)
     root CN --shuffle_contrib--> each CN (DRO noise shuffle, with proofs)
     root CN --ks_contrib--> each CN   (key switch, with proofs)
  client <-- switched ciphertexts; decrypts with its own key
  client --end_verification--> root VN (counter-gated bitmaps + block)

A node's tensors live on its device, the card unless the CPU is named:
ciphertexts decode from the wire onto it (`transport.
unpack_array_device`), and encryption, proofs and checks run there through
the kernels of `crypto.cuda_ops` and `crypto.cuda_pairing`. Each handler
call draws its randomness from a fresh `torch.Generator` on the node's
device, seeded from the OS (`secrets.randbits(63)`). Limb tensors travel
as uint32 arrays, as the reference ships them. State that the handler
threads of one process share is built once under a lock: the fixed-base
table of a key and the range signatures' GT tables.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import pickle
import secrets
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import pool as pool_mod
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import refimpl
from ..encoding import stats as st
from ..models import logreg as lr
from ..parallel import dro
from ..proofs import aggregation as agg_proof
from ..proofs import keyswitch as ks_proof
from ..proofs import obfuscation as obf_proof
from ..proofs import range_proof as rproof
from ..proofs import requests as rq
from ..proofs import schnorr
from ..proofs import shuffle as shuffle_proof
from ..proofs.safe_pickle import safe_loads
from ..resilience import policy as rp
from ..utils import log
from ..utils.device import resolve
from . import topology as topo
from . import transport as tr
from .proof_collection import VerifyingNode
from .skipchain import Block, DataBlock
from .store import SurveyCheckpoint
from .transport import (ConnectError, RemoteError, TransportError,
                        pack_array, set_current_node, unpack_array)


def _net_delta(before: dict, after: dict) -> dict:
    """The link model's counters over one survey."""
    peers = {k: v - before["by_peer"].get(k, 0)
             for k, v in after["by_peer"].items()}
    rx = {k: v - before.get("rx_by_node", {}).get(k, 0)
          for k, v in after.get("rx_by_node", {}).items()}
    return {"bytes_total": after["bytes_total"] - before["bytes_total"],
            "msgs_total": after["msgs_total"] - before["msgs_total"],
            "by_peer": {k: v for k, v in peers.items() if v},
            "rx_by_node": {k: v for k, v in rx.items() if v}}


def _pack_bytes(b: bytes) -> dict:
    return pack_array(np.frombuffer(b, dtype=np.uint8))


def _unpack_bytes(d: dict) -> bytes:
    return unpack_array(d).tobytes()


def _pack_limbs(t: torch.Tensor) -> dict:
    """int32 limb tensor -> the wire's uint32 array."""
    return pack_array(t.detach().cpu().numpy().view(np.uint32))


def _limbs(d: dict, device) -> torch.Tensor:
    """A uint32 limb field -> int32 limbs on `device` (16-bit values, so
    the reinterpretation is exact)."""
    t = tr.unpack_array_device(d, device)
    return t.view(torch.int32) if t.dtype == torch.uint32 else \
        t.to(torch.int32)


def _fresh_generator(device) -> torch.Generator:
    """OS entropy per handler call: blinding scalars must not follow from
    survey metadata and must differ across runs of one survey."""
    return torch.Generator(device=device).manual_seed(secrets.randbits(63))


def call_entry(entry, msg: dict, retries: Optional[int] = None,
               timeout: Optional[float] = None,
               policy: Optional[rp.RetryPolicy] = None) -> dict:
    """One request/response to a roster entry under a RetryPolicy, on a
    connection of the process's pool.

    Connect failures and failed idempotent calls (`rp.is_idempotent`)
    retry with backoff on a fresh connection; once any byte of a
    non-idempotent request was written, the failure surfaces at once (a
    re-send could run the handler twice). A RemoteError always surfaces:
    the handler ran. `retries`/`timeout` override the policy's fields for
    this call. A connection goes back to the pool after a success or a
    RemoteError, and is discarded after any transport failure."""
    pol = policy or rp.DEFAULT_POLICY
    if retries is not None:
        pol = dataclasses.replace(pol, connect_retries=int(retries))
    if timeout is not None:
        pol = dataclasses.replace(pol, call_timeout_s=float(timeout))
    mtype = msg.get("type", "")
    pool = tr.conn_pool()
    attempt = 0
    while True:
        conn = None
        try:
            conn = pool.get(entry.host, entry.port,
                            timeout=pol.call_timeout_s, peer=entry.name)
            reply = conn.call(msg)
        except RemoteError:
            pool.put(conn)
            raise
        except (TransportError, OSError) as e:
            sent = conn.sent if conn is not None else False
            pool.discard(conn)
            attempt += 1
            if attempt >= pol.attempts_for(mtype, sent):
                if sent:
                    raise
                raise ConnectError(
                    f"node {entry.name} at {entry.host}:{entry.port} "
                    f"unreachable after {attempt} attempts: {e!r}") from e
            time.sleep(pol.backoff(attempt - 1))
        else:
            pool.put(conn)
            return reply


def _fan(entries, make_msg: Callable, call: Callable) -> list:
    """`call(entry, msg)` for each entry on `transport.fan_out`'s bounded
    pool, the messages built first on the caller's thread; results in
    roster order."""
    pairs = [(e, make_msg(e)) for e in entries]
    return tr.fan_out(pairs, lambda em: call(*em))


def _fan_entries(entries, make_msg: Callable,
                 policy: Optional[rp.RetryPolicy] = None) -> list:
    return _fan(entries, make_msg,
                lambda e, m: call_entry(e, m, policy=policy))


@dataclasses.dataclass
class RosterEntry:
    name: str
    role: str          # "cn" | "dp" | "vn"
    host: str
    port: int
    public: tuple      # affine ints


@dataclasses.dataclass
class Roster:
    entries: list

    def of_role(self, role: str) -> list:
        return [e for e in self.entries if e.role == role]

    def collective_pub(self) -> tuple:
        acc = None
        for e in self.of_role("cn"):
            acc = refimpl.g1_add(acc, e.public)
        return acc

    def to_dict(self) -> dict:
        return {"entries": [dataclasses.asdict(e) for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "Roster":
        return cls([RosterEntry(**{**e, "public": tuple(e["public"])})
                    for e in d["entries"]])


# Process-wide tables shared by every node of a process, each built once
# under its lock: the fixed-base table of a public key on a device, and
# the range signatures (with their GT tables) of a signature set.
_TABLES: dict = {}
_TABLES_LOCK = rp.named_lock("node_tables_lock")
_SIGS: dict = {}
_SIGS_LOCK = rp.named_lock("node_sigs_lock")


def pub_table(pub: tuple, device) -> eg.FixedBase:
    """The fixed-base table of `pub` on `device` (built on the host once
    per process, ~1,000 host point additions)."""
    key = (tuple(int(t) for t in pub), str(device))
    with _TABLES_LOCK:
        fb = _TABLES.get(key)
        if fb is None:
            fb = eg.pub_table(key[0])
            fb.table = fb.table.to(device)
            _TABLES[key] = fb
        return fb


def base_table(device) -> torch.Tensor:
    key = ("base", str(device))
    with _TABLES_LOCK:
        t = _TABLES.get(key)
        if t is None:
            t = _TABLES[key] = eg.BASE_TABLE.table.to(device)
        return t


class DrynxNode:
    """A node serving its role's handlers over a `NodeServer`, on `device`
    (the card unless the CPU is named). `pool` (a `pool.CryptoPool`) is
    activated before any table is built: it serves the signature and
    fixed-base tables and the shuffle's DRO slabs. The root's survey
    checkpoints are kept in memory (the reference's DRYNX_CKPT_PERSIST
    store has no caller here)."""

    def __init__(self, name: str, secret: int, public: tuple,
                 host: str = "127.0.0.1", port: int = 0,
                 data=None, db_path: Optional[str] = None,
                 policy: Optional[rp.RetryPolicy] = None,
                 pool=None, device=None):
        self.name = name
        self.secret = secret
        self.public = public
        self.data = data
        self.device = resolve(device)
        if pool is not None:
            pool_mod.activate(pool)
        # every outbound call of this node runs under one RetryPolicy
        self.policy = policy or rp.DEFAULT_POLICY
        self.server = tr.NodeServer(host, port, node_name=name)
        self.roster: Optional[Roster] = None
        self.vn: Optional[VerifyingNode] = None
        self._db_path = db_path or os.path.join(tempfile.gettempdir(),
                                                f"drynx_node_{name}.db")
        self._range_sigs: dict[int, rproof.RangeSig] = {}  # CN role, per u
        self._survey_ctx: dict[str, dict] = {}             # VN role
        self._proof_threads: dict[str, list] = {}          # prover roles
        # DP role: each survey's contribution, computed at most once, so a
        # tree re-dispatch replays the same ciphertext bytes and the range
        # proof fires once (pruned past rp.DP_REPLY_CACHE_MAX finished)
        self._dp_replies: dict[str, dict] = {}
        # root CN role: phase checkpoints, and ALIVE probe verdicts
        # cached for rp.PROBE_TTL_S
        self._ckpts: dict[str, SurveyCheckpoint] = {}
        self._probe_cache: dict[str, float] = {}
        self._state_lock = rp.named_lock("node_state_lock")

        s = self.server
        s.register("set_roster", self._h_set_roster)
        s.register("survey_query", self._h_survey_query)
        s.register("survey_dp", self._h_survey_dp)
        s.register("range_sig", self._h_range_sig)
        s.register("obf_contrib", self._h_obf_contrib)
        s.register("shuffle_contrib", self._h_shuffle_contrib)
        s.register("ks_contrib", self._h_ks_contrib)
        s.register("proof_request", self._h_proof_request)
        s.register("proof_batch", self._h_proof_batch)
        s.register("vn_register", self._h_vn_register)
        s.register("vn_adjust", self._h_vn_adjust)
        s.register("vn_bitmap", self._h_vn_bitmap)
        s.register("end_verification", self._h_end_verification)
        # the skipchain RPCs a remote querier audits with (reference
        # services/service_skipchain.go:173-342)
        s.register("get_genesis", self._h_get_block)
        s.register("get_latest", self._h_get_block)
        s.register("get_block", self._h_get_block)
        s.register("get_proofs", self._h_get_proofs)
        s.register("close_db", self._h_close_db)
        s.register("ping", lambda m: {"ok": True, "name": self.name})

    # ------------------------------------------------------------------
    @property
    def address(self):
        return self.server.host, self.server.port

    def start(self):
        self.server.start()

    def stop(self):
        self.server.stop()

    def _table(self, pub: tuple) -> eg.FixedBase:
        return pub_table(pub, self.device)

    # ------------------------------------------------------------------
    def _h_set_roster(self, msg: dict) -> dict:
        self.roster = Roster.from_dict(msg["roster"])
        me = [e for e in self.roster.entries if e.name == self.name]
        if me and me[0].role == "vn" and self.vn is None:
            pubs = {e.name: e.public for e in self.roster.entries}
            self.vn = VerifyingNode(self.name, self._db_path, pubs,
                                    verify_fns=self._vn_verify_fns(), seed=0)
        return {"ok": True}

    # -- the VN's payload verifiers, on this node's device
    def _vn_verify_fns(self):
        dev = self.device

        def ctx_of(sid: str) -> Optional[dict]:
            return self._survey_ctx.get(sid)

        def vrange(data: bytes, sid: str) -> bool:
            ctx = ctx_of(sid)
            if ctx is None:
                return False
            lst = rproof.RangeProofList.from_bytes(data, dev)
            return rproof.verify_range_proof_list(
                lst, ctx["ranges_v"], ctx["sigs_pub_by_u"],
                self._table(ctx["coll_pub"]).table)

        def vrange_joint(datas: list, sid: str) -> list:
            ctx = ctx_of(sid)
            if ctx is None:
                return [False] * len(datas)
            return rproof.verify_range_proof_payloads_joint(
                datas, ctx["ranges_v"], ctx["sigs_pub_by_u"],
                self._table(ctx["coll_pub"]).table)

        def vagg(data: bytes, _sid: str) -> bool:
            return bool(np.all(agg_proof.verify_aggregation_proof(
                safe_loads(data), dev)))

        def vobf(data: bytes, _sid: str) -> bool:
            return bool(np.all(obf_proof.verify_obfuscation_proofs(
                safe_loads(data), dev)))

        def vks(data: bytes, sid: str) -> bool:
            ctx = ctx_of(sid)
            if ctx is None:
                return False
            return bool(np.all(ks_proof.verify_keyswitch_proofs(
                safe_loads(data), self._table(ctx["client_pub"]).table)))

        def vshuffle(data: bytes, sid: str) -> bool:
            ctx = ctx_of(sid)
            if ctx is None:
                return False
            proof, in_cts, out_cts = safe_loads(data)
            # the lists come unpickled on the host: one upload each
            return shuffle_proof.verify_shuffle(
                proof, torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
                    np.asarray(in_cts, np.int32)).to(dev),
                torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
                    np.asarray(out_cts, np.int32)).to(dev),
                C.from_ref(ctx["coll_pub"]).to(dev))

        return {"range": vrange, "range_joint": vrange_joint,
                "aggregation": vagg, "obfuscation": vobf,
                "keyswitch": vks, "shuffle": vshuffle}

    # -- proof delivery to every VN, on a thread (the reference's goroutine
    # pipeline, data_collection_protocol.go:279-347)
    @staticmethod
    def _proof_fields(req) -> dict:
        """Wire form of one signed ProofRequest (without the mtype): the
        unit a relay hop batches and a VN unbatches."""
        return {"proof_type": req.proof_type, "survey_id": req.survey_id,
                "sender_id": req.sender_id, "differ_info": req.differ_info,
                "round_id": req.round_id, "data": _pack_bytes(req.data),
                "signature": _pack_bytes(req.signature.to_bytes())}

    def _track_proof_thread(self, survey_id: str,
                            t: threading.Thread) -> threading.Thread:
        t.start()
        # drop finished surveys' threads (handlers run on server threads:
        # the dict is shared)
        with self._state_lock:
            for sid in list(self._proof_threads):
                alive = [x for x in self._proof_threads.get(sid, [])
                         if x.is_alive()]
                if alive or sid == survey_id:
                    self._proof_threads[sid] = alive
                else:
                    self._proof_threads.pop(sid, None)
            self._proof_threads.setdefault(survey_id, []).append(t)
        return t

    def _deliver_async(self, survey_id: str, frame: dict,
                       what: str) -> threading.Thread:
        vns = self.roster.of_role("vn")

        def work():
            set_current_node(self.name)   # a fresh thread: re-pin
            outs = _fan_entries(vns, lambda e: dict(frame), self.policy)
            for e, (_r, err) in zip(vns, outs):
                if err is not None:
                    # that VN never counts this proof; end_verification's
                    # counter gate reports the shortfall
                    log.warn(f"{self.name}: {what} undeliverable to VN "
                             f"{e.name}: {err}")

        return self._track_proof_thread(
            survey_id, threading.Thread(target=work, daemon=True))

    def _send_proof_async(self, ptype: str, survey_id: str, differ: str,
                          data: bytes) -> threading.Thread:
        req = rq.new_proof_request(ptype, survey_id, self.name, differ, 0,
                                   data, self.secret)
        return self._fire_proof_request_async(req)

    def _fire_proof_request_async(self, req) -> threading.Thread:
        frame = {"type": "proof_request", **self._proof_fields(req)}
        return self._deliver_async(req.survey_id, frame,
                                   f"{req.proof_type} proof")

    def _send_proof_batch_async(self, survey_id: str,
                                blobs: list) -> threading.Thread:
        """Tree mode: the root delivers the range-proof blobs the tree
        collected as one proof_batch frame per VN, sorted by differ_info so
        every VN receives them in one order."""
        blobs = sorted(blobs, key=lambda b: (b["proof_type"],
                                             b["differ_info"]))
        frame = {"type": "proof_batch", "survey_id": survey_id,
                 "proofs": blobs}
        return self._deliver_async(survey_id, frame, "proof batch")

    # -- CN side: its own BB digit-signature set for base u (reference
    # InitRangeProofSignature, range_proof.go:270-288)
    def _h_range_sig(self, msg: dict) -> dict:
        u = int(msg["u"])
        with self._state_lock:
            if u not in self._range_sigs:
                rng = np.random.default_rng(secrets.randbits(63))
                self._range_sigs[u] = rproof.init_range_sig(u, rng)
            sg = self._range_sigs[u]
        return {"pub": [int(sg.public[0]), int(sg.public[1])],
                "A": _pack_limbs(sg.A)}

    def _sigs_from_msg(self, range_sigs_msg: dict) -> dict:
        """{u: [RangeSig (publics only)]} from the root's wire form (A
        tables stacked (ns, u, 3, 2, 16), publics per CN), with their GT
        tables on this node's device: one set of objects per signature
        set and device in the process, its tables built once."""
        out = {}
        for u_str, blob in range_sigs_msg.items():
            A_all = unpack_array(blob["A"])
            pubs = [tuple(int(t) for t in p) for p in blob["pubs"]]
            key = (hashlib.sha256(A_all.tobytes()).hexdigest(),
                   tuple(pubs), str(self.device))
            with _SIGS_LOCK:
                sigs = _SIGS.get(key)
                if sigs is None:
                    sigs = [rproof.RangeSig(
                        secret=0, public=pubs[i],
                        A=torch.from_numpy(A_all[i].astype(np.int32)))
                        for i in range(A_all.shape[0])]
                    rproof.sig_gt_pow_tables(sigs, self.device)
                    rproof.gt_base_table()
                    _SIGS[key] = sigs
            out[int(u_str)] = sigs
        return out

    # -- DP side: encode + encrypt the local data (survey_dp) and, with
    # proofs on, prove the ranges here (reference service_data_provider.go
    # :48 generateRangePI). Re-entry is idempotent per survey: the
    # contribution is computed once and replayed. Frames carrying
    # "dp_order" take the tree relay path.
    def _h_survey_dp(self, msg: dict) -> dict:
        if msg.get("dp_order") is not None:
            return self._h_survey_dp_relay(msg)
        ent = self._dp_reply_entry(msg)
        fire = None
        with self._state_lock:
            if ent["req"] is not None and not ent["fired"]:
                ent["fired"] = True
                fire = ent["req"]
        if fire is not None:
            self._fire_proof_request_async(fire)
        return {"cts": _pack_limbs(ent["cts"])}

    def _dp_reply_entry(self, msg: dict) -> dict:
        """The survey's contribution, computed at most once: concurrent
        re-entries wait on the entry's lock and read the first result;
        finished foreign surveys are pruned past rp.DP_REPLY_CACHE_MAX in
        insertion order."""
        sid = msg["survey_id"]
        with self._state_lock:
            ent = self._dp_replies.get(sid)
            if ent is None:
                for k in list(self._dp_replies):
                    if len(self._dp_replies) < rp.DP_REPLY_CACHE_MAX:
                        break
                    if self._dp_replies[k]["done"]:
                        del self._dp_replies[k]
                ent = {"lock": threading.Lock(), "done": False,
                       "cts": None, "req": None, "fired": False}
                self._dp_replies[sid] = ent
        with ent["lock"]:
            if not ent["done"]:
                ent["cts"], ent["req"] = self._dp_contribution(msg)
                ent["done"] = True
        return ent

    def _dp_stats(self, msg: dict) -> torch.Tensor:
        """This node's int64 statistics for the survey, on the CPU: the
        log_reg encoding of its (X, y), the grouped encoding over the
        group grid, or the operation's encoding (dummy data when the node
        holds none)."""
        op = msg["op"]
        qmin, qmax = msg["query_min"], msg["query_max"]
        group_by = msg.get("group_by") or None
        # dummy data seeded by sha256(name), the same in every process
        rng = np.random.default_rng(int.from_bytes(
            hashlib.sha256(self.name.encode()).digest()[:4], "big"))
        if op == "log_reg":
            lrp = lr.LRParams(**{
                k: (tuple(v) if isinstance(v, list) else v)
                for k, v in msg["lr_params"].items()})
            if not (isinstance(self.data, tuple) and len(self.data) == 2):
                raise RuntimeError(
                    f"DP {self.name}: log_reg survey but node data is not "
                    "an (X, y) tuple")
            X, y = self.data
            return lr.encode_clear(X, y, lrp).reshape(-1)
        if group_by:
            data, groups = (self.data if isinstance(self.data, tuple)
                            else (self.data, None))
            if data is None:
                data = rng.integers(qmin, max(qmax, 1),
                                    size=(32,)).astype(np.int64)
            if groups is None:
                groups = np.stack(
                    [rng.choice(np.asarray(vals), size=len(data))
                     for vals in group_by], axis=-1).astype(np.int64)
            # group-major, so the element-wise sum is the per-group one
            return st.encode_clear_grouped(
                op, data, groups, st.group_grid(group_by), qmin,
                qmax).reshape(-1)
        data = self.data
        if data is None:
            data = rng.integers(qmin, max(qmax, 1),
                                size=(32,)).astype(np.int64)
        return st.encode_clear(op, data, qmin, qmax).reshape(-1)

    def _dp_contribution(self, msg: dict):
        """Encrypt this node's statistics for one survey: (cts (V, 2, 3,
        16) on the device, the signed range-proof request or None). The
        caller sends the proof to the VNs (star) or up a relay hop
        (tree)."""
        dev = self.device
        stats = self._dp_stats(msg).to(torch.int64)
        # the signed-encoding shift (log_reg's range proofs); the root
        # subtracts responders * offset after the key switch
        range_offset = int(msg.get("range_offset", 0))
        if range_offset:
            if int(stats.abs().max()) >= range_offset:
                raise RuntimeError(
                    f"DP {self.name}: encoding exceeds range-proof bound "
                    f"u^l/2 = {range_offset}")
            stats = stats + range_offset
        tbl = self._table(self.roster.collective_pub())
        gen = _fresh_generator(dev)
        rs = eg.random_scalars((int(stats.shape[0]),), gen, dev)
        cts = eg.encrypt_ints_with_tables(base_table(dev), tbl.table,
                                          stats.to(dev), rs)
        req = None
        if msg.get("proofs"):
            ranges_v = [tuple(r) for r in msg["ranges"]]
            sigs_by_u = self._sigs_from_msg(msg["range_sigs"])
            lst = rproof.create_range_proof_list(
                stats, rs, cts, ranges_v, sigs_by_u, tbl.table,
                generator=_fresh_generator(dev))
            req = rq.new_proof_request("range", msg["survey_id"], self.name,
                                       f"range-{self.name}", 0,
                                       lst.to_bytes(), self.secret)
        return cts, req

    # -- the tree overlay's relay (frames carrying dp_order): contribute,
    # collect the child subtrees, fold everything into one canonical
    # partial and pass the hop's range-proof blobs up, with a hop
    # aggregation proof the parent checks
    def _h_survey_dp_relay(self, msg: dict) -> dict:
        order = list(msg["dp_order"])
        n, b = len(order), int(msg["fanout"])
        idx = int(msg["index"])
        proofs = bool(msg.get("proofs"))
        ent = self._dp_reply_entry(msg)
        partials = [ent["cts"]]
        responders = [self.name]
        absent: list[str] = []
        blobs: list[dict] = []
        if proofs and ent["req"] is not None:
            blobs.append(self._proof_fields(ent["req"]))
        kids = topo.children(idx, n, b)
        if kids:
            by_name = {e.name: e for e in self.roster.entries}
            idx_of = {order[c]: c for c in kids}
            entries = [by_name[order[c]] for c in kids]

            def mk(e):
                m = dict(msg)
                m["index"] = idx_of[e.name]
                return m

            outs = _fan_entries(entries, mk, self.policy)
            for e, (r, err) in zip(entries, outs):
                if err is None:
                    part = _limbs(r["cts"], self.device)
                    self._check_hop_proof(r, part, proofs, e.name)
                    partials.append(part)
                    responders.extend(r["responders"])
                    absent.extend(r["absent"])
                    blobs.extend(r.get("proof_blobs") or [])
                elif isinstance(err, RemoteError):
                    raise err   # the child's handler ran and failed
                elif isinstance(err, (TransportError, OSError)):
                    # the child's whole subtree is unreached from here; the
                    # root re-dispatches its children as subtree roots
                    log.warn(f"{self.name}: subtree {e.name} unreachable "
                             f"for survey {msg['survey_id']}: {err}")
                    absent.extend(order[j] for j in
                                  topo.subtree(idx_of[e.name], n, b))
                else:
                    raise err
        if len(partials) == 1:
            reply = {"cts": _pack_limbs(partials[0])}
        else:
            stack = torch.stack(partials)
            folded = topo.fold_cts(stack)
            reply = {"cts": _pack_limbs(folded)}
            if proofs:
                reply["hop_proof"] = _pack_bytes(pickle.dumps(
                    agg_proof.create_aggregation_proof(stack, folded)))
        reply["responders"] = responders
        reply["absent"] = absent
        if proofs:
            reply["proof_blobs"] = blobs
        return reply

    def _check_hop_proof(self, r: dict, part: torch.Tensor, proofs: bool,
                         child: str) -> None:
        """The parent's check of a relay hop's aggregation proof: the fold
        verifies and the proven aggregate is the reply's own bytes."""
        if not proofs or r.get("hop_proof") is None:
            return
        batch = safe_loads(_unpack_bytes(r["hop_proof"]))
        ok = bool(np.all(agg_proof.verify_aggregation_proof(batch,
                                                            self.device)))
        if not ok or not torch.equal(batch.aggregate.to(part.device), part):
            raise RuntimeError(
                f"{self.name}: relay {child} hop aggregation proof rejected")

    # -- CN side: obfuscation, every ciphertext times a fresh secret scalar
    # (reference obfuscation_protocol.go:241-243), proved with proofs on
    def _h_obf_contrib(self, msg: dict) -> dict:
        dev = self.device
        cts = _limbs(msg["cts"], dev)
        gen = _fresh_generator(dev)
        s = eg.random_scalars((int(cts.shape[0]),), gen, dev)
        if msg.get("proofs"):
            pr = obf_proof.create_obfuscation_proofs(cts, s, generator=gen)
            self._send_proof_async("obfuscation", msg["survey_id"],
                                   f"obf-{self.name}", pickle.dumps(pr))
            out = pr.obf
        else:
            out = eg.ct_scalar_mul(cts, s)
        return {"cts": _pack_limbs(out)}

    # -- CN side: the DRO shuffle and re-randomization of the noise list,
    # its zero-encryptions from the crypto pool when it holds a slab
    def _h_shuffle_contrib(self, msg: dict) -> dict:
        dev = self.device
        cts = _limbs(msg["cts"], dev)
        coll_pub = self.roster.collective_pub()
        tbl = self._table(coll_pub)
        S = int(cts.shape[0])
        gen = _fresh_generator(dev)
        precomp = None
        cpool = pool_mod.active_pool()
        if cpool is not None:
            got = cpool.try_consume_dro(pool_mod.key_digest(tbl.table), S)
            if got is not None:
                precomp = dro.to_device(got[0], got[1], dev)
        if precomp is None:
            precomp = dro.precompute_rerandomization(
                tbl.table, S, gen, base_tbl=base_table(dev))
        out_cts, perm, rs = dro.shuffle_rerandomize(cts, tbl.table, gen,
                                                    precomp=precomp)
        if msg.get("proofs"):
            pr = shuffle_proof.prove_shuffle(
                cts, out_cts, perm, shuffle_proof.limbs_to_ints(rs),
                C.from_ref(coll_pub).to(dev),
                np.random.default_rng(secrets.randbits(128)))
            self._send_proof_async(
                "shuffle", msg["survey_id"], f"shuffle-{self.name}",
                pickle.dumps((pr, cts.cpu().numpy(), out_cts.cpu().numpy())))
        return {"cts": _pack_limbs(out_cts)}

    # -- CN side: the key-switch contribution U = r B, W = r Q - x K and,
    # with proofs on, its proof to the VNs (reference service.go:566-616)
    def _h_ks_contrib(self, msg: dict) -> dict:
        dev = self.device
        K0 = _limbs(msg["k_component"], dev)              # (V, 3, 16)
        client_pub = tuple(msg["client_pub"])
        q_tbl = self._table(client_pub)
        V = int(K0.shape[0])
        gen = _fresh_generator(dev)
        rs = eg.random_scalars((V,), gen, dev)
        x = eg.secret_to_limbs(self.secret).to(dev)
        u_pts = eg.fixed_base_mul(base_table(dev), rs)
        rQ = eg.fixed_base_mul(q_tbl.table, rs)
        xK = C.scalar_mul(K0, x.expand(V, -1))
        # the switched component w = rQ - xK is ciphertext — a public
        # protocol output even though the secret key went into it
        w_pts = C.add(rQ, C.neg(xK))  # drynx: declassify[secret]
        if msg.get("proofs"):
            # a ZK proof transcript (commitments + responses) is public
            # by construction; x is an input, never serialized
            pr = ks_proof.create_keyswitch_proofs(  # drynx: declassify[secret]
                K0, x[None], rs[None], C.from_ref(client_pub).to(dev),
                q_tbl.table, u_pts[None], w_pts[None], generator=gen)
            self._send_proof_async("keyswitch", msg["survey_id"],
                                   f"ks-{self.name}", pickle.dumps(pr))
        return {"u": _pack_limbs(u_pts), "w": _pack_limbs(w_pts)}

    def _call_cn(self, entry, msg: dict) -> dict:
        """Dispatch to a CN: a local call for this node, TCP otherwise."""
        if entry.name == self.name:
            return self.server.handlers[msg["type"]](msg)
        return call_entry(entry, msg, policy=self.policy)

    # -- root CN: phase checkpoints and the healing re-entry
    def _checkpoint(self, sid: str) -> SurveyCheckpoint:
        """The survey's checkpoint: fresh on first entry, else the record
        that survived with `resumes` bumped."""
        with self._state_lock:
            ck = self._ckpts.get(sid)
            if ck is None:
                ck = SurveyCheckpoint(survey_id=sid)
            elif not ck.done:
                ck.resumes += 1
            for k in list(self._ckpts):
                if len(self._ckpts) < rp.DP_REPLY_CACHE_MAX:
                    break
                if self._ckpts[k].done and k != sid:
                    del self._ckpts[k]
            self._ckpts[sid] = ck
            return ck

    def _probe_dp(self, entry) -> bool:
        """A liveness probe of one entry on the resume path: an ALIVE
        verdict is reused for rp.PROBE_TTL_S, a DEAD one never (a node
        that revived between passes must be seen)."""
        now = time.monotonic()
        with self._state_lock:
            hit = self._probe_cache.get(entry.name)
            if hit is not None and now - hit < rp.PROBE_TTL_S:
                return True
        pol = dataclasses.replace(self.policy,
                                  call_timeout_s=rp.PING_TIMEOUT_S,
                                  connect_retries=0)
        try:
            alive = bool(call_entry(entry, {"type": "ping"},
                                    policy=pol).get("ok"))
        except (TransportError, OSError):
            alive = False
        with self._state_lock:
            if alive:
                self._probe_cache[entry.name] = time.monotonic()
            else:
                self._probe_cache.pop(entry.name, None)
        return alive

    def _dispatch_star(self, dps, dp_frame: dict):
        """The flat DP fan-out, with _dispatch_tree's result shape."""
        outs = _fan_entries(dps, lambda e: dict(dp_frame), self.policy)
        partials, responders, failed = [], [], []
        for e, (r, err) in zip(dps, outs):
            if err is None:
                responders.append(e.name)
                partials.append(_limbs(r["cts"], self.device))
            elif isinstance(err, RemoteError):
                raise err   # the DP's handler ran and failed
            elif isinstance(err, (TransportError, OSError)):
                log.warn(f"{self.name}: DP {e.name} unavailable for "
                         f"survey {dp_frame['survey_id']}: {err}")
                failed.append(e.name)
            else:
                raise err
        return partials, responders, sorted(failed), []

    def _redispatch_missing(self, dps, dp_frame: dict, proofs: bool,
                            mode: str, partials, responders, failed,
                            blobs, ck: SurveyCheckpoint):
        """The healing re-entry: while contributions are missing, wait,
        re-probe only the missing DPs and re-dispatch those that answer
        (over a survivor-layout tree when more than one heals), at most
        rp.CHECKPOINT_MAX_RESUMES passes. A DP is re-dialed only while
        absent, and its reply cache replays its first bytes, so nothing
        counts twice."""
        by_name = {e.name: e for e in dps}
        order = [e.name for e in dps]
        attempt = 0
        failed = set(failed)
        while failed and attempt < rp.CHECKPOINT_MAX_RESUMES:
            attempt += 1
            time.sleep(rp.RESUME_BACKOFF_S)
            healed = [nm for nm in sorted(failed)
                      if self._probe_dp(by_name[nm])]
            if not healed:
                continue
            log.lvl1(f"{self.name}: survey {dp_frame['survey_id']} "
                     f"re-entering collect for healed DPs {healed} "
                     f"(pass {attempt})")
            ck.enter("collect")
            retry = [by_name[nm]
                     for nm in topo.survivor_layout(order, healed)]
            if mode == "tree" and len(retry) > 1:
                p2, r2, _f2, b2 = self._dispatch_tree(retry, dp_frame,
                                                      proofs)
            else:
                p2, r2, _f2, b2 = self._dispatch_star(retry, dp_frame)
            partials += p2
            blobs += b2
            got = set(responders) | set(r2)
            responders = [nm for nm in order if nm in got]
            failed -= set(r2)
        return partials, responders, sorted(failed), blobs

    def _dispatch_tree(self, dps, dp_frame: dict, proofs: bool):
        """The tree overlay's dispatch from the root: contact the forest
        roots, let relays fold their subtrees, and recover from a dead
        relay by dispatching its children as new subtree roots (never the
        failed node itself). Returns (partials, responders in roster
        order, failed sorted, proof blobs)."""
        order = [e.name for e in dps]
        idx_of = {nm: i for i, nm in enumerate(order)}
        n, b = len(order), topo.tree_fanout(len(order))
        frame = {**dp_frame, "dp_order": order, "fanout": b}
        partials: list = []
        blobs: list[dict] = []
        got: set[str] = set()
        failed: set[str] = set()
        expanded: set[int] = set()
        wave = topo.roots(n, b)
        while wave:
            nxt: list[int] = []

            def expand(i):
                # once per index: its children become subtree roots of the
                # next wave
                if i not in expanded:
                    expanded.add(i)
                    nxt.extend(topo.children(i, n, b))

            entries = [dps[i] for i in wave]
            widx = {order[i]: i for i in wave}

            def mk(e):
                m = dict(frame)
                m["index"] = widx[e.name]
                return m

            outs = _fan_entries(entries, mk, self.policy)
            for i, e, (r, err) in zip(wave, entries, outs):
                if err is None:
                    part = _limbs(r["cts"], self.device)
                    self._check_hop_proof(r, part, proofs, e.name)
                    partials.append(part)
                    got.update(r["responders"])
                    blobs.extend(r.get("proof_blobs") or [])
                    # expand only the topmost node of each absent subtree:
                    # its children's dispatch covers the descendants
                    abs_set = set(r["absent"])
                    failed |= abs_set
                    for nm in abs_set:
                        j = idx_of[nm]
                        p = topo.parent(j, b)
                        if p is None or order[p] not in abs_set:
                            expand(j)
                elif isinstance(err, RemoteError):
                    raise err   # the handler ran and failed: not an outage
                elif isinstance(err, (TransportError, OSError)):
                    log.warn(f"{self.name}: DP subtree {e.name} unavailable "
                             f"for survey {dp_frame['survey_id']}: {err}")
                    failed.add(e.name)
                    expand(i)
                else:
                    raise err
            wave = nxt
        failed -= got
        responders = [nm for nm in order if nm in got]
        return partials, responders, sorted(failed), blobs

    # -- root CN: the whole survey (reference HandleSurveyQuery and
    # StartService's phase order, service.go:263-747)
    def _h_survey_query(self, msg: dict) -> dict:
        if self.roster is None:
            raise RuntimeError("roster not set (send set_roster first)")
        dev = self.device
        op = msg["op"]
        survey_id = msg["survey_id"]
        proofs = bool(msg.get("proofs"))
        ranges_v = [tuple(r) for r in msg.get("ranges") or []]
        excluded = set(msg.get("dp_exclude") or ())
        dps = [e for e in self.roster.of_role("dp")
               if e.name not in excluded]
        cns = self.roster.of_role("cn")
        # min_dp_quorum DPs must contribute; 0: all of them
        min_q = int(msg.get("min_dp_quorum") or 0)
        need = min_q if min_q > 0 else len(dps)
        mode = topo.topology_mode()
        ck = self._checkpoint(survey_id)
        log.lvl1(f"{self.name}: survey {survey_id} op={op} "
                 f"dps={len(dps)} cns={len(cns)} proofs={int(proofs)} "
                 f"quorum={need} topology={mode} resumes={ck.resumes} "
                 f"device={dev}")

        # every CN's digit signatures for each base u of the ranges
        ck.enter("setup")
        range_sigs_msg: dict = {}
        if proofs and ranges_v:
            for (u, _l) in rproof.group_ranges(ranges_v):
                outs = _fan(cns, lambda e, u=u: {"type": "range_sig",
                                                 "u": u}, self._call_cn)
                pubs, As = [], []
                for e, (r, err) in zip(cns, outs):
                    if err is not None:
                        raise err
                    pubs.append([int(t) for t in r["pub"]])
                    As.append(unpack_array(r["A"]))
                range_sigs_msg[str(u)] = {"pubs": pubs,
                                          "A": pack_array(np.stack(As))}

        # collect the DPs' ciphertexts, up the tree overlay by default
        range_offset = int(msg.get("range_offset", 0))
        dp_frame = {"type": "survey_dp", "op": op,
                    "survey_id": survey_id,
                    "query_min": msg["query_min"],
                    "query_max": msg["query_max"],
                    "lr_params": msg.get("lr_params"),
                    "group_by": msg.get("group_by"),
                    "range_offset": range_offset,
                    "proofs": proofs, "ranges": ranges_v,
                    "range_sigs": range_sigs_msg}
        ck.enter("collect")
        if mode == "tree" and len(dps) > 1:
            (partials, responders,
             failed, blobs) = self._dispatch_tree(dps, dp_frame, proofs)
        else:
            (partials, responders,
             failed, blobs) = self._dispatch_star(dps, dp_frame)
        if failed:
            (partials, responders,
             failed, blobs) = self._redispatch_missing(
                dps, dp_frame, proofs, mode, partials, responders,
                failed, blobs, ck)
        ck.responders = list(responders)
        if len(responders) < need:
            raise RuntimeError(
                f"survey {survey_id}: only {len(responders)}/{len(dps)} DPs "
                f"responded (quorum {need}); failed: {sorted(failed)}")
        absent = sorted(excluded | set(failed))
        if proofs and failed:
            # the VNs expect a range proof per dialed DP: lower them to the
            # responders, or their counters never drain
            adj = {"type": "vn_adjust", "survey_id": survey_id,
                   "expected_drop": len(failed),
                   "expected_range": len(responders),
                   "absent": sorted(failed)}
            vns_all = self.roster.of_role("vn")
            for v, (_r, err) in zip(vns_all, _fan_entries(
                    vns_all, lambda e: dict(adj), self.policy)):
                if isinstance(err, (TransportError, OSError)):
                    log.warn(f"{self.name}: vn_adjust undeliverable to "
                             f"{v.name}: {err}")
                elif err is not None:
                    raise err
        # the canonical fold in both modes: tree partials and star
        # payloads give the same aggregate bytes
        ck.absent = list(absent)
        ck.enter("aggregate")
        cts = torch.stack(partials)             # (n_partials, V, 2, 3, 16)
        agg = topo.fold_cts(cts)
        if proofs:
            self._send_proof_async(
                "aggregation", survey_id, f"agg-{self.name}",
                pickle.dumps(agg_proof.create_aggregation_proof(cts, agg)))
            if blobs:
                # tree mode: the range proofs came up the relay hops
                self._send_proof_batch_async(survey_id, blobs)

        # the obfuscation chain: each CN takes the previous CN's output
        if msg.get("obfuscation"):
            ck.enter("obfuscate")
            for e in cns:
                r = self._call_cn(e, {"type": "obf_contrib",
                                      "survey_id": survey_id,
                                      "proofs": proofs,
                                      "cts": _pack_limbs(agg)})
                agg = _limbs(r["cts"], dev)

        # DRO noise: the root encrypts the noise list, each CN shuffles and
        # re-randomizes it in turn, one noise ciphertext lands on each
        # result (reference service.go:600-665, 809-851)
        diffp = msg.get("diffp") or {}
        if diffp.get("noise_list_size", 0) > 0:
            ck.enter("dro")
            noise = dro.generate_noise_values(
                int(diffp["noise_list_size"]), float(diffp["lap_mean"]),
                float(diffp["lap_scale"]), float(diffp["quanta"]),
                float(diffp["scale"]), float(diffp["limit"]))
            n_cts = dro.encrypt_noise(
                self._table(self.roster.collective_pub()), noise,
                _fresh_generator(dev), base_tbl=base_table(dev))
            for e in cns:
                r = self._call_cn(e, {"type": "shuffle_contrib",
                                      "survey_id": survey_id,
                                      "proofs": proofs,
                                      "cts": _pack_limbs(n_cts)})
                n_cts = _limbs(r["cts"], dev)
            V = int(agg.shape[0])
            idx = torch.arange(V, device=dev) % int(n_cts.shape[0])
            agg = eg.ct_add(agg, n_cts[idx])

        # the key switch: every CN switches the same K component; the
        # sums accumulate in roster order
        ck.enter("keyswitch")
        ks_frame = {"type": "ks_contrib", "k_component": _pack_limbs(agg[:, 0]),
                    "client_pub": list(msg["client_pub"]),
                    "survey_id": survey_id, "proofs": proofs}
        outs = _fan(cns, lambda e: dict(ks_frame), self._call_cn)
        k_sum = c_sum = None
        for e, (r, err) in zip(cns, outs):
            if err is not None:
                raise err
            u = _limbs(r["u"], dev)
            w = _limbs(r["w"], dev)
            k_sum = u if k_sum is None else C.add(k_sum, u)
            c_sum = w if c_sum is None else C.add(c_sum, w)
        c2 = C.add(agg[:, 1], c_sum)
        if range_offset:
            # each responding DP added one offset: subtract the public
            # total times B
            total = range_offset * len(responders)
            corr = eg.fixed_base_mul(base_table(dev), eg.int_to_scalar(
                torch.tensor([total], dtype=torch.int64, device=dev)))
            c2 = C.add(c2, C.neg(corr.expand(c2.shape)))
        switched = torch.stack([k_sum, c2], dim=-3)
        # this node's own proof threads drain before it replies, so the
        # querier's end_verification does not race them
        with self._state_lock:
            drained = self._proof_threads.pop(survey_id, [])
        for t in drained:
            t.join(timeout=rp.PROOF_DRAIN_S)
        ck.done = True
        ck.enter("done")
        return {"switched": _pack_limbs(switched),
                "responders": responders, "absent": absent,
                "resumes": ck.resumes,
                "phases": dict(ck.phase_entries)}

    # -- VN handlers
    def _require_vn(self) -> VerifyingNode:
        if self.vn is None:
            raise RuntimeError(f"node {self.name} is not a VN")
        return self.vn

    def _h_vn_register(self, msg: dict) -> dict:
        if self.vn is None:
            raise RuntimeError(f"node {self.name} is not a VN (no roster, or "
                               "not in the vn role)")
        sid = msg["survey_id"]
        self.vn.register_survey(sid, msg["expected"],
                                msg.get("thresholds", {}),
                                expected_range=int(
                                    msg.get("expected_range", 0)))
        if msg.get("proofs"):
            sigs_pub_by_u = {
                int(u): [tuple(int(t) for t in p) for p in pubs]
                for u, pubs in (msg.get("range_sig_pubs") or {}).items()}
            self._survey_ctx[sid] = {
                "coll_pub": self.roster.collective_pub(),
                "client_pub": tuple(int(t) for t in msg["client_pub"]),
                "ranges_v": [tuple(r) for r in msg.get("ranges") or []],
                "sigs_pub_by_u": sigs_pub_by_u,
            }
        return {"ok": True}

    def _h_vn_adjust(self, msg: dict) -> dict:
        """DPs went absent mid-survey: lower this VN's expected count (and
        the joint range flush's threshold) to the responders. Idempotent:
        expected_range is absolute."""
        vn = self._require_vn()
        vn.adjust_expected(
            msg["survey_id"], int(msg.get("expected_drop", 0)),
            expected_range=int(msg["expected_range"])
            if msg.get("expected_range") is not None else None)
        log.lvl2(f"VN {self.name}: survey {msg['survey_id']} adjusted for "
                 f"absent DPs {msg.get('absent')}")
        return {"ok": True}

    @staticmethod
    def _req_of_blob(p: dict) -> rq.ProofRequest:
        return rq.ProofRequest(
            proof_type=p["proof_type"], survey_id=p["survey_id"],
            sender_id=p["sender_id"], differ_info=p["differ_info"],
            round_id=p["round_id"], data=_unpack_bytes(p["data"]),
            signature=schnorr.Signature.from_bytes(
                _unpack_bytes(p["signature"])))

    def _h_proof_request(self, msg: dict) -> dict:
        code = self._require_vn().receive_proof(self._req_of_blob(msg))
        return {"code": code}

    def _h_proof_batch(self, msg: dict) -> dict:
        """A survey's relayed proof blobs in one frame (tree mode), each
        received as _h_proof_request would, in the frame's order."""
        vn = self._require_vn()
        codes = {}
        for p in msg["proofs"]:
            codes[p["differ_info"]] = vn.receive_proof(self._req_of_blob(p))
        return {"codes": codes}

    def _h_vn_bitmap(self, msg: dict) -> dict:
        vn = self._require_vn()
        sid = msg["survey_id"]
        state = vn.surveys.get(sid)
        if state is None:
            raise RuntimeError(f"unknown survey {sid!r} at VN {self.name}")
        if msg.get("vn_order") is not None:
            return self._h_vn_bitmap_relay(msg, state)
        if msg.get("wait"):
            if not state.done.wait(float(msg.get("timeout",
                                                 rp.VERIFY_WAIT_S))):
                raise TimeoutError(
                    f"VN {self.name}: {len(state.bitmap)}/{state.expected} "
                    f"proofs received for {sid!r}")
        return {"bitmap": vn.bitmap_for(sid), "expected": state.expected}

    def _h_vn_bitmap_relay(self, msg: dict, state) -> dict:
        """The tree overlay's bitmap collection (frames carrying
        vn_order): wait out this VN's own counter while the child
        subtrees are polled, then merge upward; a short bitmap is a
        failure, never a report."""
        sid = msg["survey_id"]
        timeout = float(msg.get("timeout", rp.VERIFY_WAIT_S))
        order = list(msg["vn_order"])
        n, b = len(order), int(msg["fanout"])
        kids = topo.children(int(msg["index"]), n, b)
        reports: dict[str, dict] = {}
        failures: dict[str, str] = {}

        def poll_children():
            set_current_node(self.name)
            by_name = {e.name: e for e in self.roster.entries}
            idx_of = {order[c]: c for c in kids}
            entries = [by_name[order[c]] for c in kids]

            def mk(e):
                m = dict(msg)
                m["index"] = idx_of[e.name]
                return m

            # the socket's budget outlives the child's own wait
            outs = _fan(entries, mk, lambda e, m: call_entry(
                e, m, timeout=timeout + rp.STRAGGLER_GRACE_S,
                policy=self.policy))
            for e, (r, err) in zip(entries, outs):
                if err is None:
                    reports.update(r["reports"])
                    failures.update(r["failures"])
                else:
                    for j in topo.subtree(idx_of[e.name], n, b):
                        failures[order[j]] = repr(err)

        t = None
        if kids:
            t = threading.Thread(target=poll_children, daemon=True)
            t.start()
        own_err = None
        try:
            if not state.done.wait(timeout):
                raise TimeoutError(
                    f"VN {self.name}: {len(state.bitmap)}/{state.expected} "
                    f"proofs received for {sid!r}")
            bm = self.vn.bitmap_for(sid)
            if len(bm) < state.expected:
                raise RuntimeError(
                    f"VN {self.name} reports {len(bm)}/{state.expected} "
                    f"proofs for {sid!r}; refusing to commit it")
        except Exception as e:
            own_err = repr(e)
        if t is not None:
            t.join()
        if own_err is None:
            reports[self.name] = {"bitmap": bm, "expected": state.expected}
        else:
            failures[self.name] = own_err
        return {"reports": reports, "failures": failures}

    def _h_end_verification(self, msg: dict) -> dict:
        """Root VN: the counter-gated bitmap merge and the block's commit.

        A reporting VN must have received its full expected count
        (reference proof_collection_protocol.go:362-398). `vn_quorum` in
        (0, 1] is the share of VNs that must report a complete bitmap
        (default 1.0, every VN). All VNs are polled at once, so the commit
        fires as soon as the quorum is met; the reply names the VNs that
        made the block (vn_reported) and the stragglers (vn_absent)."""
        vn = self._require_vn()
        survey_id = msg["survey_id"]
        timeout = float(msg.get("timeout", rp.VERIFY_WAIT_S))
        quorum = float(msg.get("vn_quorum") or 1.0)
        vns = self.roster.of_role("vn")
        state = vn.surveys.get(survey_id)
        if state is None:
            raise RuntimeError(f"unknown survey {survey_id!r}")
        # the epsilon guards float shares: 2/3 * 3 == 2.0000000000000004
        need = max(1, math.ceil(quorum * len(vns) - 1e-9))

        b = topo.tree_fanout(len(vns))
        if (topo.topology_mode() == "tree" and quorum >= 1.0
                and len(vns) > b):
            # a full quorum rides the VN tree: every bitmap is needed, and
            # relays merge sub-polls instead of one blocked socket per VN
            snap, fails = self._collect_bitmaps_tree(survey_id, vns,
                                                     timeout, state, b)
        else:
            lock = threading.Lock()
            reports: dict[str, dict] = {}
            failures: dict[str, str] = {}
            settled = threading.Event()

            def note(name: str, bitmap=None, err=None):
                with lock:
                    if err is None:
                        reports[name] = bitmap
                    else:
                        failures[name] = err
                    if (len(reports) >= need
                            or len(reports) + len(failures) >= len(vns)):
                        settled.set()

            def poll(e):
                set_current_node(self.name)
                try:
                    if e.name == self.name:
                        if not state.done.wait(timeout):
                            raise TimeoutError(
                                f"VN {self.name}: {len(state.bitmap)}/"
                                f"{state.expected} proofs received for "
                                f"{survey_id!r}")
                        bm, expected = (vn.bitmap_for(survey_id),
                                        state.expected)
                    else:
                        # the socket's timeout outlives the peer's wait
                        r = call_entry(e, {"type": "vn_bitmap",
                                           "survey_id": survey_id,
                                           "wait": True,
                                           "timeout": timeout},
                                       timeout=timeout
                                       + rp.STRAGGLER_GRACE_S,
                                       policy=self.policy)
                        bm, expected = r["bitmap"], r["expected"]
                    if len(bm) < expected:
                        raise RuntimeError(
                            f"VN {e.name} reports {len(bm)}/{expected} "
                            f"proofs for {survey_id!r}; refusing to "
                            f"commit it")
                    note(e.name, bitmap=bm)
                except Exception as err:
                    note(e.name, err=repr(err))

            threads = [threading.Thread(target=poll, args=(e,),
                                        daemon=True)
                       for e in vns]
            for t in threads:
                t.start()
            settled.wait(timeout + 2 * rp.STRAGGLER_GRACE_S)
            with lock:
                snap = dict(reports)
                fails = dict(failures)
        if len(snap) < need:
            raise TimeoutError(
                f"root VN {self.name}: {len(snap)}/{len(vns)} VNs report "
                f"complete bitmaps for {survey_id!r} (quorum {need}); "
                f"failures: {fails}")
        reported = [e.name for e in vns if e.name in snap]
        absent = [e.name for e in vns if e.name not in snap]
        merged = {}
        for name in reported:
            for k, v in snap[name].items():
                merged[f"{name}:{k}"] = v

        vn.local_bitmaps[survey_id] = merged
        block = vn.chain.append(
            # drynx: deterministic[sample_time is excluded from transcripts]
            DataBlock(survey_id=survey_id, sample_time=time.time(),
                      bitmap=merged))
        return {"block_index": block.index, "block_hash": block.hash(),
                "bitmap": merged, "vn_reported": reported,
                "vn_absent": absent}

    def _collect_bitmaps_tree(self, sid: str, vns, timeout: float,
                              state, b: int):
        """The VN tree's full-quorum bitmap collection: this root VN walks
        its own subtree inline while the other forest roots are polled;
        each relay merges complete bitmaps and failures upward. Returns
        (snap {name: bitmap}, failures)."""
        order = [e.name for e in vns]
        n = len(order)
        base = {"type": "vn_bitmap", "survey_id": sid, "wait": True,
                "timeout": timeout, "vn_order": order, "fanout": b}
        tops = topo.roots(n, b)
        i0 = order.index(self.name) if self.name in order else -1
        remote = [i for i in tops if i != i0]
        reports: dict[str, dict] = {}
        failures: dict[str, str] = {}
        r_out: list = []

        def run_remote():
            set_current_node(self.name)
            entries = [vns[i] for i in remote]
            iix = {order[i]: i for i in remote}

            def mk(e):
                m = dict(base)
                m["index"] = iix[e.name]
                return m

            # two grace units: the remote relay's sockets carry one
            outs = _fan(entries, mk, lambda e, m: call_entry(
                e, m, timeout=timeout + 2 * rp.STRAGGLER_GRACE_S,
                policy=self.policy))
            r_out.append((entries, iix, outs))

        t = None
        if remote:
            t = threading.Thread(target=run_remote, daemon=True)
            t.start()
        if i0 in tops:
            own = self._h_vn_bitmap_relay(dict(base, index=i0), state)
            reports.update(own["reports"])
            failures.update(own["failures"])
        if t is not None:
            t.join()
        for entries, iix, outs in r_out:
            for e, (r, err) in zip(entries, outs):
                if err is None:
                    reports.update(r["reports"])
                    failures.update(r["failures"])
                else:
                    for j in topo.subtree(iix[e.name], n, b):
                        failures[order[j]] = repr(err)
        snap = {nm: rep["bitmap"] for nm, rep in reports.items()}
        return snap, failures

    # -- the skipchain RPCs (reference services/service_skipchain.go
    # :173-342): a remote querier audits the chain
    def _h_get_block(self, msg: dict) -> dict:
        vn = self._require_vn()
        t = msg["type"]
        if t == "get_genesis":
            blk = vn.chain.genesis()
        elif t == "get_latest":
            blk = vn.chain.latest()
        elif "survey_id" in msg:
            blk = vn.chain.block_for_survey(msg["survey_id"])
        else:
            blk = vn.chain.block(int(msg["index"]))
        if blk is None:
            return {"found": False}
        return {"found": True, "block": _pack_bytes(blk.to_bytes()),
                "hash": blk.hash(), "chain_length": len(vn.chain)}

    def _h_get_proofs(self, msg: dict) -> dict:
        stored = self._require_vn().stored_proofs(msg["survey_id"])
        return {"proofs": {k: _pack_bytes(v) for k, v in stored.items()}}

    def _h_close_db(self, msg: dict) -> dict:
        vn = self._require_vn()
        vn.db.sync()
        vn.db.close()
        return {"ok": True}


class RemoteClient:
    """The querier of a multi-process deployment, decrypting on `device`
    (the card unless the CPU is named)."""

    def __init__(self, roster: Roster,
                 rng: Optional[np.random.Generator] = None,
                 policy: Optional[rp.RetryPolicy] = None, device=None):
        self.roster = roster
        self.device = resolve(device)
        rng = rng or np.random.default_rng()
        self.secret, self.public = eg.keygen(rng)
        self.policy = policy or rp.DEFAULT_POLICY
        # the last survey's responders, absentees, the root's resumes and
        # its phase entries
        self.last_responders: list[str] = []
        self.last_absent: list[str] = []
        self.last_resumes: int = 0
        self.last_phases: dict = {}
        self._probe_cache: Optional[tuple[float, dict]] = None
        # the link model's counters over the last survey: bytes_total,
        # msgs_total, by_peer, rx_by_node; and its decrypted vector
        self.last_net: dict = {}
        self.last_decrypted: Optional[st.DecryptedVector] = None

    def broadcast_roster(self) -> dict:
        """Push the roster to every entry, each on a fresh connection of
        its own; an unreachable node is recorded False (it picks the
        roster up when it rejoins)."""
        def send_one(e, m):
            c = tr.Conn(e.host, e.port, peer=e.name)
            try:
                return c.call(m)
            finally:
                c.close()

        msg = {"type": "set_roster", "roster": self.roster.to_dict()}
        outs = _fan(self.roster.entries, lambda e: msg, send_one)
        ok = {}
        for e, (_r, err) in zip(self.roster.entries, outs):
            if err is None:
                ok[e.name] = True
            elif isinstance(err, (TransportError, OSError)):
                log.warn(f"roster undeliverable to {e.name}: {err!r}")
                ok[e.name] = False
            else:
                raise err
        return ok

    def ping(self, entry: RosterEntry) -> bool:
        """One quick round trip; no answer within PING_TIMEOUT_S means the
        node is down or wedged."""
        pol = dataclasses.replace(self.policy,
                                  call_timeout_s=rp.PING_TIMEOUT_S,
                                  connect_retries=0)
        try:
            r = call_entry(entry, {"type": "ping"}, policy=pol)
            return bool(r.get("ok"))
        except (TransportError, OSError):
            return False

    def probe_liveness(self) -> dict[str, bool]:
        """Ping every roster entry at once: {name: alive}. The verdicts
        are reused for rp.PROBE_TTL_S."""
        now = time.monotonic()
        if (self._probe_cache is not None
                and now - self._probe_cache[0] < rp.PROBE_TTL_S):
            return dict(self._probe_cache[1])
        outs = tr.fan_out(self.roster.entries, self.ping)
        alive = {e.name: bool(r) for e, (r, _err)
                 in zip(self.roster.entries, outs)}
        self._probe_cache = (time.monotonic(), alive)
        return alive

    def expected_proofs(self, n_dps: int, n_cns: int, obfuscation: bool,
                        diffp: bool) -> int:
        """Proofs every VN receives in one survey over TCP: a range proof
        per DP, one aggregation proof (the relays' hop proofs go to their
        parents), a key-switch proof per CN, and an obfuscation and a
        shuffle proof per CN when those phases run."""
        return (n_dps + 1 + n_cns + (n_cns if obfuscation else 0)
                + (n_cns if diffp else 0))

    @staticmethod
    def _diffp_on(diffp: Optional[dict]) -> bool:
        """The root's gate: the shuffle chain runs only for a non-empty
        noise list."""
        return bool(diffp and int(diffp.get("noise_list_size", 0)) > 0)

    def run_survey(self, op: str, query_min: int = 0, query_max: int = 0,
                   survey_id: str = "sv-remote",
                   dlog: Optional[eg.DecryptionTable] = None,
                   proofs: bool = False, ranges=None,
                   obfuscation: bool = False, diffp: Optional[dict] = None,
                   lr_params=None, group_by=None,
                   thresholds: float = 1.0,
                   timeout: float = rp.VERIFY_WAIT_S,
                   min_dp_quorum: int = 0, vn_quorum: float = 1.0,
                   probe: bool = False):
        """A whole remote survey. With proofs on: the CNs' range-signature
        publics, the survey (with its verify context) registered at every
        VN, the query, then the root VN's counter-gated block (reference
        SendSurveyQueryToVNs + SendEndVerification, services/
        api_skipchain.go:16-46); returns (result, block reply), else the
        result. log_reg needs `lr_params` and (X, y) at every DP; the
        querier runs the gradient descent. `probe` drops the DPs (and
        picks the root CN and VN among the nodes) that answer a liveness
        probe."""
        from ..encoding import output_size

        net0 = tr.link_model().stats()
        cns = self.roster.of_role("cn")
        dps = self.roster.of_role("dp")
        vns = self.roster.of_role("vn")
        root = cns[0]
        root_vn = vns[0] if vns else None

        dp_exclude: list[str] = []
        if probe:
            alive = self.probe_liveness()
            dp_exclude = [e.name for e in dps if not alive.get(e.name)]
            dps = [e for e in dps if alive.get(e.name)]
            live_cns = [e for e in cns if alive.get(e.name)]
            if not live_cns:
                raise ConnectError("no CN answered the liveness probe")
            root = live_cns[0]
            if vns:
                live_vns = [e for e in vns if alive.get(e.name)]
                if not live_vns:
                    raise ConnectError("no VN answered the liveness probe")
                # dead VNs still count against the end_verification quorum
                vns = live_vns
                root_vn = live_vns[0]

        if op == "log_reg" and lr_params is None:
            raise ValueError("log_reg survey requires lr_params")
        if op == "log_reg" and group_by:
            raise ValueError("group_by is not supported for log_reg")
        n_groups = 1
        if group_by:
            n_groups = int(np.prod([len(v) for v in group_by]))
        if op == "log_reg":
            n_out = lr_params.num_coeffs()
        else:
            n_out = output_size(op, query_min, query_max) * n_groups

        range_offset = 0
        if proofs:
            if ranges is None:
                ranges = [(16, 4)] * n_out
            elif group_by and len(ranges) == n_out // n_groups:
                ranges = list(ranges) * n_groups  # tile per-group specs
            if len(ranges) != n_out:
                raise ValueError(
                    f"{len(ranges)} range specs for {n_out} outputs")
            if op == "log_reg":
                if len(set(map(tuple, ranges))) > 1:
                    raise ValueError(
                        "log_reg range proofs require a uniform (u, l) spec")
                u0, l0 = ranges[0]
                if u0:
                    range_offset = (int(u0) ** int(l0)) // 2
            if not vns:
                raise ValueError("proofs on but the roster has no VNs")
            sig_pubs = {}
            for (u, _l) in rproof.group_ranges(ranges):
                outs = _fan_entries(cns, lambda e, u=u: {"type": "range_sig",
                                                         "u": u},
                                    self.policy)
                pubs = []
                for e, (r, err) in zip(cns, outs):
                    if err is not None:
                        raise err
                    pubs.append([int(t) for t in r["pub"]])
                sig_pubs[str(u)] = pubs
            expected = self.expected_proofs(
                len(dps), len(cns), obfuscation, self._diffp_on(diffp))
            reg = {"type": "vn_register", "survey_id": survey_id,
                   "expected": expected, "proofs": True,
                   "expected_range": len(dps),
                   "thresholds": {t: thresholds for t in rq.PROOF_TYPES},
                   "client_pub": list(self.public),
                   "ranges": [list(r) for r in ranges],
                   "range_sig_pubs": sig_pubs}
            for e, (_r, err) in zip(vns, _fan_entries(
                    vns, lambda e: dict(reg), self.policy)):
                if err is not None:
                    raise err

        lrp_msg = None
        if lr_params is not None:
            lrp_msg = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(lr_params).items()}
        r = call_entry(root, {"type": "survey_query", "op": op,
                              "survey_id": survey_id,
                              "query_min": query_min,
                              "query_max": query_max,
                              "proofs": proofs,
                              "ranges": [list(t) for t in ranges or []],
                              "obfuscation": obfuscation,
                              "diffp": diffp,
                              "lr_params": lrp_msg,
                              "group_by": [list(v) for v in group_by]
                              if group_by else None,
                              "range_offset": range_offset,
                              "min_dp_quorum": int(min_dp_quorum),
                              "dp_exclude": dp_exclude,
                              "client_pub": list(self.public)},
                       timeout=max(timeout, rp.CALL_TIMEOUT_S),
                       policy=self.policy)
        self.last_responders = list(r.get("responders") or [])
        self.last_absent = list(r.get("absent") or [])
        self.last_resumes = int(r.get("resumes") or 0)
        self.last_phases = dict(r.get("phases") or {})
        self.last_decrypted = dec = self._decrypt(
            _limbs(r["switched"], self.device), dlog)
        if op == "log_reg":
            # the discrete-log lookup returns host values: one upload
            Ts = lr.unpack(torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
                dec.values).to(self.device), lr_params)
            result = lr.train(Ts, lr_params).cpu().numpy()
        elif group_by:
            result = st.decode_grouped(op, dec, st.group_grid(group_by),
                                       query_min, query_max)
        else:
            result = st.decode(op, dec, query_min, query_max)
        self.last_net = _net_delta(net0, tr.link_model().stats())
        if not proofs:
            return result

        # the handler may wait `timeout` on its own counter plus the
        # straggler grace on its polls: the socket outlives both
        block = call_entry(root_vn, {"type": "end_verification",
                                     "survey_id": survey_id,
                                     "timeout": timeout,
                                     "vn_quorum": float(vn_quorum)},
                           timeout=2 * timeout + 3 * rp.STRAGGLER_GRACE_S,
                           policy=self.policy)
        self.last_net = _net_delta(net0, tr.link_model().stats())
        return result, block

    def _decrypt(self, switched, dlog) -> st.DecryptedVector:
        """Decryption under the querier's key and the discrete-log
        lookup, on the client's device."""
        dl = dlog if dlog is not None else eg.DecryptionTable(limit=10000)
        dl = dl.to(self.device)
        xq = eg.secret_to_limbs(self.secret).to(self.device)
        pts = eg.decrypt_point(switched, xq)
        vals, found = dl.lookup(pts)
        return st.DecryptedVector(
            values=vals.cpu().numpy().astype(np.int64),
            found=found.cpu().numpy(),
            is_zero=C.is_infinity(pts).cpu().numpy())

    # -- the remote skipchain audit (reference api_skipchain.go:48-106)
    def _root_vn(self):
        vns = self.roster.of_role("vn")
        if not vns:
            raise ValueError("roster has no VNs")
        return vns[0]

    @staticmethod
    def _block_of(r: dict):
        return Block.from_bytes(_unpack_bytes(r["block"])) \
            if r.get("found") else None

    def get_genesis(self):
        return self._block_of(call_entry(self._root_vn(),
                                         {"type": "get_genesis"}))

    def get_latest(self):
        return self._block_of(call_entry(self._root_vn(),
                                         {"type": "get_latest"}))

    def get_block(self, index: int = None, survey_id: str = None):
        msg = {"type": "get_block"}
        if survey_id is not None:
            msg["survey_id"] = survey_id
        else:
            msg["index"] = int(index)
        return self._block_of(call_entry(self._root_vn(), msg))

    def get_proofs(self, survey_id: str) -> dict[str, bytes]:
        """Stored proof bytes of a survey, keyed as the VN's store keys
        them."""
        r = call_entry(self._root_vn(), {"type": "get_proofs",
                                         "survey_id": survey_id})
        return {k: _unpack_bytes(v) for k, v in r["proofs"].items()}

    def close_db(self) -> None:
        for e in self.roster.of_role("vn"):
            call_entry(e, {"type": "close_db"})


__all__ = ["RosterEntry", "Roster", "DrynxNode", "RemoteClient",
           "call_entry", "pub_table", "base_table"]
