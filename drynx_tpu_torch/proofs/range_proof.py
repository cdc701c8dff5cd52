"""Batched CCS-style ZK range proofs with Boneh-Boyen digit signatures:
creation and verification.

The port's counterpart of drynx_tpu/proofs/range_proof.py, with the same
transcripts and wire bytes. A data provider proves each plaintext s in
[0, u^l) by its base-u digits. Each computing node publishes signatures
A[k] = (x + k)^-1 B2 for k < u; the proof blinds the digit signatures
(V = v A[digit]), commits D = (sum_j u^j s_j) B + (sum_j m_j) P and
a_ij = e(-s_j B, V_ij) gtB^t_j, hashes every commitment into the
Fiat-Shamir challenge

    c = sha3-512(B || C2 || sum Y || u || l || D || V_pts || a)

and answers with Zphi_j = s_j - c digit_j, Zr = sum m - c r and
Zv_ij = t_j - c v_ij. The verifier checks

    D == c C2 + Zr P + (sum_j u^j Zphi_j) B
    a == e(c y_i - Zphi_j B, V_ij) gtB^Zv_ij

Creation takes the reference's TPU route on every device: by bilinearity
e(-s B, v A[k]) = e(B, A[k])^(-s v), and the powers of the ns*u fixed bases
e(B, A_i[k]) go through per-base window tables, a gather and two passes of
the 8-way Fp12 product kernel (`cuda_pairing.gt_pow_fixed_multi`); gtB^t
likewise. The one pairing per base is computed once per signature set and
kept on the RangeSig: by the pairing kernels on the card, by the port's
pure-Python oracle on the CPU. GT values are canonical residues, so the
bytes equal those of the reference's CPU route. Randomness is explicit: a
torch.Generator, or the draws themselves.

Verification has the reference's two routes: the per-value check
(`verify_range_proofs`, one pairing per digit proof) and the verifying
nodes' joint check (`verify_range_proof_payloads_joint`), which decodes
every DP's payload, concatenates the batches of one (u, l) spec and checks
them at once by a random linear combination in the exponent
(`verify_range_proofs_batch`): one Miller loop per digit proof, one shared
final exponentiation. A payload that fails to decode, or whose batch makes
the verifier raise, fails for itself alone; a kernel that fails to build
or launch (`cuda_build.KernelError`), memory that runs out or a CUDA
error is a fault of the program or the card and propagates.

Creation's commit stage runs over slices of the value axis when the proof
plane is enabled or V passes the tile threshold (`_commit_kernel_sharded`),
and the joint check's pairing work over the plane's shards
(parallel/proof_mesh.py); both are byte-identical to one dispatch.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import secrets as _secrets
import threading
from typing import Optional

import numpy as np
import torch

from .. import pool as pool_mod
from ..compilecache.stats import COLD_EVENTS
from ..crypto import cuda_pairing as CP
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto import fp12 as F12
from ..crypto import g2 as G2
from ..crypto import gt as GT
from ..crypto import params, refimpl
from ..crypto.field import FN, FP
from ..crypto.gt import GT_SHAPE, gt_mul
from ..crypto.params import NUM_LIMBS
from ..utils.cuda_build import is_fault
from ..utils.device import resolve
from . import encoding as enc

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Signatures and their GT tables (host builds, once per signature set)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RangeSig:
    """One server's digit-signature set for base u, with its GT tables
    once built."""

    secret: int
    public: tuple                     # host affine G1 ints (y = x B)
    A: torch.Tensor                   # (u, 3, 2, 16) G2 Jacobian Montgomery
    gt: Optional[torch.Tensor] = None       # (u, 6, 2, 16) e(B, A[k])
    gt_pow: Optional[torch.Tensor] = None   # (u, 64, 16, 6, 2, 16) windows

    @property
    def u(self) -> int:
        return self.A.shape[0]


def init_range_sig(u: int, rng: np.random.Generator) -> RangeSig:
    """BB signatures A[k] = (x + k)^-1 B2, k in [0, u): the reference's
    draws, so one seed gives one signature set in both packages."""
    x, pub = eg.keygen(rng)
    pts = [G2.from_ref(refimpl.g2_mul(
        refimpl.G2, pow((x + k) % params.N, params.N - 2, params.N)))
        for k in range(u)]
    # the signatures are the range proofs' public table ((x + k)^-1 B2
    # hides x as a public key does), and nothing reads the signer's x, kept
    # as the reference keeps it: the set is public
    return RangeSig(secret=x, public=pub, A=torch.stack(pts))  # drynx: declassify[secret]


def to_base(n, b: int, l: int) -> np.ndarray:
    """Base-b digits, little-endian, padded to l (reference ToBase)."""
    n = np.asarray(n, dtype=np.int64)
    digits = np.zeros(n.shape + (l,), dtype=np.int32)
    cur = n.copy()
    for j in range(l):
        digits[..., j] = cur % b
        cur //= b
    return digits


def _window_table(base) -> torch.Tensor:
    """T[w][j] = base^(j 16^w) for a host Fp12 base: (64, 16, 6, 2, 16)."""
    rows, cur = [], base
    for _w in range(CP.N_WINDOWS):
        row = refimpl.FP12_ONE
        rows.append(row)
        for _j in range(1, CP.WINDOW_ENTRIES):
            row = refimpl.fp12_mul(row, cur)
            rows.append(row)
        for _ in range(4):
            cur = refimpl.fp12_sq(cur)
    return F12.from_ref_batch(rows).reshape(
        (CP.N_WINDOWS, CP.WINDOW_ENTRIES) + GT_SHAPE)


# Table-build counters: bumped only by REAL builds (the pairing
# batch, the host window tables), never when a RangeSig or the persistent
# store already holds the table. Each build is also a cold event
# (compilecache.stats.COLD_EVENTS), as is the gtB window table's. The pool tests assert they stay flat when
# a fresh cluster reloads from a warm store.
SIG_BUILD_COUNTS = {"gt_table": 0, "pow_table": 0}
# Proof threads build sig tables concurrently; dict += is read-modify-
# write, so the counters are bumped under a lock.
_SIG_COUNT_LOCK = threading.Lock()


def _sig_store():
    """The persistent sig-table store, if a crypto pool is active
    (content-addressed by A-table digest: safe to share process-wide)."""
    return pool_mod.active_pool()


def _a_bytes(sg: RangeSig) -> bytes:
    """A's bytes in the reference's uint32 layout (its digest input)."""
    return sg.A.cpu().numpy().astype(np.uint32).tobytes()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def sig_gt_table(sigs: list[RangeSig], device=None) -> torch.Tensor:
    """(ns, u, 6, 2, 16) on `device` (None: the card): gtA[i][k] = e(B,
    A_i[k]), computed once per signature set and kept on each RangeSig.
    A set the active crypto pool holds (key: sha256 of A, the reference's)
    is loaded from it; the others are paired and stored there. On a CUDA
    device the missing sets are paired in one batch by the pairing
    kernels (the reference's route, range_proof.py:115-121); on the CPU by
    the host oracle."""
    dev = resolve(device)
    store = _sig_store()
    if store is not None:
        for sg in sigs:
            if sg.gt is None:
                d = store.load_sig("gt", hashlib.sha256(_a_bytes(sg))
                                   .hexdigest())
                if d is not None:
                    sg.gt = _i32(d["gt"])
    missing = [sg for sg in sigs if sg.gt is None]
    if missing:
        COLD_EVENTS.note("table", "sig_gt_table")
        with _SIG_COUNT_LOCK:
            SIG_BUILD_COUNTS["gt_table"] += 1
    if missing and dev.type == "cuda":
        for sg, g in zip(missing, _pair_generator_with(
                torch.stack([sg.A for sg in missing]).to(dev))):
            sg.gt = g
    else:
        for sg in missing:
            sg.gt = F12.pair_host(refimpl.G1, G2.to_ref(sg.A))
    if store is not None:
        for sg in missing:
            store.save_sig("gt", hashlib.sha256(_a_bytes(sg)).hexdigest(),
                           gt=_u32(sg.gt))
    return torch.stack([sg.gt.to(dev) for sg in sigs])


def _pair_generator_with(A: torch.Tensor) -> torch.Tensor:
    """e(B, A) for twist points A (..., 3, 2, 16), none at infinity, by the
    pairing kernels on A's device: (..., 6, 2, 16)."""
    qx, qy, _ = G2.normalize(A)
    b = C.from_ref(refimpl.G1).to(A.device)          # affine: Z = 1
    shape = qx.shape[:-2] + (NUM_LIMBS,)
    return GT.pair(b[0].expand(shape), b[1].expand(shape), qx, qy)


def sig_gt_pow_tables(sigs: list[RangeSig], device=None) -> torch.Tensor:
    """(ns*u, 64, 16, 6, 2, 16) on `device` (None: the card): the 4-bit
    window tables of every base gtA[i][k], base-major (i*u + k). Built on
    the host from sig_gt_table once per signature set; each RangeSig keeps
    its tables on the device last asked for."""
    device = resolve(device)
    if any(sg.gt_pow is None for sg in sigs):
        store = _sig_store()
        key = hashlib.sha256(b"".join(_a_bytes(sg) for sg in sigs)).hexdigest()
        d = store.load_sig("pow", key) if store is not None else None
        if d is not None:
            for sg, T in zip(sigs, _i32(d["T"]).split(
                    [sg.u for sg in sigs])):
                sg.gt_pow = T
        else:
            COLD_EVENTS.note("table", "sig_gt_pow_tables")
            with _SIG_COUNT_LOCK:
                SIG_BUILD_COUNTS["pow_table"] += 1
            gts = sig_gt_table(sigs, device)
            for sg, gt in zip(sigs, gts):
                if sg.gt_pow is None:
                    sg.gt_pow = torch.stack([_window_table(F12.to_ref(g))
                                             for g in gt])
            if store is not None:
                store.save_sig("pow", key, T=np.concatenate(
                    [_u32(sg.gt_pow) for sg in sigs]))
    for sg in sigs:
        sg.gt_pow = sg.gt_pow.to(device)
    return torch.cat([sg.gt_pow for sg in sigs])


@functools.cache
def gt_base() -> torch.Tensor:
    """e(B, B2), (6, 2, 16) on the CPU."""
    return F12.pair_host(refimpl.G1, [refimpl.G2])[0]


@functools.cache
def gt_base_table() -> torch.Tensor:
    """Window table of gtB powers, T[w][j] = gtB^(j 16^w), on the CPU."""
    COLD_EVENTS.note("table", "gt_base_table")
    return _window_table(F12.to_ref(gt_base()))


def gt_pow_gtb(k: torch.Tensor) -> torch.Tensor:
    """gtB^k over any leading shape of k (..., 16) plain limbs."""
    out = CP.gt_pow_fixed(gt_base_table().to(k.device),
                          k.reshape(-1, NUM_LIMBS))
    return out.reshape(k.shape[:-1] + GT_SHAPE)


# ---------------------------------------------------------------------------
# Proof container and the canonical transcript
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RangeProofBatch:
    """Proofs for V values against ns servers, base u, l digits (reference
    RangeProofData with the value axis batched)."""

    commit: torch.Tensor      # (V, 2, 3, 16) the ciphertexts
    challenge: torch.Tensor   # (V, 16)
    zr: torch.Tensor          # (V, 16)
    d: torch.Tensor           # (V, 3, 16)
    zphi: torch.Tensor        # (V, l, 16)
    zv: torch.Tensor          # (ns, V, l, 16)
    v_pts: torch.Tensor       # (ns, V, l, 3, 2, 16)
    a: torch.Tensor           # (ns, V, l, 6, 2, 16)
    u: int
    l: int
    # canonical commitment bytes, the hash input and the wire format at
    # once: {'commit': (V, 128), 'd': (V, 64), 'v': (ns, V, l, 128),
    # 'a': (ns, V, l, 384)} uint8. When set, it MUST encode the tensors
    # above; a modified copy passes wire=None.
    wire: Optional[dict] = None

    @property
    def n_values(self) -> int:
        return int(self.commit.shape[0])

    @property
    def n_servers(self) -> int:
        return int(self.zv.shape[0])

    def wire_bytes(self) -> dict:
        if self.wire is None:
            self.wire = _range_wire_dict(self.commit, self.d, self.v_pts,
                                         self.a)
        return self.wire

    def to_bytes(self) -> bytes:
        """Canonical serialization (the reference's RangeProofBatch bytes)."""
        head = np.asarray([self.u, self.l, self.n_values, self.n_servers],
                          dtype="<i8").tobytes()
        w = self.wire_bytes()
        parts = [w["commit"], enc.scalar_bytes(self.challenge),
                 enc.scalar_bytes(self.zr), w["d"],
                 enc.scalar_bytes(self.zphi), enc.scalar_bytes(self.zv),
                 w["v"], w["a"]]
        return head + b"".join(np.ascontiguousarray(p).tobytes()
                               for p in parts)

    @classmethod
    def from_bytes(cls, buf: bytes, device=None) -> "RangeProofBatch":
        """Decode the canonical bytes onto `device` (None: the card),
        keeping the received commitment bytes as the wire cache (the
        challenge hashes them as transmitted). Raises on a truncated or
        inconsistent buffer."""
        device = resolve(device)
        u, l, V, ns = (int(x) for x in np.frombuffer(buf[:32], dtype="<i8"))
        off = 32

        def take(shape, nbytes):
            nonlocal off
            flat = np.frombuffer(buf[off:off + nbytes], dtype=np.uint8)
            off += nbytes
            return flat.reshape(shape)

        scalars = lambda b: enc.bytes_to_limbs(b).to(device)
        commit_b = take((V, 2, 64), V * 128)
        commit = _g1_from_bytes(commit_b, device)
        challenge = scalars(take((V, 32), V * 32))
        zr = scalars(take((V, 32), V * 32))
        d_b = take((V, 64), V * 64)
        d = _g1_from_bytes(d_b, device)
        zphi = scalars(take((V, l, 32), V * l * 32))
        zv = scalars(take((ns, V, l, 32), ns * V * l * 32))
        v_b = take((ns, V, l, 128), ns * V * l * 128)
        v_pts = _g2_from_bytes(v_b, device)
        a_b = take((ns, V, l, 384), ns * V * l * 384)
        a = _gt_from_bytes(a_b, device)
        wire = {"commit": commit_b.reshape(V, 128).copy(), "d": d_b.copy(),
                "v": v_b.copy(), "a": a_b.copy()}
        return cls(commit, challenge, zr, d, zphi, zv, v_pts, a, u, l,
                   wire=wire)


def _to_mont_bytes(b, device) -> torch.Tensor:
    """(..., 32) big-endian Fp bytes -> (..., 16) Montgomery limbs on
    `device` (a value at or above p is reduced, as the reference's to_mont
    does)."""
    return F.to_mont(enc.bytes_to_limbs(b).to(device), FP)


def _one_mont(shape, device) -> torch.Tensor:
    return FP.one_mont(device).to(torch.int32).expand(
        tuple(shape) + (NUM_LIMBS,)).clone()


def _g1_from_bytes(b: np.ndarray, device) -> torch.Tensor:
    """(..., 64) canonical bytes -> (..., 3, 16) Jacobian Montgomery; the
    all-zero encoding is infinity (X = Y = Montgomery one, Z = 0)."""
    inf = torch.from_numpy(np.all(b == 0, axis=-1)).to(device)
    xm, ym = _to_mont_bytes(b[..., :32], device), _to_mont_bytes(b[..., 32:],
                                                                  device)
    one = _one_mont(inf.shape, device)
    z = torch.where(inf[..., None], 0, one)
    return torch.stack([torch.where(inf[..., None], one, xm),
                        torch.where(inf[..., None], one, ym), z], dim=-2)


def _g2_from_bytes(b: np.ndarray, device) -> torch.Tensor:
    """(..., 128) -> (..., 3, 2, 16) Jacobian Montgomery; infinity is
    X = Y = (Montgomery one, 0), Z = 0 (g2.from_ref's convention)."""
    inf = torch.from_numpy(np.all(b == 0, axis=-1)).to(device)
    xy = _to_mont_bytes(b.reshape(b.shape[:-1] + (2, 2, 32)), device)
    one2 = torch.zeros(inf.shape + (2, NUM_LIMBS), dtype=torch.int32,
                       device=device)
    one2[..., 0, :] = _one_mont(inf.shape, device)
    sel = inf[..., None, None]
    return torch.stack([torch.where(sel, one2, xy[..., 0, :, :]),
                        torch.where(sel, one2, xy[..., 1, :, :]),
                        torch.where(sel, 0, one2)], dim=-3)


def _gt_from_bytes(b: np.ndarray, device) -> torch.Tensor:
    """(..., 384) -> (..., 6, 2, 16) Montgomery."""
    return _to_mont_bytes(b.reshape(b.shape[:-1] + (6, 2, 32)), device)


def _range_wire_dict(commit, d, v_pts, a) -> dict:
    """The one definition of the canonical commitment encoding."""
    return {"commit": enc.ct_bytes(commit), "d": enc.g1_bytes(d),
            "v": enc.g2_bytes(v_pts), "a": enc.gt_bytes(a)}


def _g1_bytes_host(pt) -> np.ndarray:
    """Canonical 64 bytes of a host affine point; None encodes all-zero."""
    if pt is None:
        return np.zeros(64, dtype=np.uint8)
    return np.frombuffer(int(pt[0]).to_bytes(32, "big")
                         + int(pt[1]).to_bytes(32, "big"), dtype=np.uint8)


def sum_publics_bytes(sigs: list[RangeSig]) -> np.ndarray:
    acc = None
    for s in sigs:
        acc = refimpl.g1_add(acc, s.public)
    return _g1_bytes_host(acc)


def challenge_from_wire(wire: dict, sum_y_bytes: np.ndarray, u: int,
                        l: int) -> torch.Tensor:
    """Per-value Fiat-Shamir challenge from the canonical wire bytes,
    c = sha3-512(B || C2 || sum Y || u || l || D || V_pts[., v, .] ||
    a[., v, .]) mod n: (V, 16) int32 on the CPU."""
    ul = np.frombuffer(np.asarray([u, l], dtype="<i8").tobytes(),
                       dtype=np.uint8)
    V = wire["commit"].shape[0]
    c2 = wire["commit"].reshape(V, 128)[:, 64:]
    v_b = np.ascontiguousarray(np.moveaxis(wire["v"], 0, 1)).reshape(V, -1)
    a_b = np.ascontiguousarray(np.moveaxis(wire["a"], 0, 1)).reshape(V, -1)
    return enc.hash_to_scalar(_g1_bytes_host(refimpl.G1), c2, sum_y_bytes,
                              ul, wire["d"], v_b, a_b, batch_shape=(V,))


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _upow_mont(u: int, l: int, device) -> torch.Tensor:
    """[u^j mod n for j < l] in Montgomery form, (l, 16)."""
    return F.from_int([pow(u, j, params.N) * params.R % params.N
                       for j in range(l)]).to(device)


def _mul_plain(a, b):
    """a * b mod n for plain scalar limbs (broadcast)."""
    return F.mont_mul(F.to_mont(a, FN), b, FN)


def _weighted_sum_mod_n(s_plain, upow_m):
    """sum_j u^j s_j mod n. s_plain (..., l, 16), upow_m (l, 16) Montgomery
    (a plain times a Montgomery factor is the plain product)."""
    prod = F.mont_mul(s_plain, upow_m, FN)
    acc = prod[..., 0, :]
    for j in range(1, prod.shape[-2]):
        acc = F.add(acc, prod[..., j, :], FN)
    return acc


def _commit_kernel(digits, s, t, m, v, A_tab, ca_tbl, gtA_pow, u: int,
                   l: int):
    """Commitment stage (independent of the challenge). digits (V, l) int64;
    s, t, m (V, l, 16); v (ns, V, l, 16); A_tab (ns, u, 3, 2, 16);
    ca_tbl: the collective key's fixed-base table; gtA_pow: the signature
    window tables. Returns D (V, 3, 16), sum m (V, 16), V_pts, a."""
    dev = s.device
    base_tbl = eg.BASE_TABLE.table.to(dev)
    w = _weighted_sum_mod_n(s, _upow_mont(u, l, dev))
    m_tot = m[..., 0, :]
    for j in range(1, l):
        m_tot = F.add(m_tot, m[..., j, :], FN)
    D = C.add(eg.fixed_base_mul(base_tbl, w), eg.fixed_base_mul(ca_tbl, m_tot))

    # V_ij = v_ij A_i[digit_j]: gather the digit signatures, blind in G2
    V_pts = G2.scalar_mul(A_tab[:, digits], v)             # (ns, V, l, 3, 2, 16)

    # a_ij = gtA[i][digit_j]^(-s_j v_ij) * gtB^t_j
    ns = v.shape[0]
    neg_sv = F.neg(_mul_plain(s, v), FN)                   # (ns, V, l, 16)
    base_idx = (torch.arange(ns, device=dev)[:, None, None] * u
                + digits[None])
    gt1 = CP.gt_pow_fixed_multi(gtA_pow, base_idx.reshape(-1),
                                neg_sv.reshape(-1, NUM_LIMBS))
    a = gt_mul(gt1.reshape(neg_sv.shape[:-1] + GT_SHAPE), gt_pow_gtb(t))
    return D, m_tot, V_pts, a


def _commit_kernel_sharded(digits, s, t, m, v, A_tab, ca_tbl, gtA_pow,
                           u: int, l: int, n_shards: int, spread: bool):
    """The commitment stage over `n_shards` slices of the value axis, each
    through `_commit_kernel`, gathered once before the Fiat-Shamir hash to
    the device of `digits`. spread: shard i runs on the proof plane's
    `shard_device(i, digits.device)`; else every slice (a tile) stays on
    the device of `digits`. Byte-identical to one `_commit_kernel` call:
    every value's commitments are its own, and the shards see the slices
    of the full-size draws. The signature window tables are built once by
    the caller and shared by every shard."""
    from ..parallel import proof_plane as plane

    slices = plane.shard_slices(int(digits.shape[0]), n_shards)
    if len(slices) <= 1:
        return _commit_kernel(digits, s, t, m, v, A_tab, ca_tbl, gtA_pow, u,
                              l)

    def stage(i, a, b):
        part = (digits[a:b], s[a:b], t[a:b], m[a:b], v[:, a:b])
        return plane.put_shard(part, i, digits.device) if spread else part

    def commit(i, sd, ss, st, sm, sv):
        dev = sd.device
        return _commit_kernel(sd, ss, st, sm, sv, A_tab.to(dev),
                              ca_tbl.to(dev), gtA_pow.to(dev), u, l)

    parts = plane.dispatch_shards("CreateShard", commit, slices,
                                  prefetch=stage)
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts], dim=1),
            torch.cat([p[3] for p in parts], dim=1))


def _response_kernel(digits, c, rs, s, t, m_tot, v):
    """Given the bound challenge c: Zphi_j = s_j - c digit_j,
    Zr = sum m - c r, Zv_ij = t_j - c v_ij."""
    phi = eg.int_to_scalar(digits)                         # (V, l, 16)
    c_l = c[..., None, :]
    zphi = F.sub(s, _mul_plain(c_l, phi), FN)
    zr = F.sub(m_tot, _mul_plain(c, rs), FN)
    zv = F.sub(t, _mul_plain(c_l, v), FN)
    return zphi, zr, zv


def create_range_proofs(secrets, rs, cts, sigs: list[RangeSig], u: int,
                        l: int, ca_pub_table,
                        generator: Optional[torch.Generator] = None,
                        draws=None, tile: Optional[int] = None,
                        n_shards: Optional[int] = None) -> RangeProofBatch:
    """Proofs for V values at once, on the device of `cts`.

    secrets: int64 (V,) plaintexts in [0, u^l); rs: (V, 16) their
    encryption blinding scalars; cts: (V, 2, 3, 16) their ciphertexts under
    the collective key, whose fixed-base table is ca_pub_table. The
    randomness s, t, m (V, l, 16) and v (ns, V, l, 16) is drawn from
    `generator` in that order, or given as `draws`.

    n_shards: the proof plane's shard count (None: `proof_plane.n_shards()`,
    the visible CUDA devices); above 1 the commitment stage is split along
    the value axis over that many shards, shard i on the plane's
    `shard_device(i, cts.device)`. tile: bound every commit-stage dispatch
    by `tile` values (None: `tiles.auto_tile(V)`, tiling above the
    threshold; 0: never); tiles alone stay on the device of `cts`. The
    dispatch count is the larger of the two. The draws are made
    at full size before any split and the challenge is hashed per value
    over the gathered commitments, so the transcripts are byte-identical
    to the monolithic ones.
    """
    from ..encoding import tiles
    from ..parallel import proof_plane as plane

    dev = cts.device
    secrets = np.asarray(torch.as_tensor(secrets, dtype=torch.int64).cpu())
    V, ns = secrets.shape[0], len(sigs)
    digits = torch.from_numpy(to_base(secrets, u, l)).to(dev, torch.int64)
    if draws is None:
        if generator is None:
            raise ValueError("create_range_proofs needs a generator or draws")
        draws = [eg.random_scalars(shape, generator, dev)
                 for shape in ((V, l), (V, l), (V, l), (ns, V, l))]
    s, t, m, v = (d.to(dev) for d in draws)
    A_tab = torch.stack([sg.A for sg in sigs]).to(dev)
    n_plane = plane.n_shards() if n_shards is None else n_shards
    if tile is None:
        tile = tiles.auto_tile(V)
    k = max(n_plane, tiles.proof_tile_shards(V, tile) if tile else 1)
    D, m_tot, V_pts, a = _commit_kernel_sharded(
        digits, s, t, m, v, A_tab, ca_pub_table,
        sig_gt_pow_tables(sigs, dev), u, l, k, spread=n_plane > 1)
    # commit -> Fiat-Shamir over the canonical bytes -> respond; the bytes
    # are the wire format too
    wire = _range_wire_dict(cts, D, V_pts, a)
    c = challenge_from_wire(wire, sum_publics_bytes(sigs), u, l).to(dev)
    zphi, zr, zv = _response_kernel(digits, c, rs.to(dev), s, t, m_tot, v)
    return RangeProofBatch(commit=cts, challenge=c, zr=zr, d=D, zphi=zphi,
                           zv=zv, v_pts=V_pts, a=a, u=u, l=l, wire=wire)


# ---------------------------------------------------------------------------
# Mixed-range proof lists (per-value (u, l) specs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RangeProofList:
    """Per-DP proof payload: values sharing a (u, l) spec are one
    RangeProofBatch, listed with the output indices it covers; indices with
    spec (0, 0) carry no proof."""

    n_values: int
    batches: list                      # [(int64 index array, RangeProofBatch)]

    def to_bytes(self) -> bytes:
        parts = [np.asarray([self.n_values, len(self.batches)],
                            dtype="<i8").tobytes()]
        for idx, pb in self.batches:
            blob = pb.to_bytes()
            idx = np.asarray(idx, dtype="<i8")
            parts.append(np.asarray([idx.size, len(blob)],
                                    dtype="<i8").tobytes())
            parts.append(idx.tobytes())
            parts.append(blob)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, buf: bytes, device=None) -> "RangeProofList":
        """Decode a DP's payload onto `device` (None: the card)."""
        device = resolve(device)
        n_values, n_batches = np.frombuffer(buf[:16], dtype="<i8")
        off = 16
        batches = []
        for _ in range(int(n_batches)):
            n_idx, n_blob = (int(x) for x in
                             np.frombuffer(buf[off:off + 16], dtype="<i8"))
            off += 16
            idx = np.frombuffer(buf[off:off + 8 * n_idx], dtype="<i8")
            off += 8 * n_idx
            pb = RangeProofBatch.from_bytes(buf[off:off + n_blob], device)
            off += n_blob
            batches.append((idx.copy(), pb))
        return cls(n_values=int(n_values), batches=batches)


def group_ranges(ranges) -> dict:
    """{(u, l): [output indices]} for nonzero specs, insertion-ordered."""
    spec_to_idx: dict = {}
    for i, (u, l) in enumerate(ranges):
        if u == 0 and l == 0:
            continue
        spec_to_idx.setdefault((int(u), int(l)), []).append(i)
    return spec_to_idx


def create_range_proof_list(secrets, rs, cts, ranges, sigs_by_u: dict,
                            ca_pub_table,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[dict] = None,
                            tile: Optional[int] = None) -> RangeProofList:
    """The mixed-range payload of one value vector. ranges: [(u, l)] per
    value; sigs_by_u: {u: [RangeSig per CN]}; draws: {(u, l): (s, t, m, v)}
    to inject each spec's randomness instead of drawing it; tile: forwarded
    to create_range_proofs (None: tiled above the threshold)."""
    secrets = torch.as_tensor(secrets, dtype=torch.int64)
    batches = []
    for spec, idx in group_ranges(ranges).items():
        ia = np.asarray(idx, dtype=np.int64)
        sel = torch.from_numpy(ia).to(cts.device)
        pb = create_range_proofs(
            secrets[torch.from_numpy(ia).to(secrets.device)], rs[sel],
            cts[sel], sigs_by_u[spec[0]], spec[0], spec[1], ca_pub_table,
            generator, None if draws is None else draws[spec], tile=tile)
        batches.append((ia, pb))
    return RangeProofList(n_values=len(ranges), batches=batches)


def _slice_batch(pb: RangeProofBatch, sel: np.ndarray) -> RangeProofBatch:
    """Sub-batch along the value axis (proofs are per-value independent)."""
    w = pb.wire_bytes()
    wire = {"commit": w["commit"][sel], "d": w["d"][sel],
            "v": w["v"][:, sel], "a": w["a"][:, sel]}
    ts = torch.from_numpy(sel).to(pb.commit.device)
    return RangeProofBatch(
        commit=pb.commit[ts], challenge=pb.challenge[ts], zr=pb.zr[ts],
        d=pb.d[ts], zphi=pb.zphi[ts], zv=pb.zv[:, ts], v_pts=pb.v_pts[:, ts],
        a=pb.a[:, ts], u=pb.u, l=pb.l, wire=wire)


def create_range_proof_lists_batched(secrets_2d, rs_2d, cts_2d, ranges,
                                     sigs_by_u: dict, ca_pub_table,
                                     generator=None, draws=None,
                                     tile: Optional[int] = None) -> list:
    """All DPs' payloads in one device-batched creation: secrets_2d
    (n_dps, V), rs_2d (n_dps, V, 16), cts_2d (n_dps, V, 2, 3, 16), ranges
    per value (shared by every DP). Returns one RangeProofList per DP, the
    same bytes as per-DP creation (each value's transcript is its own).
    tile: forwarded to create_range_proofs over the n_dps * V values."""
    secrets_2d = torch.as_tensor(secrets_2d, dtype=torch.int64)
    n_dps, V = secrets_2d.shape
    big = create_range_proof_list(
        secrets_2d.reshape(-1), rs_2d.reshape(-1, NUM_LIMBS),
        cts_2d.reshape(-1, 2, 3, NUM_LIMBS), list(ranges) * n_dps, sigs_by_u,
        ca_pub_table, generator, draws, tile=tile)
    out = []
    for d in range(n_dps):
        batches = []
        for ia, pb in big.batches:
            mine = (ia // V) == d
            if np.any(mine):
                batches.append(((ia[mine] % V).astype(np.int64),
                                _slice_batch(pb, np.nonzero(mine)[0])))
        out.append(RangeProofList(n_values=V, batches=batches))
    return out


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def _publics(sigs_pub, device) -> torch.Tensor:
    return torch.stack([C.from_ref(p) for p in sigs_pub]).to(device)


def _d_equation_ok(proof: RangeProofBatch, ca_pub_table) -> torch.Tensor:
    """D == c C2 + Zr P + (sum_j u^j Zphi_j) B per value, (V,) bool."""
    dev = proof.commit.device
    wz = _weighted_sum_mod_n(proof.zphi, _upow_mont(proof.u, proof.l, dev))
    Dp = C.add(C.scalar_mul(proof.commit[..., 1, :, :], proof.challenge),
               C.add(eg.fixed_base_mul(ca_pub_table, proof.zr),
                     eg.fixed_base_mul(eg.BASE_TABLE.table.to(dev), wz)))
    return C.eq(Dp, proof.d)


def _g1_args(proof: RangeProofBatch, sigs_pub):
    """c y_i - Zphi_j B for every digit proof, (ns, V, l, 3, 16)."""
    dev = proof.commit.device
    cy = C.scalar_mul(_publics(sigs_pub, dev)[:, None], proof.challenge[None])
    nzphiB = eg.fixed_base_mul(eg.BASE_TABLE.table.to(dev),
                               F.neg(proof.zphi, FN))
    return C.add(cy[:, :, None], nzphiB[None])


def _verify_kernel(proof: RangeProofBatch, sigs_pub, ca_pub_table):
    """The per-value check of every digit proof, (V,) bool:
    D == c C2 + Zr P + (sum u^j Zphi_j) B, and
    a_ij == e(c y_i - Zphi_j B, V_ij) gtB^Zv_ij for every server i and
    digit j, one full pairing per digit proof."""
    d_ok = _d_equation_ok(proof, ca_pub_table)
    px, py, _ = C.normalize(_g1_args(proof, sigs_pub))
    qx, qy, _ = G2.normalize(proof.v_pts)
    ap = gt_mul(GT.pair(px, py, qx, qy), gt_pow_gtb(proof.zv))
    a_ok = F12.eq(ap, proof.a).all(-1).all(0)
    return d_ok & a_ok


def _challenge_ok(proof: RangeProofBatch, sigs_pub) -> np.ndarray:
    """The challenge recomputed from the transmitted commitment bytes equals
    the transmitted one, per value: a forger who derives D or a after
    fixing c changes c."""
    acc = None
    for p in sigs_pub:
        acc = refimpl.g1_add(acc, p)
    want = challenge_from_wire(proof.wire_bytes(), _g1_bytes_host(acc),
                               proof.u, proof.l)
    return np.all(proof.challenge.cpu().numpy() == want.numpy(), axis=-1)


def verify_range_proofs(proof: RangeProofBatch, sigs_pub,
                        ca_pub_table) -> np.ndarray:
    """The per-value verdicts of a proof batch against the servers'
    publics (host affine int pairs), on the proof's device: (V,) bool."""
    return (_verify_kernel(proof, sigs_pub, ca_pub_table).cpu().numpy()
            & _challenge_ok(proof, sigs_pub))


def _sum_mod_n(x: torch.Tensor) -> torch.Tensor:
    """sum of (K, 16) scalars mod n by a pairwise tree."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = F.add(x[0::2], x[1::2], FN)
    return x[0]


def rlc_prelude(proof: RangeProofBatch, sigs_pub, ca_pub_table,
                rng: Optional[np.random.Generator] = None):
    """The RLC check's acceptance preamble: the D equation of every value,
    the challenge recomputed from the bytes, GPhi12 membership and order n
    of every wire-provided a (in that order, each only if the ones before
    held), the verifier-secret 62-bit weights r (ns, V, l) drawn by
    `rng.integers(1, 2^62)` (seeded from 16 fresh random bytes without an
    rng), and gtB^(sum r Zv). Returns (pre_ok, r_int, gtb_pow_s)."""
    ns, V, l = len(sigs_pub), proof.n_values, proof.l
    ok = (bool(_d_equation_ok(proof, ca_pub_table).all())
          and bool(np.all(_challenge_ok(proof, sigs_pub)))
          and GT.gt_membership_ok(proof.a) and GT.gt_order_ok(proof.a))

    if rng is None:
        rng = np.random.default_rng(
            np.frombuffer(_secrets.token_bytes(16), dtype=np.uint64))
    r_int = rng.integers(1, 1 << 62, size=(ns, V, l), dtype=np.int64)

    r = eg.int_to_scalar(torch.from_numpy(r_int).to(proof.zv.device))
    S = _sum_mod_n(_mul_plain(r, proof.zv).reshape(-1, NUM_LIMBS))
    return ok, r_int, gt_pow_gtb(S[None])[0]


def rlc_total_single(proof: RangeProofBatch, sigs_pub, r_int, gtb_pow_s):
    """The RLC check's GT total on one device, (6, 2, 16): it is one iff
    the batch verifies under the weights r_int,
      prod_ij [e(r_ij (c y_i - Zphi_j B), V_ij) conj6(a_ij)^r_ij]
      * gtB^(sum_ij r_ij Zv_ij),
    with one final exponentiation for the product of all Miller values
    (the a^r factors are already in GT and are not exponentiated again)."""
    r = eg.int_to_scalar(torch.from_numpy(r_int).to(proof.zv.device))
    # the weights are 62-bit, so their ladder runs 16 windows, not 64
    px, py, _ = C.normalize(C.scalar_mul_short(_g1_args(proof, sigs_pub), r,
                                               64))
    qx, qy, _ = G2.normalize(proof.v_pts)
    m = GT.miller(px, py, qx, qy)
    ar = GT.gt_pow64(F12.conj6(proof.a), r)
    fe = CP.final_exp_flat(
        GT.gt_reduce_prod(m.reshape((-1,) + GT_SHAPE))[None])
    Pa = GT.gt_reduce_prod(ar.reshape((-1,) + GT_SHAPE))
    return gt_mul(gt_mul(fe, Pa[None]), gtb_pow_s[None])[0]


def verify_range_proofs_batch(proof: RangeProofBatch, sigs_pub, ca_pub_table,
                              rng: Optional[np.random.Generator] = None
                              ) -> bool:
    """One verdict for a whole batch by a random linear combination in the
    exponent (the reference's verify_range_proofs_batch, whose docstring
    gives the soundness argument): the preamble, then the GT total against
    one."""
    pre_ok, r_int, gtb_pow_s = rlc_prelude(proof, sigs_pub, ca_pub_table,
                                           rng=rng)
    if not pre_ok:
        return False
    total = rlc_total_single(proof, sigs_pub, r_int, gtb_pow_s)
    return bool(F12.eq(total, F12.one((), total.device)))


# ---------------------------------------------------------------------------
# Joint verification of many payloads
# ---------------------------------------------------------------------------

def _batch_shapes_ok(pb: RangeProofBatch, ns_expected: int) -> bool:
    """The decoded batch's tensors agree with each other and with the
    published roster (from_bytes trusts the payload's own header)."""
    try:
        ns, l, V = pb.n_servers, int(pb.l), pb.n_values
        return (ns == ns_expected and l >= 1 and V >= 1
                and tuple(pb.commit.shape) == (V, 2, 3, NUM_LIMBS)
                and tuple(pb.challenge.shape) == (V, NUM_LIMBS)
                and tuple(pb.zr.shape) == (V, NUM_LIMBS)
                and tuple(pb.d.shape) == (V, 3, NUM_LIMBS)
                and tuple(pb.zphi.shape) == (V, l, NUM_LIMBS)
                and tuple(pb.zv.shape) == (ns, V, l, NUM_LIMBS)
                and tuple(pb.v_pts.shape) == (ns, V, l, 3, 2, NUM_LIMBS)
                and tuple(pb.a.shape) == (ns, V, l) + GT_SHAPE)
    except Exception:
        return False


def _list_structure_ok(lst: RangeProofList, ranges,
                       sigs_pub_by_u: dict) -> bool:
    """Every value with a nonzero (u, l) spec is covered by exactly one
    batch of exactly that spec, every batch's base has published
    signatures, and every batch's shapes are consistent."""
    want = group_ranges(ranges)
    covered = {}
    for ia, pb in lst.batches:
        sigs = sigs_pub_by_u.get(pb.u)
        if sigs is None or not _batch_shapes_ok(pb, len(sigs)):
            return False
        if len(np.asarray(ia)) != pb.n_values:
            return False
        for i in ia:
            if int(i) in covered:
                return False
            covered[int(i)] = (pb.u, pb.l)
    for (u, l), idx in want.items():
        for i in idx:
            if covered.get(i) != (u, l):
                return False
    return set(covered) == {i for idx in want.values() for i in idx}


# Batches the sharded verifier raised on (not a fault) that the
# single-device verifier then judged: each is a fault of the sharded path,
# logged, and the verdict is the single-device one
SHARDED_FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()


def _safe_batch_verify(pb: RangeProofBatch, sigs_pub, ca_pub_table) -> bool:
    """One batch's RLC verdict, routed and contained. With the proof plane
    enabled the batch goes to the sharded verifier
    (`proof_mesh.rlc_verify_sharded`), whose verdict equals the
    single-device one; if it raises something that is not a fault, the
    single-device verifier checks the batch, and only when that one does
    not raise too is the batch counted in SHARDED_FALLBACKS and logged (a
    malformed batch raises in both and is rejected, not counted). A
    payload that makes the verifier raise fails for itself (False), never
    for its neighbours. A fault of the program or the card
    (`cuda_build.is_fault`) is not a verdict on the payload and propagates
    from either verifier."""
    global SHARDED_FALLBACKS
    from ..parallel import proof_plane as plane

    sharded_exc = None
    try:
        if plane.enabled():
            from ..parallel import proof_mesh as pm

            try:
                return pm.rlc_verify_sharded(pb, sigs_pub, ca_pub_table)
            except Exception as e:
                if is_fault(e, ca_pub_table.device):
                    raise
                sharded_exc = e
        ok = verify_range_proofs_batch(pb, sigs_pub, ca_pub_table)
    except Exception as e:
        if is_fault(e, ca_pub_table.device):
            raise
        log.warning("range batch verify raised (payload rejected)",
                    exc_info=True)
        return False
    if sharded_exc is not None:
        with _FALLBACK_LOCK:
            SHARDED_FALLBACKS += 1
        log.warning("sharded range verify raised on a batch the single "
                    "device judged", exc_info=sharded_exc)
    return ok


def verify_range_proof_list(lst: RangeProofList, ranges,
                            sigs_pub_by_u: dict, ca_pub_table) -> bool:
    """One payload against the query's specs: structure, then every
    batch's RLC check."""
    if not _list_structure_ok(lst, ranges, sigs_pub_by_u):
        return False
    return all(_safe_batch_verify(pb, sigs_pub_by_u[pb.u], ca_pub_table)
               for _ia, pb in lst.batches)


def _concat_batches(pbs: list) -> RangeProofBatch:
    """Same-spec batches concatenated along the value axis."""
    u, l = pbs[0].u, pbs[0].l
    assert all(pb.u == u and pb.l == l for pb in pbs)
    cat = lambda name, ax: torch.cat([getattr(pb, name) for pb in pbs], ax)
    wire = None
    if all(pb.wire is not None for pb in pbs):
        wire = {"commit": np.concatenate([pb.wire["commit"].reshape(
                    pb.n_values, 128) for pb in pbs]),
                "d": np.concatenate([pb.wire["d"] for pb in pbs]),
                "v": np.concatenate([pb.wire["v"] for pb in pbs], 1),
                "a": np.concatenate([pb.wire["a"] for pb in pbs], 1)}
    return RangeProofBatch(
        commit=cat("commit", 0), challenge=cat("challenge", 0),
        zr=cat("zr", 0), d=cat("d", 0), zphi=cat("zphi", 0),
        zv=cat("zv", 1), v_pts=cat("v_pts", 1), a=cat("a", 1), u=u, l=l,
        wire=wire)


def verify_range_proof_lists_joint(lists: list, ranges, sigs_pub_by_u: dict,
                                   ca_pub_table) -> list[bool]:
    """Many DPs' payloads at once: the structure of each, then one RLC check
    per (u, l) spec over the concatenation of every well-formed payload's
    values (one shared final exponentiation; the weights are drawn across
    the whole concatenation). If a joint check fails, each payload is
    checked on its own, so a neighbour's forgery costs an honest payload
    nothing. One bool per payload."""
    ok_struct = [_list_structure_ok(lst, ranges, sigs_pub_by_u)
                 for lst in lists]
    by_spec: dict = {}
    for lst, ok in zip(lists, ok_struct):
        if ok:
            for _ia, pb in lst.batches:
                by_spec.setdefault((pb.u, pb.l), []).append(pb)
    if not by_spec:
        return ok_struct
    joint_ok = all(
        _safe_batch_verify(_concat_batches(pbs), sigs_pub_by_u[u],
                           ca_pub_table)
        for (u, _l), pbs in by_spec.items())
    if joint_ok:
        return ok_struct
    return [ok and verify_range_proof_list(lst, ranges, sigs_pub_by_u,
                                           ca_pub_table)
            for lst, ok in zip(lists, ok_struct)]


def verify_range_proof_payloads_joint(datas: list, ranges,
                                      sigs_pub_by_u: dict,
                                      ca_pub_table) -> list[bool]:
    """Joint verification from the DPs' raw payload bytes, on the device
    of `ca_pub_table`: each payload decodes in its own guard, so a
    malformed one fails only itself."""
    out = [False] * len(datas)
    entries = _decode_payloads(datas, ca_pub_table.device, "survey")
    if entries:
        for (i, _lst), ok in zip(entries, verify_range_proof_lists_joint(
                [lst for _i, lst in entries], ranges, sigs_pub_by_u,
                ca_pub_table)):
            out[i] = ok
    return out


def _decode_payloads(datas: list, device, what: str) -> list:
    """(index, RangeProofList) for each payload that decodes; a malformed
    one is left out (rejected), a fault of the program or the card
    propagates."""
    entries = []
    for i, d in enumerate(datas):
        try:
            entries.append((i, RangeProofList.from_bytes(d, device)))
        except Exception as e:
            if is_fault(e, device):
                raise
            log.warning("%s range payload %d: malformed bytes, rejected",
                        what, i)
    return entries


def verify_cross_survey_payloads_joint(payloads_by_sid: dict,
                                       expected_by_sid: dict,
                                       sigs_pub_by_u: dict,
                                       ca_pub_table) -> dict:
    """Joint verification across surveys, on the device of
    `ca_pub_table`: every survey's well-formed batches of one (u, l) spec
    concatenate into one RLC check (one final exponentiation for the whole
    queue; the weights are drawn across the whole concatenation). If a
    joint check fails, each survey is checked jointly on its own
    (verify_range_proof_lists_joint, which falls back to each payload), so
    a tampered survey costs its neighbours nothing. A survey whose
    expected ranges are None (its CN no longer knows it) is all-False.
    Returns {survey id: [bool per payload, in input order]}."""
    device = ca_pub_table.device
    out = {sid: [False] * len(datas)
           for sid, datas in payloads_by_sid.items()}
    lists_by_sid = {sid: _decode_payloads(datas, device, f"survey {sid}")
                    for sid, datas in payloads_by_sid.items()
                    if expected_by_sid.get(sid) is not None}
    ok_struct: dict = {}
    by_spec: dict = {}
    for sid, entries in lists_by_sid.items():
        ranges = expected_by_sid[sid]
        ok_struct[sid] = {i: _list_structure_ok(lst, ranges, sigs_pub_by_u)
                          for i, lst in entries}
        for i, lst in entries:
            if ok_struct[sid][i]:
                for _ia, pb in lst.batches:
                    by_spec.setdefault((pb.u, pb.l), []).append(pb)
    joint_ok = all(
        _safe_batch_verify(_concat_batches(pbs), sigs_pub_by_u[u],
                           ca_pub_table)
        for (u, _l), pbs in by_spec.items())
    for sid, entries in lists_by_sid.items():
        if joint_ok:
            verdicts = [ok_struct[sid][i] for i, _lst in entries]
        else:
            verdicts = verify_range_proof_lists_joint(
                [lst for _i, lst in entries], expected_by_sid[sid],
                sigs_pub_by_u, ca_pub_table)
        for (i, _lst), ok in zip(entries, verdicts):
            out[sid][i] = ok
    return out


__all__ = ["RangeSig", "init_range_sig", "to_base", "sig_gt_table",
           "sig_gt_pow_tables", "gt_base",
           "gt_base_table", "gt_pow_gtb", "RangeProofBatch",
           "sum_publics_bytes", "challenge_from_wire", "create_range_proofs",
           "RangeProofList", "group_ranges", "create_range_proof_list",
           "create_range_proof_lists_batched", "verify_range_proofs",
           "rlc_prelude", "rlc_total_single", "verify_range_proofs_batch",
           "verify_range_proof_list", "verify_range_proof_lists_joint",
           "verify_range_proof_payloads_joint",
           "verify_cross_survey_payloads_joint"]
