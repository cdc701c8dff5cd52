"""Range-proof creation: batched CCS-style ZK range proofs with Boneh-Boyen
digit signatures.

The port's counterpart of the creation half of
drynx_tpu/proofs/range_proof.py, with the same transcripts and wire bytes.
A data provider proves each plaintext s in [0, u^l) by its base-u digits.
Each computing node publishes signatures A[k] = (x + k)^-1 B2 for k < u;
the proof blinds the digit signatures (V = v A[digit]), commits
D = (sum_j u^j s_j) B + (sum_j m_j) P and a_ij = e(-s_j B, V_ij) gtB^t_j,
hashes every commitment into the Fiat-Shamir challenge

    c = sha3-512(B || C2 || sum Y || u || l || D || V_pts || a)

and answers with Zphi_j = s_j - c digit_j, Zr = sum m - c r and
Zv_ij = t_j - c v_ij. The verifier (the reference's, for now) checks

    D == c C2 + Zr P + (sum_j u^j Zphi_j) B
    a == e(c y_i - Zphi_j B, V_ij) gtB^Zv_ij

Creation takes the reference's TPU route on every device: by bilinearity
e(-s B, v A[k]) = e(B, A[k])^(-s v), and the powers of the ns*u fixed bases
e(B, A_i[k]) go through per-base window tables, a gather and two passes of
the 8-way Fp12 product kernel (`cuda_pairing.gt_pow_fixed_multi`); gtB^t
likewise. The one pairing per base is computed on the host by the port's
pure-Python oracle, once per signature set, and kept on the RangeSig.
GT values are canonical residues, so the bytes equal those of the
reference's CPU route. Randomness is explicit: a torch.Generator, or the
draws themselves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..crypto import cuda_pairing as CP
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto import fp12 as F12
from ..crypto import g2 as G2
from ..crypto import params, refimpl
from ..crypto.field import FN
from ..crypto.params import NUM_LIMBS
from . import encoding as enc

GT_SHAPE = (6, 2, NUM_LIMBS)


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
    return RangeSig(secret=x, public=pub, A=torch.stack(pts))


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


def sig_gt_table(sigs: list[RangeSig]) -> torch.Tensor:
    """(ns, u, 6, 2, 16): gtA[i][k] = e(B, A_i[k]), paired on the host once
    per signature set and kept on each RangeSig."""
    for sg in sigs:
        if sg.gt is None:
            sg.gt = F12.pair_host(refimpl.G1, G2.to_ref(sg.A))
    return torch.stack([sg.gt for sg in sigs])


def sig_gt_pow_tables(sigs: list[RangeSig], device="cpu") -> torch.Tensor:
    """(ns*u, 64, 16, 6, 2, 16) on `device`: the 4-bit window tables of
    every base gtA[i][k], base-major (i*u + k). Built on the host once per
    signature set; each RangeSig keeps its tables on the device last asked
    for."""
    for sg in sigs:
        if sg.gt_pow is None:
            sg.gt_pow = torch.stack([_window_table(F12.to_ref(g))
                                     for g in sig_gt_table([sg])[0]])
        sg.gt_pow = sg.gt_pow.to(device)
    return torch.cat([sg.gt_pow for sg in sigs])


@functools.cache
def gt_base() -> torch.Tensor:
    """e(B, B2), (6, 2, 16) on the CPU."""
    return F12.pair_host(refimpl.G1, [refimpl.G2])[0]


@functools.cache
def gt_base_table() -> torch.Tensor:
    """Window table of gtB powers, T[w][j] = gtB^(j 16^w), on the CPU."""
    return _window_table(F12.to_ref(gt_base()))


def gt_pow_gtb(k: torch.Tensor) -> torch.Tensor:
    """gtB^k over any leading shape of k (..., 16) plain limbs."""
    out = CP.gt_pow_fixed(gt_base_table().to(k.device),
                          k.reshape(-1, NUM_LIMBS))
    return out.reshape(k.shape[:-1] + GT_SHAPE)


def gt_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GT product over broadcast leading dims (one kernel)."""
    batch = torch.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    out = CP.f12_mul_flat(a.expand(batch + GT_SHAPE).reshape((-1,) + GT_SHAPE),
                          b.expand(batch + GT_SHAPE).reshape((-1,) + GT_SHAPE))
    return out.reshape(batch + GT_SHAPE)


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
                        draws=None) -> RangeProofBatch:
    """Proofs for V values at once, on the device of `cts`.

    secrets: int64 (V,) plaintexts in [0, u^l); rs: (V, 16) their
    encryption blinding scalars; cts: (V, 2, 3, 16) their ciphertexts under
    the collective key, whose fixed-base table is ca_pub_table. The
    randomness s, t, m (V, l, 16) and v (ns, V, l, 16) is drawn from
    `generator` in that order, or given as `draws`.
    """
    dev = cts.device
    secrets = np.asarray(torch.as_tensor(secrets).cpu())
    V, ns = secrets.shape[0], len(sigs)
    digits = torch.from_numpy(to_base(secrets, u, l)).to(dev, torch.int64)
    if draws is None:
        if generator is None:
            raise ValueError("create_range_proofs needs a generator or draws")
        draws = [eg.random_scalars(shape, generator, dev)
                 for shape in ((V, l), (V, l), (V, l), (ns, V, l))]
    s, t, m, v = (d.to(dev) for d in draws)
    A_tab = torch.stack([sg.A for sg in sigs]).to(dev)
    D, m_tot, V_pts, a = _commit_kernel(
        digits, s, t, m, v, A_tab, ca_pub_table,
        sig_gt_pow_tables(sigs, dev), u, l)
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
                            draws: Optional[dict] = None) -> RangeProofList:
    """The mixed-range payload of one value vector. ranges: [(u, l)] per
    value; sigs_by_u: {u: [RangeSig per CN]}; draws: {(u, l): (s, t, m, v)}
    to inject each spec's randomness instead of drawing it."""
    secrets = torch.as_tensor(secrets)
    batches = []
    for spec, idx in group_ranges(ranges).items():
        ia = np.asarray(idx, dtype=np.int64)
        sel = torch.from_numpy(ia).to(cts.device)
        pb = create_range_proofs(
            secrets[torch.from_numpy(ia).to(secrets.device)], rs[sel],
            cts[sel], sigs_by_u[spec[0]], spec[0], spec[1], ca_pub_table,
            generator, None if draws is None else draws[spec])
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
                                     generator=None, draws=None) -> list:
    """All DPs' payloads in one device-batched creation: secrets_2d
    (n_dps, V), rs_2d (n_dps, V, 16), cts_2d (n_dps, V, 2, 3, 16), ranges
    per value (shared by every DP). Returns one RangeProofList per DP, the
    same bytes as per-DP creation (each value's transcript is its own)."""
    secrets_2d = torch.as_tensor(secrets_2d)
    n_dps, V = secrets_2d.shape
    big = create_range_proof_list(
        secrets_2d.reshape(-1), rs_2d.reshape(-1, NUM_LIMBS),
        cts_2d.reshape(-1, 2, 3, NUM_LIMBS), list(ranges) * n_dps, sigs_by_u,
        ca_pub_table, generator, draws)
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


__all__ = ["RangeSig", "init_range_sig", "to_base", "sig_gt_table",
           "sig_gt_pow_tables", "gt_base",
           "gt_base_table", "gt_pow_gtb", "gt_mul", "RangeProofBatch",
           "sum_publics_bytes", "challenge_from_wire", "create_range_proofs",
           "RangeProofList", "group_ranges", "create_range_proof_list",
           "create_range_proof_lists_batched"]
