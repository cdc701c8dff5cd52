"""Verifiable shuffle proof for the DRO (re-randomizing shuffle) phase.

The port's counterpart of drynx_tpu/proofs/shuffle.py, with the same
statement, transcript and wire bytes (`ShuffleProof.to_bytes`): under the
same inputs, permutation, re-encryption scalars and prover rng seed the
two packages give the same bytes, and each verifier accepts the other's
proofs.

Statement: output ElGamal pairs (Ā_j, B̄_j) are a permutation π +
re-encryption of inputs (A_i, B_i) under generators (G, H):
    Ā_j = A_{π(j)} + β_{π(j)}·G,   B̄_j = B_{π(j)} + β_{π(j)}·H.

Proof (Fiat–Shamir, all challenges hashed from the transcript):
 1. Random public exponents e_1..e_k are derived from (inputs, outputs).
 2. The prover publishes Γ = γ·G and Y_j = γ·e_{π(j)}·G and proves, by an
    ILMPP chain, that {log Y_j} = {γ·e_i} as multisets.
 3. A generalized Schnorr proof ties the exponents to the ciphertexts:
        Σ_j y_j·Ā_j − γ·Σ_i e_i·A_i − s·G = 0
        Σ_j y_j·B̄_j − γ·Σ_i e_i·B_i − s·H = 0.

The scalar chains (mod-n products, the ILMPP's prefix inverses, the sum
for s) and the sha3 hashes stay host Python ints, as in the reference. Every
point operation is batched into launches of the port's G1 kernels. A
proof, and its check, is one fixed-base launch (B1), one ladder launch
(B2) over every variable-base product (the ILMPP's, and the Schnorr
relation as one multi-scalar sum whose coefficients fold in γ and s: the
reference's `_msm`s and the products on their sums), one add launch (B5),
the relation's sum in two launches of the reduce (B3, `_sum_rows`), and
one normalization (B4) per hashed transcript. Transcripts hash only
canonical (affine) bytes, so the Jacobian representatives the kernels
pick never reach a challenge.

ILMPP (iterated log-multiplication proof), proving Π log X_i = Π log Y_i for
known logs: commitments A_1 = θ_1·Y_1, A_i = θ_{i-1}·X_i + θ_i·Y_i,
A_m = θ_{m-1}·X_m; responses r_i = θ_i + (−1)^i·c·Π_{j≤i}(x_j/y_j); checks
A_1 = r_1·Y_1 + c·X_1, A_i = r_{i-1}·X_i + r_i·Y_i,
A_m = r_{m-1}·X_m + (−1)^m·c·Y_m. It is made and checked inside
prove_shuffle and verify_shuffle, in their ladder launch; the reference's
standalone ilmpp_prove and ilmpp_verify have no other caller.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from ..crypto import cuda_ops
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import params, refimpl
from ..crypto.params import NUM_LIMBS
from . import encoding as enc
from .safe_pickle import TensorState

N = params.N


# ---------------------------------------------------------------------------
# Batched point helpers
# ---------------------------------------------------------------------------

def _limbs(ints, device) -> torch.Tensor:
    """Python ints -> (k, 16) int32 plain limbs of each value mod n."""
    # an in-memory conversion to limbs: the bytes never leave the process
    b = b"".join((int(s) % N).to_bytes(2 * NUM_LIMBS, "little")  # drynx: noqa[secret-flow-to-sink]
                 for s in ints)
    a = np.frombuffer(b, dtype="<u2").reshape(-1, NUM_LIMBS)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def limbs_to_ints(limbs) -> list[int]:
    """(k, 16) plain limbs -> Python ints (the re-encryption scalars the
    prover takes)."""
    a = np.ascontiguousarray(limbs.cpu().numpy().astype("<u2"))
    # an in-memory conversion to ints: the bytes never leave the process
    return [int.from_bytes(row.tobytes(), "little")  # drynx: noqa[secret-flow-to-sink]
            for row in a]


def _sum_rows(pts) -> torch.Tensor:
    """Group sum over axis 0 of (k, ..., 3, 16): k padded with infinity to
    R x ceil(k / R) with R = ceil(sqrt(k)), then two launches of the
    reduce, R rows over ceil(k / R) columns and ceil(k / R) rows over one
    (one launch when that is one row). Each column is a chain of adds, so
    two chains of ~sqrt(k) adds replace one of k."""
    k = int(pts.shape[0])
    rest = pts.shape[1:]
    flat = pts.reshape(k, -1, 3, NUM_LIMBS)
    m = flat.shape[1]
    if k == 1:
        return pts[0]
    R = math.isqrt(k - 1) + 1
    cols = -(-k // R)
    if cols > 1:
        pad = R * cols - k
        if pad:
            flat = torch.cat([flat, C.infinity((pad, m), flat.device)
                              .to(flat.dtype)])
        flat = cuda_ops.point_reduce_flat(
            flat.reshape(R, cols * m, 3, NUM_LIMBS))
        flat = flat.reshape(cols, m, 3, NUM_LIMBS)
    return cuda_ops.point_reduce_flat(flat).reshape(rest)


def _base_muls(scalars_int, device) -> torch.Tensor:
    """k_i·G for Python ints, one fixed-base launch: (k, 3, 16)."""
    return eg.fixed_base_mul(eg.BASE_TABLE.table.to(device),
                             _limbs(scalars_int, device))


def _generator_points(k: int, device) -> torch.Tensor:
    return C.from_ref(refimpl.G1).to(device).expand(k, 3, NUM_LIMBS)


def _hash_points_to_scalars(count: int, *point_arrays) -> list[int]:
    """Derive `count` mod-n scalars from the canonical bytes of point
    tensors (all normalized in one launch): sha3-256 of the bytes seeds
    `count` sha3-512 digests."""
    pts = torch.cat([p.reshape(-1, 3, NUM_LIMBS) for p in point_arrays])
    return _digest_scalars(count,
                           np.ascontiguousarray(enc.g1_bytes(pts)).tobytes())


def _digest_scalars(count: int, data: bytes) -> list[int]:
    """The host half of `_hash_points_to_scalars`."""
    seed = hashlib.sha3_256(data).digest()
    out = []
    for i in range(count):
        h = hashlib.sha3_512()
        h.update(seed)
        h.update(i.to_bytes(8, "big"))
        out.append(int.from_bytes(h.digest(), "big") % N)
    return out


# ---------------------------------------------------------------------------
# ILMPP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ILMPPProof(TensorState):
    commits: torch.Tensor   # (m, 3, 16)
    responses: list         # m-1 scalars (Python ints)
    challenge: int


def _rand_scalar(rng: np.random.Generator) -> int:
    """Uniform nonzero scalar mod n (512 random bits reduced — bias 2^-256),
    the reference's draw."""
    return int.from_bytes(rng.bytes(64), "little") % (N - 1) + 1


def _ilmpp_terms(X, Y, scal_x, scal_y):
    """The points and scalars of scal_x[i]·X_i + scal_y[i]·Y_i, (2m, 3, 16)
    and 2m Python ints, for a ladder launch that the caller may share."""
    return torch.cat([X, Y]), list(scal_x) + list(scal_y)


def _ilmpp_combine(prods, m: int) -> torch.Tensor:
    """The ladder's 2m products -> the m sums, one add launch."""
    return C.add(prods[:m], prods[m:2 * m])


def _ilmpp_responses(xs, ys, thetas, c) -> list[int]:
    """r_i = θ_i + (−1)^i·c·Π_{j≤i}(x_j/y_j), on the host.

    Π_{j≤i} y_j is inverted for every i from one inverse of the last
    nonzero prefix product, walking back (1/Π_{j≤i} = y_{i+1}/Π_{j≤i+1}):
    the reference's values, where it takes a Fermat inverse of each y_j
    (2k of ~0.2 ms each at k = 10,000). A y_j = 0 makes every later
    product 0, as Fermat's 0^(n-2) = 0 does."""
    m1 = len(xs) - 1
    num, den = [], []
    a = b = 1
    for i in range(m1):
        a = a * xs[i] % N
        b = b * ys[i] % N
        num.append(a)
        den.append(b)
    live = next((i for i, d in enumerate(den) if d == 0), m1)
    inv = [0] * m1
    if live:
        inv[live - 1] = pow(den[live - 1], -1, N)
        for i in range(live - 2, -1, -1):
            inv[i] = inv[i + 1] * ys[i + 1] % N
    responses = []
    sign = 1
    for i in range(m1):
        sign = -sign
        responses.append((thetas[i] + sign * c * (num[i] * inv[i] % N)) % N)
    return responses


def _ilmpp_check_scalars(proof: ILMPPProof, m: int, c: int):
    """The verifier's scalars for X and Y: A_1 = r_1·Y_1 + c·X_1,
    A_i = r_{i-1}·X_i + r_i·Y_i, A_m = r_{m-1}·X_m + (−1)^m·c·Y_m."""
    r = list(proof.responses)
    sign_m = 1 if m % 2 == 0 else -1
    return [c] + r, r + [sign_m * c]


def _ilmpp_shape_ok(proof: ILMPPProof, m: int) -> bool:
    return (len(proof.responses) == m - 1
            and tuple(proof.commits.shape) == (m, 3, NUM_LIMBS))


# ---------------------------------------------------------------------------
# Full shuffle proof
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShuffleProof(TensorState):
    gamma_pt: torch.Tensor   # Γ = γ·G (3, 16)
    y_pts: torch.Tensor      # (k, 3, 16) blinded permuted exponents
    ilmpp: ILMPPProof        # product-equality argument over 2k elements
    t_pts: torch.Tensor      # (k, 3, 16) Schnorr commitments for y_j
    t_gamma: torch.Tensor    # (3, 16)
    t_a: torch.Tensor        # (3, 16)
    t_b: torch.Tensor        # (3, 16)
    z: list                  # k responses for y_j (Python ints)
    z_gamma: int
    z_s: int
    challenge: int

    def to(self, device) -> "ShuffleProof":
        moved = super().to(device)
        return dataclasses.replace(moved, ilmpp=self.ilmpp.to(device))

    def to_bytes(self) -> bytes:
        k = int(self.y_pts.shape[0])
        head = np.asarray([k], dtype="<i8").tobytes()
        pts = enc.g1_bytes(torch.cat([
            self.gamma_pt[None], self.y_pts,
            self.ilmpp.commits.to(self.y_pts.device), self.t_pts,
            self.t_gamma[None], self.t_a[None], self.t_b[None]]))
        scal = (list(self.ilmpp.responses) + [self.ilmpp.challenge]
                + list(self.z) + [self.z_gamma, self.z_s, self.challenge])
        sb = b"".join(int(s).to_bytes(32, "big") for s in scal)
        return head + np.ascontiguousarray(pts).tobytes() + sb


def _derive_exponents(in_cts, out_cts) -> list[int]:
    k = int(in_cts.shape[0])
    return _hash_points_to_scalars(k, in_cts, out_cts)


def _seq(first, second_pt, k: int):
    """(first ‖ second_pt × k), (2k, 3, 16)."""
    return torch.cat([first, second_pt.expand(k, 3, NUM_LIMBS)])


def _relation_terms(in_cts, out_cts, h_pt, e, w, g, s_scal):
    """The points and scalars whose sum is the Schnorr relation's two
    points (Σ w_j·Ā_j − g·Σ e_i·A_i − s·G, Σ w_j·B̄_j − g·Σ e_i·B_i − s·H):
    rows in ‖ out ‖ (G, H), (2k + 1, 2, 3, 16), each row's scalar for both
    its points (−g·e_i, w_j, −s), as 2(2k + 1) Python ints."""
    dev = in_cts.device
    gh = torch.stack([C.from_ref(refimpl.G1).to(dev), h_pt.to(dev)])
    pts = torch.cat([in_cts, out_cts, gh[None]])
    rows = [-g * ei for ei in e] + list(w) + [-s_scal]
    return pts, [v for v in rows for _ in range(2)]


def _shared_ladder(dev, *terms):
    """One ladder launch over the (points, scalars) of every term; returns
    each term's products."""
    pts = torch.cat([p.reshape(-1, 3, NUM_LIMBS) for p, _ in terms])
    prods = C.scalar_mul(pts, _limbs([v for _, ks in terms for v in ks],
                                     dev))
    out, at = [], 0
    for p, _ in terms:
        n = p.numel() // (3 * NUM_LIMBS)
        out.append(prods[at:at + n].reshape(p.shape))
        at += n
    return out


def prove_shuffle(in_cts, out_cts, perm, betas_int, h_pt,
                  rng: np.random.Generator) -> ShuffleProof:
    """in_cts/out_cts: (k, 2, 3, 16) ElGamal pairs with
    out[j] = in[perm[j]] + Enc_{betas[j]}(0); betas_int: k python-int
    re-encryption scalars indexed by OUTPUT position (matching
    parallel.dro.shuffle_rerandomize); h_pt: (3, 16) the public key H.
    The nonces come from `rng` in the reference's order (γ, the ILMPP's
    2k - 1, then k + 2 Schnorr nonces), so one seed gives the reference's
    bytes. Runs on the device of `in_cts`: one fixed-base launch, one
    ladder launch (the ILMPP commitments and the Schnorr relation's 4k + 2
    products), one add, two reduces and three normalizations."""
    dev = in_cts.device
    out_cts = out_cts.to(dev)
    k = int(in_cts.shape[0])
    perm = np.asarray(perm.cpu() if isinstance(perm, torch.Tensor) else perm)
    e = _derive_exponents(in_cts, out_cts)
    gamma = _rand_scalar(rng)
    thetas = [_rand_scalar(rng) for _ in range(2 * k - 1)]
    th = [_rand_scalar(rng) for _ in range(k + 2)]
    th_y, th_g, th_s = th[:k], th[k], th[k + 1]

    y = [gamma * e[int(perm[j])] % N for j in range(k)]   # logs of Y_j
    bm = _base_muls(y + [gamma] + e + th_y + [th_g], dev)
    y_pts, gamma_pt, e_pts = bm[:k], bm[k], bm[k + 1:2 * k + 1]
    t_pts, t_gamma = bm[2 * k + 1:3 * k + 1], bm[3 * k + 1]

    # SimpleShuffle via ILMPP over 2k: (e_i·G ‖ Γ×k) vs (Y_j ‖ G×k); the
    # generalized Schnorr commitments t_a, t_b for ciphertext consistency
    X = _seq(e_pts, gamma_pt, k)
    Y = _seq(y_pts, _generator_points(1, dev), k)
    il, rel = _shared_ladder(
        dev, _ilmpp_terms(X, Y, [0] + thetas, thetas + [0]),
        _relation_terms(in_cts, out_cts, h_pt, e, th_y, th_g, th_s))
    commits = _ilmpp_combine(il, 2 * k)
    c_il = _hash_points_to_scalars(1, X, Y, commits)[0]
    ilmpp = ILMPPProof(commits=commits, challenge=c_il,
                       responses=_ilmpp_responses(e + [gamma] * k,
                                                  y + [1] * k, thetas, c_il))
    t_a, t_b = _sum_rows(rel)
    s = _relation_secret(gamma, e, perm, betas_int)

    c = _hash_points_to_scalars(
        1, y_pts, gamma_pt, t_pts, t_gamma, t_a, t_b)[0]
    z = [(th_y[j] + c * y[j]) % N for j in range(k)]
    z_gamma = (th_g + c * gamma) % N
    z_s = (th_s + c * s) % N
    return ShuffleProof(gamma_pt=gamma_pt, y_pts=y_pts, ilmpp=ilmpp,
                        t_pts=t_pts, t_gamma=t_gamma, t_a=t_a, t_b=t_b,
                        z=z, z_gamma=z_gamma, z_s=z_s, challenge=c)


def _relation_secret(gamma: int, e, perm, betas_int) -> int:
    """s = γ·Σ_j e_{π(j)}·β_j mod n, on the host."""
    return gamma * sum(e[int(perm[j])] * betas_int[j] % N
                       for j in range(len(betas_int))) % N


def _well_formed(proof: ShuffleProof, k: int) -> bool:
    pt = (3, NUM_LIMBS)
    return (tuple(proof.y_pts.shape) == (k,) + pt
            and tuple(proof.t_pts.shape) == (k,) + pt
            and all(tuple(t.shape) == pt for t in (
                proof.gamma_pt, proof.t_gamma, proof.t_a, proof.t_b))
            and len(proof.z) == k and _ilmpp_shape_ok(proof.ilmpp, 2 * k))


def verify_shuffle(proof: ShuffleProof, in_cts, out_cts, h_pt) -> bool:
    """Checks the proof against (in_cts, out_cts) on the device of
    `in_cts`: both challenges recomputed, then one fixed-base launch, one
    ladder launch (the ILMPP's 4k products, c·Y_j and c·Γ, the relation's
    4k + 2), one add, two reduces."""
    dev = in_cts.device
    out_cts = out_cts.to(dev)
    k = int(in_cts.shape[0])
    if not _well_formed(proof, k):
        return False
    proof = proof.to(dev)
    e = _derive_exponents(in_cts, out_cts)
    bm = _base_muls(e + list(proof.z) + [proof.z_gamma], dev)
    e_pts, zG = bm[:k], bm[k:]

    X = _seq(e_pts, proof.gamma_pt, k)
    Y = _seq(proof.y_pts, _generator_points(1, dev), k)
    c_il = _hash_points_to_scalars(1, X, Y, proof.ilmpp.commits)[0]
    if c_il != proof.ilmpp.challenge:
        return False
    c = _hash_points_to_scalars(
        1, proof.y_pts, proof.gamma_pt, proof.t_pts, proof.t_gamma,
        proof.t_a, proof.t_b)[0]
    if c != proof.challenge:
        return False

    yg = torch.cat([proof.y_pts, proof.gamma_pt[None]])
    il, cy, rel = _shared_ladder(
        dev, _ilmpp_terms(X, Y, *_ilmpp_check_scalars(proof.ilmpp, 2 * k,
                                                      c_il)),
        (yg, [c] * (k + 1)),
        _relation_terms(in_cts, out_cts, h_pt, e, proof.z, proof.z_gamma,
                        proof.z_s))
    # 1. SimpleShuffle part, and z_j·G == t_j + c·Y_j, z_γ·G == t_γ + c·Γ,
    # in one add launch
    sums = C.add(torch.cat([il[:2 * k], cy]),
                 torch.cat([il[2 * k:],
                            torch.cat([proof.t_pts, proof.t_gamma[None]])]))
    ok = (C.eq(sums[:2 * k], proof.ilmpp.commits).all()
          & C.eq(sums[2 * k:], zG).all())
    # 2. generalized Schnorr part: the relation points are the identity,
    # so the sum equals (t_a, t_b)
    lhs = _sum_rows(rel)
    return bool(ok & C.eq(lhs, torch.stack([proof.t_a, proof.t_b])).all())


__all__ = ["ILMPPProof", "ShuffleProof", "prove_shuffle", "verify_shuffle",
           "limbs_to_ints"]
