"""Batched additively homomorphic ElGamal over bn256 G1, on torch tensors.

The port's counterpart of drynx_tpu/crypto/elgamal.py:

    ciphertext : int32 (..., 2, 3, 16)  [K, C] Jacobian points
    scalar     : int32 (..., 16)        plain (non-Montgomery) mod-n limbs

Fixed-base products (rB, mB, rP, and rB, rQ in the key switch) go through
the fixed-base kernel of `cuda_ops` with 4-bit window tables built on the
host; decryption's x*K goes through the variable-base ladder kernel. The
discrete-log table is host-built and looked up with `torch.searchsorted`
on int64 keys. Randomness comes from an explicit `torch.Generator`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_ops
from . import curve as C
from . import field as F
from . import params, refimpl
from .field import FN, FP
from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS

WINDOW_BITS = 4
NUM_WINDOWS = 256 // WINDOW_BITS  # 64
WINDOW_SIZE = 1 << WINDOW_BITS    # 16

# int64 plaintext magnitudes fit 16 hex digits: |v| <= 2^63 < 16^16
SMALL_WINDOWS = 16


# ---------------------------------------------------------------------------
# Key generation (host-side; keys are few and long-lived)
# ---------------------------------------------------------------------------

def keygen(rng: np.random.Generator):
    """Return (secret int mod n, public point as host affine ints); the same
    draws as the reference, so one seed gives one key in both packages."""
    x = int.from_bytes(rng.bytes(64), "little") % (params.N - 1) + 1
    return x, refimpl.g1_mul(refimpl.G1, x)


def secret_to_limbs(x: int) -> torch.Tensor:
    return F.from_int(x % params.N)


# ---------------------------------------------------------------------------
# Fixed-base precomputation (host build, device lookup)
# ---------------------------------------------------------------------------

class FixedBase:
    """4-bit-window fixed-base table for one long-lived base point.

    table[w, d] = d * 16^w * P as (64, 16, 3, 16) int32 Jacobian Montgomery
    limbs, on the CPU; callers move it to their device once."""

    def __init__(self, point_affine):
        rows = []
        base = point_affine
        for _w in range(NUM_WINDOWS):
            row = [None]
            acc = None
            for _d in range(WINDOW_SIZE - 1):
                acc = refimpl.g1_add(acc, base)
                row.append(acc)
            rows.append(C.from_ref_batch(row))
            for _ in range(WINDOW_BITS):
                base = refimpl.g1_add(base, base)
        self.table = torch.stack(rows)


def fixed_base_mul(table, k_limbs, n_windows: int = NUM_WINDOWS):
    """k * P via windowed lookup-and-add. k_limbs: (..., 16) plain scalars;
    `n_windows` truncates the ladder for scalars known to be < 16^W."""
    batch = k_limbs.shape[:-1]
    out = cuda_ops.fixed_base_mul_flat(
        table, k_limbs.reshape(-1, NUM_LIMBS), n_windows=n_windows)
    return out.reshape(batch + (3, NUM_LIMBS))


BASE_TABLE = FixedBase(refimpl.G1)


def pub_table(pub_affine) -> FixedBase:
    """The fixed-base table of a public key (host affine ints)."""
    return FixedBase(pub_affine)


# ---------------------------------------------------------------------------
# Scalars
# ---------------------------------------------------------------------------

def random_scalars(shape, generator: torch.Generator, device="cpu"):
    """Uniform scalars mod n as plain limbs (..., 16), int32, from 512
    random bits reduced mod n (bias 2^-256). Drawn on the generator's
    device, then moved."""
    shape = tuple(shape)
    bits = torch.randint(0, 1 << LIMB_BITS, shape + (2 * NUM_LIMBS,),
                         generator=generator, dtype=torch.int64,
                         device=generator.device)
    lo, hi = bits[..., :NUM_LIMBS], bits[..., NUM_LIMBS:]
    return F.reduce_512(hi, lo, FN).to(torch.int32).to(device)


def magnitude_limbs(values: torch.Tensor):
    """Signed int64 -> (|v| as (..., 16) int32 limbs, v < 0), exact for every
    int64 including INT64_MIN. For v < 0, |v| = ~v + 1, where ~v = -v - 1
    never overflows; the + 1 carries through the limbs."""
    values = values.to(torch.int64)
    neg = values < 0
    base = torch.where(neg, ~values, values)
    limbs = torch.zeros(values.shape + (NUM_LIMBS,), dtype=torch.int64,
                        device=values.device)
    for k in range(4):
        limbs[..., k] = (base >> (LIMB_BITS * k)) & LIMB_MASK
    limbs[..., 0] += neg.to(torch.int64)
    limbs, _ = F._carry(limbs)
    return limbs.to(torch.int32), neg


def int_to_scalar(values: torch.Tensor) -> torch.Tensor:
    """Signed int64 (...,) -> mod-n scalar limbs (..., 16), int32: v for
    v >= 0, n - |v| for v < 0 (as kyber's SetInt64)."""
    limbs, neg = magnitude_limbs(values)
    return torch.where(neg[..., None], F.neg(limbs, FN), limbs)


# ---------------------------------------------------------------------------
# Core ElGamal ops
# ---------------------------------------------------------------------------

def encrypt_ints_with_tables(base_table, pub_tbl, values, r_scalars):
    """Encrypt signed int64 plaintexts with blinding r: (K, C) = (rB, mB + rP).
    mB is |v|*B over a 16-window truncated ladder, negated pointwise for
    v < 0: exactly m*B, since (n - |v|)*B = -(|v|*B)."""
    limbs, neg = magnitude_limbs(values)
    K = fixed_base_mul(base_table, r_scalars)
    mB = fixed_base_mul(base_table, limbs, n_windows=SMALL_WINDOWS)
    mB = torch.where(neg[..., None, None], C.neg(mB), mB)
    rP = fixed_base_mul(pub_tbl, r_scalars)
    Cc = C.add(mB, rP)
    return torch.stack([K, Cc], dim=-3)


def decrypt_point(ct, x_limbs):
    """M = C - x*K. x_limbs: secret scalar limbs (broadcastable)."""
    K = ct[..., 0, :, :]
    Cc = ct[..., 1, :, :]
    xK = C.scalar_mul(K, x_limbs)
    return C.add(Cc, C.neg(xK))


# ---------------------------------------------------------------------------
# Discrete-log table (host build, device binary-search lookup)
# ---------------------------------------------------------------------------

class DecryptionTable:
    """m*B for m in [-limit, limit] keyed by truncated affine coords.

    Sorted keys (x low 31 bits << 1 | y parity), held as int64 so the query
    keys and `torch.searchsorted` share one dtype; the lookup verifies the
    full x limbs over a small window after the search, so key collisions
    cannot give wrong answers."""

    WINDOW = 4

    def __init__(self, limit: int = 10000, base=None):
        base = base or refimpl.G1
        pts, vals = [], []
        acc = None
        for m in range(1, limit + 1):
            acc = refimpl.g1_add(acc, base)
            pts.append(acc)
            vals.append(m)
            pts.append(refimpl.g1_neg(acc))
            vals.append(-m)
        xs = np.zeros((len(pts), NUM_LIMBS), dtype=np.int32)
        keys = np.zeros(len(pts), dtype=np.int64)
        for i, (x, y) in enumerate(pts):
            xs[i] = params.to_limbs(x)
            keys[i] = ((x & 0x7FFFFFFF) << 1) | (y & 1)
        order = np.argsort(keys, kind="stable")
        ysign = np.asarray([pts[i][1] & 1 for i in order], dtype=np.int64)
        self._set(limit, keys[order], xs[order], ysign,
                  np.asarray(vals, dtype=np.int32)[order])

    def _set(self, limit, keys, xs, ysign, vals):
        self.limit = limit
        self.keys = torch.as_tensor(np.asarray(keys).astype(np.int64))
        self.xs = torch.as_tensor(np.asarray(xs).astype(np.int32))
        self.ysign = torch.as_tensor(np.asarray(ysign).astype(np.int64))
        self.vals = torch.as_tensor(np.asarray(vals).astype(np.int32))

    @classmethod
    def from_arrays(cls, keys, xs, ysign, vals) -> "DecryptionTable":
        """Wrap sorted table arrays (e.g. the reference's, as numpy)."""
        t = cls.__new__(cls)
        t._set(len(keys) // 2, keys, xs, ysign, vals)
        return t

    def to(self, device) -> "DecryptionTable":
        t = DecryptionTable.__new__(DecryptionTable)
        t.limit = self.limit
        t.keys, t.xs = self.keys.to(device), self.xs.to(device)
        t.ysign, t.vals = self.ysign.to(device), self.vals.to(device)
        return t

    def lookup(self, points):
        """Batched point -> int. Returns (values int32, found bool)."""
        return _table_lookup(self.keys, self.xs, self.ysign, self.vals, points)


def _table_lookup(keys, xs, ysign, vals, points):
    ax_m, ay_m, inf = C.normalize(points)
    ax = F.from_mont(ax_m, FP).to(torch.int64)
    ay = F.from_mont(ay_m, FP).to(torch.int64)
    x31 = (ax[..., 0] | (ax[..., 1] << LIMB_BITS)) & 0x7FFFFFFF
    parity = ay[..., 0] & 1
    qkey = (x31 << 1) | parity

    pos = torch.searchsorted(keys, qkey.reshape(-1)).reshape(qkey.shape)
    T = keys.shape[0]
    val = torch.zeros(qkey.shape, dtype=torch.int32, device=qkey.device)
    found = torch.zeros(qkey.shape, dtype=torch.bool, device=qkey.device)
    for w in range(DecryptionTable.WINDOW):
        idx = torch.clamp(pos + w, 0, T - 1)
        match = ((xs[idx].to(torch.int64) == ax).all(-1)
                 & (ysign[idx] == parity))
        val = torch.where(match & ~found, vals[idx], val)
        found = found | match
    val = torch.where(inf, torch.zeros_like(val), val)
    return val, found | inf


def decrypt_ints(ct, secret: int, table: DecryptionTable):
    """Full decryption: (..., 2, 3, 16) cts -> (int32 values, found flags)."""
    x = secret_to_limbs(secret).to(ct.device)
    return table.to(ct.device).lookup(decrypt_point(ct, x))


__all__ = [
    "keygen", "secret_to_limbs", "FixedBase", "fixed_base_mul", "BASE_TABLE",
    "pub_table", "random_scalars", "magnitude_limbs", "int_to_scalar",
    "encrypt_ints_with_tables", "decrypt_point",
    "DecryptionTable", "decrypt_ints",
]
