"""Batched modular (Montgomery) arithmetic on torch limb tensors.

The port's counterpart of drynx_tpu/crypto/field.py. A 256-bit field element
is a tensor of 16 little-endian 16-bit limbs, shape (..., 16), Montgomery form
with R = 2^256 for Fp. Public functions take and return the layout of their
first argument's dtype: `torch.int32` at module boundaries (every limb is
below 2^16, so the bits equal the reference's uint32 bits), `torch.int64`
inside the plain kernel versions, which compute in int64 throughout because
CPU uint32 tensors have no `+`, `-` or `>>`.

Every result is the canonical residue in [0, m), so it is byte-identical to
the reference's whatever route computed it. That frees the arithmetic here
from the reference's word-serial Montgomery loop: products are whole-width
column sums, carries ripple through all limbs at once until none is left,
and reduction is one full-width REDC. On the card these functions serve
only the glue around the kernels (normalisation, negation); the hot paths
are the CUDA kernels of `cuda_ops` and `cuda_pairing`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import params
from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS


@dataclasses.dataclass(frozen=True)
class ModCtx:
    """Constants for one modulus."""

    modulus: int
    r2: int              # R^2 mod m
    name: str

    def m_limbs(self, device) -> torch.Tensor:
        return _const(self.modulus, device)

    def r2_limbs(self, device) -> torch.Tensor:
        return _const(self.r2, device)

    def one_mont(self, device) -> torch.Tensor:
        """Montgomery representation of 1 (= R mod m), int64 limbs."""
        return _const(params.R % self.modulus, device)

    def nprime_full(self, device) -> torch.Tensor:
        """-m^-1 mod 2^256 as limbs (the full-width REDC factor)."""
        return _const(_nprime(self.modulus), device)


@functools.lru_cache(maxsize=None)
def _nprime(modulus: int) -> int:
    return (-pow(modulus, -1, params.R)) % params.R


FP = ModCtx(params.P, params.R2_MOD_P, "Fp")
FN = ModCtx(params.N, params.R2_MOD_N, "Fn")


@functools.lru_cache(maxsize=None)
def _const_cached(value: int, device: str) -> torch.Tensor:
    return torch.tensor(params.to_limbs(value), dtype=torch.int64,
                        device=device)


def _const(value: int, device) -> torch.Tensor:
    return _const_cached(value, str(torch.device(device)))


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------

def from_int(x) -> torch.Tensor:
    """Python int (or nested list of ints) -> int32 limb tensor (CPU)."""
    arr = np.asarray(x, dtype=object)
    out = np.zeros(arr.shape + (NUM_LIMBS,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        v = int(arr[idx])
        for k in range(NUM_LIMBS):
            out[idx + (k,)] = (v >> (LIMB_BITS * k)) & LIMB_MASK
    return torch.from_numpy(out)


def to_int(limbs) -> "int | np.ndarray":
    """Limb tensor/array -> Python int (object ndarray for batches)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    a = np.asarray(limbs).astype(np.int64)
    if a.ndim == 1:
        return params.from_limbs(a)
    flat = a.reshape(-1, NUM_LIMBS)
    out = np.array([params.from_limbs(row) for row in flat], dtype=object)
    return out.reshape(a.shape[:-1])


# ---------------------------------------------------------------------------
# int64 limb machinery
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_weights(n_limbs: int, device: str):
    shifts = torch.arange(n_limbs, dtype=torch.int64, device=device)
    return shifts, torch.ones_like(shifts) << shifts


@functools.lru_cache(maxsize=None)
def _col_index(device: str):
    i = torch.arange(NUM_LIMBS, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _carry(v: torch.Tensor, rounds: int = 0, carry_in: int = 0):
    """Normalise nonnegative int64 limb columns exactly, without a host sync.

    Returns (limbs in [0, 2^16), carry out of the top limb). `rounds` passes
    move every column's excess one limb up at once; each pass takes the
    bound on the columns from 2^b to 2^16 + 2^(b-16), so callers pass 0 for
    columns up to 2^17 - 2, 2 for 2^37 and 3 for 2^57. The last ripple of
    0/1 carries is then resolved in one step as a binary addition over the
    limbs packed into bits (up to 32 limbs): generate where a limb is
    >= 2^16, propagate where it is 0xFFFF; `carry_in` enters below limb 0."""
    n = v.shape[-1]
    shifts, weights = _bit_weights(n, str(v.device))
    top = torch.zeros(v.shape[:-1], dtype=torch.int64, device=v.device)
    for _ in range(rounds):
        c = v >> LIMB_BITS
        v = v & LIMB_MASK
        v[..., 1:] += c[..., :-1]
        top = top + c[..., -1]
    gen = (v >> LIMB_BITS) * weights
    prop = (v == LIMB_MASK) * weights
    y = gen.sum(-1)
    x = y + prop.sum(-1)
    carries = (x + y + carry_in) ^ x ^ y
    v = (v + ((carries.unsqueeze(-1) >> shifts) & 1)) & LIMB_MASK
    return v, top + (carries >> n)


def _product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two 16-limb values as 32 unnormalised columns
    (each below 16 * max(a) * max(b))."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)
    cols = torch.zeros(a.shape[:-1] + (2 * NUM_LIMBS,), dtype=torch.int64,
                       device=a.device)
    cols.index_add_(-1, _col_index(str(a.device)),
                    prod.reshape(a.shape[:-1] + (NUM_LIMBS * NUM_LIMBS,)))
    return cols


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(cond.unsqueeze(-1), a, b)


def _complement(x: torch.Tensor) -> torch.Tensor:
    """Limbwise 0xFFFF - x: x + _complement(y) + 1 = x - y + 2^256."""
    return LIMB_MASK - x


def _cond_sub(s: torch.Tensor, top: torch.Tensor, m: torch.Tensor):
    """s + top*2^256 - m if that is >= 0, else s (value below 2m)."""
    d, no_borrow = _carry(s + _complement(m), carry_in=1)
    return _select(top + no_borrow > 0, d, s)


def _add64(a, b, ctx: ModCtx):
    s, top = _carry(a + b)
    return _cond_sub(s, top, ctx.m_limbs(a.device))


def _sub64(a, b, ctx: ModCtx):
    d, no_borrow = _carry(a + _complement(b), carry_in=1)
    plus_m, _ = _carry(d + ctx.m_limbs(a.device))
    return _select(no_borrow == 0, plus_m, d)


def _mont_mul64(a, b, ctx: ModCtx):
    """a*b*R^-1 mod m by one full-width REDC: t = a*b, u = t*(-m^-1) mod R,
    (t + u*m)/R < 2m, one conditional subtract. t's low half stays in
    unnormalised columns: it is exact mod R, and its product with the
    16-bit limbs of -m^-1 stays below 2^57."""
    dev = a.device
    t = _product_cols(a, b)
    u_cols = _product_cols(t[..., :NUM_LIMBS], ctx.nprime_full(dev))
    u, _ = _carry(u_cols[..., :NUM_LIMBS], rounds=3)
    s, top = _carry(t + _product_cols(u, ctx.m_limbs(dev)), rounds=2)
    return _cond_sub(s[..., NUM_LIMBS:], top, ctx.m_limbs(dev))


def _pow_const64(a, e: int, ctx: ModCtx):
    """a^e for a public exponent, left-to-right square-and-multiply."""
    acc = a
    for bit in bin(e)[3:]:
        acc = _mont_mul64(acc, acc, ctx)
        if bit == "1":
            acc = _mont_mul64(acc, a, ctx)
    return acc


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == ref.dtype else x.to(ref.dtype)


# ---------------------------------------------------------------------------
# Public field ops (dtype of the first argument in, same dtype out)
# ---------------------------------------------------------------------------

def add(a, b, ctx: ModCtx = FP):
    """(a + b) mod m; inputs normalized (< m)."""
    return _like(_add64(_wide(a), _wide(b), ctx), a)


def sub(a, b, ctx: ModCtx = FP):
    """(a - b) mod m; inputs normalized."""
    return _like(_sub64(_wide(a), _wide(b), ctx), a)


def neg(a, ctx: ModCtx = FP):
    return _like(_sub64(torch.zeros_like(_wide(a)), _wide(a), ctx), a)


def is_zero(a):
    """Boolean (...,): all limbs zero (the representation is canonical)."""
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def mont_mul(a, b, ctx: ModCtx = FP):
    """Montgomery product a*b*R^-1 mod m; inputs/outputs in Montgomery form."""
    return _like(_mont_mul64(_wide(a), _wide(b), ctx), a)


def to_mont(a, ctx: ModCtx = FP):
    return _like(_mont_mul64(_wide(a), ctx.r2_limbs(a.device), ctx), a)


def from_mont(a, ctx: ModCtx = FP):
    one = _const(1, a.device)
    return _like(_mont_mul64(_wide(a), one, ctx), a)


def batch_inv(a, ctx: ModCtx = FP):
    """Montgomery batch inversion: one Fermat inversion plus O(n) products
    for the whole batch (all leading dims). Inputs nonzero, Montgomery form
    (a zero poisons the whole batch, as in the reference).

    Inclusive prefix and suffix products by log-depth doubling scans, then
    a_i^-1 = P_{i-1} * S_{i+1} * P_{n-1}^-1."""
    shape = a.shape
    flat = _wide(a).reshape(-1, NUM_LIMBS)
    n = flat.shape[0]
    if n == 0:
        return a
    mm = functools.partial(_mont_mul64, ctx=ctx)

    def scan(x):
        x = x.clone()
        step = 1
        while step < n:
            x[step:] = mm(x[step:], x[:-step].clone())
            step *= 2
        return x

    pref = scan(flat)
    suff = scan(flat.flip(0)).flip(0)
    total_inv = _pow_const64(pref[-1:], ctx.modulus - 2, ctx)
    one = ctx.one_mont(flat.device).unsqueeze(0)
    left = torch.cat([one, pref[:-1]], 0)
    right = torch.cat([suff[1:], one], 0)
    out = mm(mm(left, right), total_inv)
    return _like(out.reshape(shape), a)


def reduce_512(hi, lo, ctx: ModCtx = FP):
    """(hi*2^256 + lo) mod m, both 16-limb plain (non-Montgomery) values.

    hi*2^256 mod m = mont_mul(hi, R^2); lo < 2^256 < 2m is reduced by one
    conditional subtract."""
    hi64, lo64 = _wide(hi), _wide(lo)
    hi_part = _mont_mul64(hi64, ctx.r2_limbs(hi64.device), ctx)
    zero = torch.zeros(lo64.shape[:-1], dtype=torch.int64, device=lo64.device)
    lo_norm = _cond_sub(lo64, zero, ctx.m_limbs(lo64.device))
    return _like(_add64(hi_part, lo_norm, ctx), hi)


__all__ = [
    "ModCtx", "FP", "FN",
    "from_int", "to_int",
    "add", "sub", "neg", "is_zero", "eq",
    "mont_mul", "to_mont", "from_mont", "batch_inv", "reduce_512",
]
