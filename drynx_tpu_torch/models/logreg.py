"""Encrypted logistic regression: DP-side encoding and querier-side GD.

The port's counterpart of drynx_tpu/models/logreg.py. The log-loss is
approximated by a degree-k polynomial in the margin w.x, so a DP's whole
contribution reduces to the sign-weighted outer-power tensors

    T_j = sum_i s_j(y_i) x_i^{(x)j},  j = 1..k,
    s_j(y) = 2y - 1 for odd j, -1 for even j,

computed as one einsum each. The querier trains by gradient descent on the
polynomial cost, with the gradient from `torch.autograd`. The loop is plain
torch: on the card each of its iterations is a few dozen small launches.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MIN_AREA_COEFFS = (-0.714761, -0.5, -0.0976419)


@dataclasses.dataclass
class LRParams:
    """The survey's logistic-regression parameters (the reference's
    LRParams, field for field)."""

    k: int = 2
    precision: float = 1e2
    lambda_: float = 1.0
    step: float = 0.1
    max_iterations: int = 25
    initial_weights: tuple = ()
    n_features: int = 0
    n_records: int = 0
    means: tuple | None = None
    std_devs: tuple | None = None
    coeffs: tuple = MIN_AREA_COEFFS
    dtype: str = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def num_coeffs(self) -> int:
        """Length of the encoded vector: (d+1) + (d+1)^2 + ... + (d+1)^k."""
        dp1 = self.n_features + 1
        return sum(dp1 ** j for j in range(1, self.k + 1))


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

def standardise(X, means=None, std_devs=None):
    """x' = (x - mean)/std with the population std (ddof=0); float64."""
    X = torch.as_tensor(X, dtype=torch.float64)
    mu = X.mean(0) if means is None else torch.as_tensor(
        means, dtype=torch.float64, device=X.device)
    sd = X.std(0, unbiased=False) if std_devs is None else torch.as_tensor(
        std_devs, dtype=torch.float64, device=X.device)
    return (X - mu) / sd


def augment(X):
    """Prepend the all-ones offset column."""
    X = torch.as_tensor(X)
    return torch.cat([torch.ones((X.shape[0], 1), dtype=X.dtype,
                                 device=X.device), X], dim=1)


# ---------------------------------------------------------------------------
# DP-side encoding: approximation tensors -> fixed-point int vector
# ---------------------------------------------------------------------------

def _einsum_spec(j: int) -> str:
    idx = "abcdefgh"[:j]
    return "n," + ",".join(f"n{c}" for c in idx) + "->" + idx


def approx_tensors(Xa, y, k: int):
    """T_j for j=1..k as flat float64 tensors. Xa: augmented standardised
    records (n, d+1); y: labels {0,1} (n,)."""
    Xa = torch.as_tensor(Xa, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=Xa.device)
    sign_odd = 2.0 * y - 1.0
    out = []
    for j in range(1, k + 1):
        s = sign_odd if j % 2 == 1 else -torch.ones_like(y)
        T = torch.einsum(_einsum_spec(j), s, *([Xa] * j))
        out.append(T.reshape(-1))
    return out


def encode_clear(X, y, p: LRParams):
    """One DP's packed int64 statistics vector (ready for encryption)."""
    Xa = augment(standardise(X, p.means, p.std_devs))
    packed = torch.cat(approx_tensors(Xa, y, p.k))
    return torch.round(packed * p.precision).to(torch.int64)


def unpack(dec_ints, p: LRParams):
    """Decrypted aggregated ints -> per-degree float64 tensors (rescaled)."""
    dp1 = p.n_features + 1
    vals = torch.as_tensor(dec_ints).to(torch.float64) / p.precision
    out, off = [], 0
    for j in range(1, p.k + 1):
        n = dp1 ** j
        out.append(vals[off:off + n])
        off += n
    return out


# ---------------------------------------------------------------------------
# Querier-side training
# ---------------------------------------------------------------------------

def cost(w, Ts, N, lambda_, coeffs):
    """Approximated, l2-regularised mean log-loss, per-degree coefficients
    applied independently."""
    dp1 = w.shape[0]
    c = torch.zeros((), dtype=w.dtype, device=w.device)
    for j, Tf in enumerate(Ts, start=1):
        contr = Tf.reshape((dp1,) * j)
        for _ in range(j):
            contr = torch.tensordot(contr, w, dims=([0], [0]))
        c = c + coeffs[j] * contr
    c = c / N - coeffs[0]
    reg = torch.sum(w[1:] * w[1:])
    return c + lambda_ / (2.0 * N) * reg


def closed_form_k1(T1, lambda_, coeffs):
    """k = 1 minimiser."""
    return -coeffs[1] * T1 / lambda_


def train(Ts, p: LRParams):
    """GD on the approximated cost, keeping the best weights seen; the same
    iteration as the reference's fori_loop, without host syncs."""
    dp1 = p.n_features + 1
    coeffs = tuple(p.coeffs)
    dt = p.torch_dtype
    Ts = [torch.as_tensor(T).to(dt) for T in Ts]
    device = Ts[0].device
    if p.k == 1:
        return closed_form_k1(Ts[0], p.lambda_, coeffs)

    w = (torch.as_tensor(p.initial_weights, dtype=dt, device=device)
         if len(p.initial_weights) else torch.zeros(dp1, dtype=dt,
                                                    device=device))
    N = float(p.n_records)
    best_w = w
    best_c = torch.full((), math.inf, dtype=dt, device=device)
    for _ in range(p.max_iterations):
        w = w.detach().requires_grad_(True)
        c = cost(w, Ts, N, p.lambda_, coeffs)
        (g,) = torch.autograd.grad(c, w)
        with torch.no_grad():
            better = c < best_c
            best_w = torch.where(better, w, best_w)
            best_c = torch.where(better, c, best_c)
            w = w - p.step * g
    with torch.no_grad():
        final_c = cost(w, Ts, N, p.lambda_, coeffs)
        return torch.where(final_c < best_c, w, best_w)


# ---------------------------------------------------------------------------
# Dataset helpers (numpy, shared with the reference's data)
# ---------------------------------------------------------------------------

def shard_for_dp(X, y, dp_id: int, num_dps: int):
    """Row-shard i % num_dps == dp_id."""
    idx = np.arange(len(y)) % num_dps == dp_id
    return X[idx], y[idx]


def synthetic_dataset(n=768, d=8, seed=0):
    """Pima-shaped synthetic binary-classification data (numpy; the same
    draws as the reference)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + \
        rng.uniform(-2, 2, size=d)
    w_true = rng.normal(size=d + 1)
    z = w_true[0] + ((X - X.mean(0)) / X.std(0)) @ w_true[1:]
    y = (1 / (1 + np.exp(-z)) > rng.uniform(size=n)).astype(np.int64)
    return X, y


__all__ = [
    "MIN_AREA_COEFFS", "LRParams", "standardise", "augment",
    "approx_tensors", "encode_clear", "unpack", "cost", "closed_form_k1",
    "train", "shard_for_dp", "synthetic_dataset",
]
