"""Encrypted logistic regression: DP-side encoding and querier-side GD.

The port's counterpart of drynx_tpu/models/logreg.py. The log-loss is
approximated by a degree-k polynomial in the margin w.x, so a DP's whole
contribution reduces to the sign-weighted outer-power tensors

    T_j = sum_i s_j(y_i) x_i^{(x)j},  j = 1..k,
    s_j(y) = 2y - 1 for odd j, -1 for even j,

computed as one einsum each. The querier trains by gradient descent on the
polynomial cost, with the gradient from `torch.autograd`. The loop is plain
torch: on the card each of its iterations is a few dozen small launches.

The evaluation half (reference logreg.py:77, :199-319): prediction in the
clear, encrypted prediction of encrypted raw records (the folded weights'
scalar products of the features' ciphertexts, one ladder launch, summed
by one reduce launch, plus w0'B on the C component; decrypted through the
discrete-log table), the metrics and the CSV loader, which are numpy as
in the reference.
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


def normalize(X, mins=None, maxs=None):
    """Min-max scaling to [0, 1] per column; float64."""
    X = torch.as_tensor(X, dtype=torch.float64)
    lo = X.min(0).values if mins is None else torch.as_tensor(
        mins, dtype=torch.float64, device=X.device)
    hi = X.max(0).values if maxs is None else torch.as_tensor(
        maxs, dtype=torch.float64, device=X.device)
    return (X - lo) / (hi - lo)


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
# Prediction and metrics (reference logistic_regression.go:821-899,
# 1101-1164)
# ---------------------------------------------------------------------------

def sigmoid(z):
    z = torch.as_tensor(z, dtype=torch.float64)
    return 1.0 / (1.0 + torch.exp(-z))


def predict_probs(X, w, means=None, std_devs=None):
    Xa = augment(standardise(X, means, std_devs))
    return sigmoid(Xa @ torch.as_tensor(w, dtype=torch.float64,
                                        device=Xa.device))


def predict(X, w, means=None, std_devs=None, threshold=0.5):
    return (predict_probs(X, w, means, std_devs) >= threshold).to(
        torch.int64)


def fold_affine(w, means=None, std_devs=None):
    """Fold standardisation into the weights so they act on raw records:
    w.[(x - mu)/sd] + w0 == w'.x + w0'. Returns (w0', w' (d,)), numpy."""
    if (means is None) != (std_devs is None):
        raise ValueError("means and std_devs must be given together")
    w = np.asarray(w, dtype=np.float64)
    w0, wf = float(w[0]), w[1:]
    if means is None:
        return w0, wf
    mu = np.asarray(means, dtype=np.float64)
    sd = np.asarray(std_devs, dtype=np.float64)
    return w0 - float(np.sum(wf * mu / sd)), wf / sd


def predict_homomorphic_ct(cts, w, means=None, std_devs=None,
                           precision=100.0):
    """Encrypted margin ciphertexts from per-feature ciphertexts of raw
    records (reference PredictHomomorphic, logistic_regression.go:869-899),
    on the device of `cts`.

    cts: (..., d, 2, 3, 16), one ciphertext per raw feature value. The
    weights are folded with the standardisation and scaled to fixed point;
    the margin is sum_j round(P w'_j) ct_j + Enc0(round(P w0')): one
    ladder launch for the d products (a negative weight through its mod-n
    scalar), one reduce launch for their sum, and w0'B from the fixed-base
    ladder added to the C component only. Decrypt with a discrete-log
    table and divide by `precision` for ~ w.x_std + w0."""
    from ..crypto import cuda_ops
    from ..crypto import curve as C
    from ..crypto import elgamal as eg

    dev = cts.device
    w0p, wp = fold_affine(w, means, std_devs)
    w_int = torch.from_numpy(np.round(np.asarray(wp) * precision).astype(
        np.int64)).to(dev)
    terms = eg.ct_scalar_mul(cts, eg.int_to_scalar(w_int))
    d = terms.shape[-4]
    margin = cuda_ops.point_reduce_flat(
        terms.movedim(-4, 0).reshape(d, -1, 3, 16)).reshape(
            cts.shape[:-4] + (2, 3, 16))
    w0B = eg.fixed_base_mul(
        eg.BASE_TABLE.table.to(dev), eg.int_to_scalar(torch.tensor(
            [round(w0p * precision)], dtype=torch.int64, device=dev)))[0]
    K, Cc = margin[..., 0, :, :], margin[..., 1, :, :]
    return torch.stack([K, C.add(Cc, w0B)], dim=-3)


def predict_homomorphic(cts, w, secret: int, table, means=None,
                        std_devs=None, precision=100.0, threshold=0.5):
    """Encrypted raw records -> (probs float64, preds int64, found bool),
    tensors on the device of `cts`. `table` must cover the fixed-point
    margins |P (w.x + w0)|; an entry with found False had no table hit and
    its prob means nothing: the caller must check `found`."""
    from ..crypto import elgamal as eg

    mct = predict_homomorphic_ct(cts, w, means, std_devs, precision)
    margin_int, found = eg.decrypt_ints(mct, secret, table)
    probs = sigmoid(margin_int.to(torch.float64) / precision)
    return probs, (probs >= threshold).to(torch.int64), found


def accuracy(pred, actual):
    pred, actual = np.asarray(pred), np.asarray(actual)
    return float(np.mean(pred == actual))


def precision(pred, actual):
    pred, actual = np.asarray(pred), np.asarray(actual)
    tp = int(np.sum((pred == 1) & (actual == 1)))
    fp = int(np.sum((pred == 1) & (actual == 0)))
    return tp / (tp + fp) if tp + fp else 0.0


def recall(pred, actual):
    pred, actual = np.asarray(pred), np.asarray(actual)
    tp = int(np.sum((pred == 1) & (actual == 1)))
    fn = int(np.sum((pred == 0) & (actual == 1)))
    return tp / (tp + fn) if tp + fn else 0.0


def f_score(pred, actual):
    pr, rc = precision(pred, actual), recall(pred, actual)
    return 2 * pr * rc / (pr + rc) if pr + rc else 0.0


def auc(probs, actual):
    """Area under the ROC curve (trapezoidal, like gonum integrate)."""
    probs, actual = np.asarray(probs, float), np.asarray(actual)
    order = np.argsort(-probs, kind="stable")
    lab = actual[order]
    P, Nn = int(lab.sum()), int((1 - lab).sum())
    if P == 0 or Nn == 0:
        return 0.0
    tpr = np.concatenate([[0.0], np.cumsum(lab) / P])
    fpr = np.concatenate([[0.0], np.cumsum(1 - lab) / Nn])
    return float(np.trapezoid(tpr, fpr))


# ---------------------------------------------------------------------------
# Dataset helpers (numpy, shared with the reference's data)
# ---------------------------------------------------------------------------

def load_csv(path, label_column=0, sep=","):
    """CSV -> (X float64 (n, d), y int64 (n,))."""
    raw = np.loadtxt(path, delimiter=sep, ndmin=2)
    y = raw[:, label_column].astype(np.int64)
    X = np.delete(raw, label_column, axis=1)
    return X, y


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
    "MIN_AREA_COEFFS", "LRParams", "standardise", "normalize", "augment",
    "approx_tensors", "encode_clear", "unpack", "cost", "closed_form_k1",
    "train", "sigmoid", "predict_probs", "predict", "fold_affine",
    "predict_homomorphic_ct", "predict_homomorphic", "accuracy",
    "precision", "recall", "f_score", "auc", "load_csv", "shard_for_dp",
    "synthetic_dataset",
]
