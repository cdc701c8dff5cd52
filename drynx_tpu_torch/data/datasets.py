"""Dataset generation + cleaning pipeline (SURVEY.md §2.1 #29).

A copy of drynx_tpu/data/datasets.py (pure numpy): the same shapes, the
same arrays for every (name, seed), the same files.

The reference ships medical CSV datasets (Pima, SPECTF, PCS, LBW under
data/ + tmpdata/) and a `clean_data.py` preprocessing script. Those files are
third-party data we do not copy; instead this module generates synthetic
datasets with the SAME shapes, formats, and statistical character (binary
label in column 0, integer/float features, class imbalance), plus a cleaning
pipeline with the same responsibilities as the reference's script: drop rows
with missing/sentinel values, binarize labels, and write the canonical
"label-first CSV" the loaders (models/logreg.py `load_csv`,
reference lib/encoding/logistic_regression.go:1275 LoadData) expect.

CLI:
  python -m drynx_tpu_torch.data.datasets gen   --name pima --out data/pima.csv
  python -m drynx_tpu_torch.data.datasets clean --input raw.csv --out clean.csv \
      --missing -9 --label-true 1
"""
from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

# (rows, features) and a feature scale profile per reference dataset shape:
# Pima 768x8 (reference data/, LR tests service_test.go:721), SPECTF 267x44
# (:352), PCS ~1500x6 (:1051), LBW 189x9.
SHAPES = {
    "pima":   dict(n=768,  d=8,  pos_frac=0.35, int_features=True),
    "spectf": dict(n=267,  d=44, pos_frac=0.79, int_features=True),
    "pcs":    dict(n=1500, d=6,  pos_frac=0.45, int_features=True),
    "lbw":    dict(n=189,  d=9,  pos_frac=0.31, int_features=True),
}


def generate(name: str, seed: int = 0):
    """Synthetic (X, y) with the named reference dataset's shape: a noisy
    linear-logit model so encrypted training has signal to find."""
    spec = SHAPES[name]
    n, d = spec["n"], spec["d"]
    # crc32, not hash(): str hash is PYTHONHASHSEED-randomized per process,
    # so (name, seed) must map to the same stream in every process (two DPs
    # "generating the same dataset" have to agree).
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 16))
    scales = rng.uniform(1.0, 30.0, size=d)
    offsets = rng.uniform(0.0, 50.0, size=d)
    X = np.abs(rng.normal(size=(n, d))) * scales + offsets
    if spec["int_features"]:
        X = np.round(X)
    w = rng.normal(size=d)
    z = (X - X.mean(0)) / (X.std(0) + 1e-12) @ w
    # shift the intercept to hit the target positive fraction
    b = np.quantile(z, 1.0 - spec["pos_frac"])
    y = (z - b + rng.logistic(scale=0.5, size=n) > 0).astype(np.int64)
    return X, y


def write_csv(path: str, X, y, sep: str = ",") -> None:
    """Label-first CSV, integer-formatted where exact (loader format)."""
    X = np.asarray(X)
    y = np.asarray(y, dtype=np.int64)
    rows = np.concatenate([y[:, None].astype(float), X], axis=1)
    fmt = "%d" if np.allclose(rows, np.round(rows)) else "%.6f"
    np.savetxt(path, rows, delimiter=sep, fmt=fmt)


def clean(X, y, missing_sentinels=(), label_true=None):
    """Reference clean_data.py responsibilities: drop rows containing NaN or
    any sentinel value; binarize labels against `label_true` if given."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y)
    keep = ~np.isnan(X).any(axis=1)
    for s in missing_sentinels:
        keep &= ~(X == float(s)).any(axis=1)
    X, y = X[keep], y[keep]
    if label_true is not None:
        y = (y == type(y.flat[0])(label_true)).astype(np.int64)
    else:
        y = y.astype(np.int64)
    return X, y


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drynx-datasets")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate a synthetic reference-shaped dataset")
    g.add_argument("--name", choices=sorted(SHAPES), required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--seed", type=int, default=0)

    c = sub.add_parser("clean", help="clean a raw label-first CSV")
    c.add_argument("--input", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--sep", default=",")
    c.add_argument("--missing", type=float, action="append", default=[])
    c.add_argument("--label-true", default=None)

    a = p.parse_args(argv)
    if a.cmd == "gen":
        X, y = generate(a.name, a.seed)
        write_csv(a.out, X, y)
        print(f"wrote {a.out}: {X.shape[0]} rows x {X.shape[1]} features, "
              f"{int(y.sum())} positive", file=sys.stderr)
        return 0
    raw = np.loadtxt(a.input, delimiter=a.sep)
    y, X = raw[:, 0], raw[:, 1:]
    lt = None if a.label_true is None else float(a.label_true)
    X, y = clean(X, y, missing_sentinels=a.missing, label_true=lt)
    write_csv(a.out, X, y, a.sep)
    print(f"wrote {a.out}: {X.shape[0]} rows kept", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
