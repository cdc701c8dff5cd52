#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):
  1. Print the card's name and power limit; build every CUDA source of
     drynx_tpu_torch/csrc with nvcc (one process each, in parallel) and
     print the ptxas lines (registers, stack, spills).
  2. Run each kernel at the shapes of the main path on the card and hold
     its output against its plain PyTorch version on the same inputs, byte
     for byte; time both with CUDA events; print each kernel's ptxas
     registers, stack and spills. The Fp inverse runs at every row count
     of the cluster survey's launches (CLUSTER_ROWS), the reduce at R = 10
     over 180 columns and R = 3 over 90, the Fp12 product at 13,500 rows
     and at N = 1 (the final exponentiation's), the Fp12 inverse,
     cyclotomic square and slot maps at 13,500 rows and at N = 1.
     These rows are summed in the JSON line. The Fp inverse also runs at
     N in {1, 5, 21, 128, 129} and on edge inputs (0, 1, p - 1, R mod p,
     every power of two), the Fp12 product at N in {5, 21}, and more
     kernels at more shapes: the fixed-base ladder at W in {1, 16, 17, 64}
     x N in {1, 90, 270, 900} and on crafted tables; the reduce on crafted
     chains (every branch of the complete add) at R in {1, 2, 3, 10} and
     at (R, N) in {(1, 90), (10, 13)}; the batched add at the cluster
     survey's other shapes (810 and 13,500 rows) and on the reduce's
     crafted pairs at R = 2; the Fp12 inverse on crafted rows (0, 1, a
     Miller output, a seeded value, b = 0, a = 0), each alone and tiled to
     13,500 rows; the Fp2 inverse on crafted rows (0, 1, (a, 0), (0, b),
     -1 - i, the stored limbs (p - 1, p - 1), seeded values), all in one
     launch and tiled to 13,500 rows; the cyclotomic square on crafted rows
     (0, 1, the six unit slots w^k, a GPhi12 member, seeded values outside
     GPhi12), each alone and tiled to 13,500 rows; the slot maps on
     crafted rows at N in {1, 5, 7}; the
     Miller loop at N = 1 and 1,000; the variable-base ladder on crafted
     scalars at W in {1, 2, 16, 64} and at N in {1, 5, 21}; the G2 ladder
     on crafted scalars and at N in {1, 5, 21}; the windowed GT power on
     crafted values and exponents at n_bits in {1, 2, 3, 4, 63, 64, 128,
     256} with and without cyc and at N in {1, 5, 21}; the 8-way product
     at the joint check's fold shapes and at N in {5, 21}. These are
     checked and timed the same way but left out of the JSON line's sums.
  3. Run the flagship encrypted logistic-regression survey at the full
     Pima width (10 DPs x 768 records, d=8, K=2, 450 GD steps, 3 servers,
     discrete-log table of +-10000): with every launch count set to 0 just
     before, read just after. All 90 decrypted sums must equal the clear
     sums and be found; the weights must match GD run by the port on the
     CPU from the same sums.
  4. Print the survey's wall time (median of timed runs after a warm-up).
  5. Run the proofs-on data collection at the same width (10 DPs x 90
     values shifted by 16^5/2, ranges (16, 5), 3 servers: 13,500 digit
     proofs) through `service.collect_with_range_proofs`, with the launch
     counts set to 0 just before and read just after. Check (a) the D
     equation of every value with the G1 kernels, (b) every challenge
     recomputed on the host from the serialized payload bytes, (c) the
     pairing equation of sampled digit proofs by the host oracle, read from
     the payload bytes, and (d) that (c) rejects a tampered Zv. Print the
     phase's wall time (median of warm runs) and its split by stage.
  6. Run the verifying node's joint check of the ten phase-5 payloads
     through `service.verify_collected_range_proofs`, counted as above: all
     ten accepted; with one Zv byte of one DP changed, only that DP
     rejected. Run the per-value check (one pairing per digit proof) once
     on the concatenated payloads, counted too: all 900 values accepted,
     and on the tampered bytes only the tampered value rejected. Print the
     joint check's wall time (median of warm runs), its split by stage and
     the peak device memory.
  7. Run the proofs-on survey of bench.py:_proofs_on_cluster through
     `LocalCluster.run_survey` (3 CNs, 10 DPs, 3 VNs, seed 4, log_reg at
     the Pima width, ranges (16, 5), thresholds 1.0), counted as above: an
     audit block of 3 VNs x 16 proofs, every entry BM_TRUE; the row
     counts of every kernel's launches printed (the reduce's as (R, N)),
     those of the reduce, the Fp and Fp2 inverses, the Fp12 product, the
     cyclotomic square and the slot maps equal to CLUSTER_ROWS; all 90
     decrypted values exact and found; the weights within 1e-3 of GD on
     the CPU; the same transcript digest from a second run with the same
     seed (verification caches cleared); a key-switch payload from a VN's
     store accepted, and rejected with one zx limb changed. Print the wall
     time (median of 3 warm runs after a warm-up), the phase timers and the
     time in Schnorr signing and checking.
  Last, the kernels' times, launch counts and bounds as one JSON line, the
  card's name and power limit, and the contract line
  {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the drynx_tpu package.
"""
import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Pima width of the reference's exec benchmark (bench.py:bench_exec)
NUM_DPS, N_SERVERS, N_RECORDS, D, ITERS, DLOG_LIMIT = 10, 3, 768, 8, 450, 10000
TIMED_RUNS = 5
KERNEL_REPS = 10
# launches of one survey: encrypt rB, |m|B, rP and key switch rB, rQ;
# key switch xK and decrypt; aggregate and the two key-switch sums;
# encrypt, key switch and its finish, decrypt; one normalize
VERIFY_KERNELS = ("miller", "f12_inv", "f12_csqr", "f12_slotmul", "f12_wpow",
                  "f12_pow")   # f12_pow: no path of the port runs it
EXPECTED_LAUNCHES = {"fixed_base_mul": 5, "scalar_mul": 2, "point_reduce": 3,
                     "point_add": 4, "fp_inv": 1, "f2_inv": 0,
                     "g2_scalar_mul": 0, "f12_mul": 0, "f12_mulreduce8": 0,
                     **dict.fromkeys(VERIFY_KERNELS, 0)}
# the proofs-on survey's ranges (bench.py:RANGES, reference simulation
# preset 18) and its data collection's launches: encrypt rB, |m|B, rP and
# D's two fixed-base products; encrypt's add and D's; normalize of the
# ciphertexts and of D, of the blinded signatures V; the ladder of V; two
# passes each of the digit power and of gtB^t; the product a
U, L = 16, 5
SIG_SEED, PROOF_SEED = 5, 7
PROOF_RUNS = 3
CHECK_SAMPLES = [(dp, i, val, j) for dp, val, j in
                 ((0, 0, 0), (0, 45, 2), (NUM_DPS - 1, 17, 1),
                  (NUM_DPS - 1, 89, 4)) for i in range(N_SERVERS)]
EXPECTED_LAUNCHES_PROOFS = {"fixed_base_mul": 5, "scalar_mul": 0,
                            "point_reduce": 0, "point_add": 2, "fp_inv": 2,
                            "f2_inv": 1, "g2_scalar_mul": 1, "f12_mul": 1,
                            "f12_mulreduce8": 4,
                            **dict.fromkeys(VERIFY_KERNELS, 0)}
# the joint check's launches: the D equation (c C2, two fixed-base products,
# two adds), the GPhi12 gate (two frob2, one product), the order gate (frob1,
# a 128-bit power), gtB^(sum r Zv) (two passes); c y and -Zphi B, their sum,
# the weighting by r, both normalizations, the Miller loop, a^r (a 63-bit
# power); the folds of the Miller values and of a^r (five passes each, 13,500
# padded to 8^5); one final exponentiation (an inverse, 14 slot
# multiplications, three powers by u, four cyclotomic squares, 15 products);
# the total's two products
EXPECTED_LAUNCHES_VERIFY = {"fixed_base_mul": 3, "scalar_mul": 3,
                            "point_reduce": 0, "point_add": 3, "fp_inv": 1,
                            "f2_inv": 1, "g2_scalar_mul": 0, "f12_mul": 18,
                            "f12_mulreduce8": 12, "miller": 1, "f12_inv": 1,
                            "f12_csqr": 4, "f12_slotmul": 17, "f12_wpow": 5,
                            "f12_pow": 0}
# the per-value check's launches: the D equation as above; c y, -Zphi B and
# their sum; both normalizations; one pairing of every digit proof (the
# Miller loop and the final exponentiation above) times gtB^Zv (two passes)
EXPECTED_LAUNCHES_PER_VALUE = {"fixed_base_mul": 3, "scalar_mul": 2,
                               "point_reduce": 0, "point_add": 3, "fp_inv": 1,
                               "f2_inv": 1, "g2_scalar_mul": 0, "f12_mul": 16,
                               "f12_mulreduce8": 2, "miller": 1, "f12_inv": 1,
                               "f12_csqr": 4, "f12_slotmul": 14, "f12_wpow": 3,
                               "f12_pow": 0}
TAMPER_DP = 3
# the proofs-on LocalCluster survey (bench.py:_proofs_on_cluster): phase 5's
# creation launches (encryption: three fixed-base products and an add; the
# range proofs: D's two fixed-base products and add, two normalizations, the
# G2 ladder, its normalization, four 8-way products and a product), the
# canonical aggregate (a reduce and a normalization), the key switch (two
# fixed-base products, a ladder, an add, two reduces, the finish's add, and
# the signed-offset correction's fixed-base product and add), the key-switch
# proof (two fixed-base products, a ladder, an add, one normalization of its
# transcript), decryption (a ladder, an add, a normalization); then the VNs'
# checks, each payload once (the VNs share one verification cache): the
# joint range check as EXPECTED_LAUNCHES_VERIFY, the aggregation proof (a
# reduce), the key-switch proofs (two fixed-base products, one ladder over
# c U, zx K, c W and c Y, two adds, one normalization)
N_VNS, CLUSTER_SEED, SURVEY_SEED, CLUSTER_RUNS = 3, 4, 0, 3
SIGNED_OFFSET_LAUNCHES = {"fixed_base_mul": 1, "point_add": 1}
EXPECTED_LAUNCHES_CLUSTER = {"fixed_base_mul": 15, "scalar_mul": 7,
                             "point_reduce": 4, "point_add": 12, "fp_inv": 7,
                             "f2_inv": 2, "g2_scalar_mul": 1, "f12_mul": 19,
                             "f12_mulreduce8": 16, "miller": 1, "f12_inv": 1,
                             "f12_csqr": 4, "f12_slotmul": 17, "f12_wpow": 5,
                             "f12_pow": 0}
# the row counts of the cluster survey's B3, B4, B7, B10, B11 and B14
# launches, {rows: launches} (B3's rows (R, N)), as phase 7 records them;
# phase 2 times the kernels at each. B3: the canonical aggregate of the 10 DPs'
# ciphertexts and the VN's aggregation-proof check (R = 10 over 2 x 90
# points), the key switch's two sums over the 3 CNs; B4: the collection's
# ciphertexts and D, the canonical aggregate, the key-switch proof's
# transcript, decryption, the joint check's RLC points, the VN's
# key-switch check; B7: the collection's a = gt1 gt2 and the joint check's
# GPhi12 gate, then its final exponentiation (15) and total (2); B11: the
# joint check's GPhi12 gate (two frob2) and order gate (frob1), then its
# final exponentiation (14); B10: the final exponentiation's four
# cyclotomic squares; B14: the normalizations of the blinded signatures V,
# in the collection and in the joint check
CLUSTER_ROWS = {"point_reduce": {(10, 180): 2, (3, 90): 2},
                "fp_inv": {1800: 1, 900: 1, 180: 1, 1444: 2, 90: 1,
                           13_500: 1},
                "f2_inv": {13_500: 2},
                "f12_mul": {13_500: 2, 1: 17},
                "f12_csqr": {1: 4},
                "f12_slotmul": {13_500: 3, 1: 14}}

# H100 SXM: 132 SMs, 64 32-bit integer multiply-adds per SM per clock,
# 3.35 TB/s device memory (NVIDIA data sheet and Hopper white paper)
SMS, IMAD_PER_CLK_SM, MEM_BYTES_PER_S = 132, 64, 3.35e12
# 32-bit multiply-adds in one 8-word CIOS Montgomery product
IMAD_PER_MONT_MUL = 256
# Montgomery products per element (counted from the algorithms)
# Jacobian add-2007-bl 11M + 5S, mixed add madd-2007-bl (the second point
# affine) 7M + 4S, double dbl-2009-l 2M + 5S. The kernels' complete add
# also computes a double and keeps it only when both points are equal,
# which this run's random data never makes them, so it is not counted.
MM_G1_ADD, MM_G1_MADD, MM_G1_DBL = 16, 11, 7


def _digits(k, n_windows):
    """The low n_windows 4-bit digits of plain 16-bit-limb scalars, LSB
    first, as (rows, n_windows)."""
    d = (k.long()[:, :, None] >> (4 * torch.arange(4, device=k.device))) & 15
    return d.reshape(k.shape[0], -1)[:, :n_windows]


def mm_fixed_base(k, n_windows):
    """Montgomery products per row, averaged over the rows, that the sum
    of the selected table entries needs for this run's scalars k: digit 0
    selects infinity and costs nothing, the first non-zero digit's entry
    is a copy, and each further one a mixed add (every table entry is
    affine, Z = 1). The kernel reads every window, adds the infinities and
    sums in a tree of complete adds; the bound counts only what these
    scalars need."""
    nonzero = (_digits(k, n_windows) != 0).sum(1)
    return float((nonzero - 1).clamp(min=0).sum()) * MM_G1_MADD / k.shape[0]


def _mm_ladder(k, n_windows, mm_dbl, mm_add):
    """Montgomery products per row, averaged over the rows, of a
    variable-base ladder for this run's scalars k: the table d*P (7
    doubles and 7 adds), then, below the highest non-zero digit, 4 doubles
    a window and an add for each non-zero digit. The kernels double from
    the top window and add at every digit, infinity or not."""
    nonzero = _digits(k, n_windows) != 0
    top = torch.where(nonzero, torch.arange(n_windows, device=k.device),
                      -1).amax(1)
    rows = top >= 0
    work = (4 * top[rows] * mm_dbl + (nonzero[rows].sum(1) - 1) * mm_add)
    return 7 * (mm_dbl + mm_add) + float(work.sum()) / k.shape[0]


def mm_scalar_mul(k, n_windows):
    """The G1 ladder's products per row for this run's scalars k."""
    return _mm_ladder(k, n_windows, MM_G1_DBL, MM_G1_ADD)


# G2 over Fp2 (3 products per Fp2 product, 2 per square): a double is
# 5 squares + 2 products = 16, an add (add-2007-bl) 5 squares + 11
# products = 43; as for G1, the complete add's masked double is not counted
MM_G2_DBL, MM_G2_ADD = 16, 43


def mm_g2_ladder(k):
    """The G2 ladder's products per row (64 windows) for this run's
    scalars k."""
    return _mm_ladder(k, 64, MM_G2_DBL, MM_G2_ADD)

MM_F12_MUL = 18 * 3             # 18 Fp2 products
MM_F12_SQR = 12 * 3             # complex method: 12 Fp2 products
MM_F12_CSQR = 9 * 2             # Granger-Scott: 9 Fp2 squares
MM_F12_SLOTMUL = 6 * 3          # 6 Fp2 products by constants
# B4, counted from csrc/fp_inv.cuh in 32-bit integer operations a row (a
# 32 x 32 -> 64-bit multiply-add, or a 64-bit shift, two): a divstep 27,
# a batch's update of (d, e) 174 and of (f, g) 124, 20 batches of 30
# divsteps, then one Montgomery product (256); the limb conversions at the
# edges, under 1 %, are left out. In Montgomery products' worth, as the
# bound takes them.
OPS_FP_INV = 20 * (30 * 27 + 174 + 124) + IMAD_PER_MONT_MUL
MM_FP_INV = OPS_FP_INV / IMAD_PER_MONT_MUL
# B14: the norm (2), the Fp inverse by safegcd, two products
MM_F2_INV = 2 + MM_FP_INV + 2
# B8, the tower inverse: the norm (2 Fp6 products = 36), the Fp6 adjugate
# (3 squares, 6 products = 24), the Fp2 inverse (its norm 2, the Fp inverse
# by safegcd, 2 products) and 3 products (9), then 2 Fp6 products (36)
MM_F12_INV = 36 + 24 + (2 + MM_FP_INV + 2) + 9 + 36


def mm_miller(ate_bits):
    """Montgomery products of one Miller loop over the bits of 6u + 2 below
    its leading one: a double step per bit (a square, 5 products, 2 by an
    Fp element, 5 more squares = 31; the Fp12 square 36; the line product
    54), an add step where the bit is set and for each of the 2 Frobenius
    corrections (4 squares, 10 products, 2 by an Fp element = 42; the line
    product 54). The bits are public: the kernel adds only where one is
    set, as the function does."""
    return (len(ate_bits) * (31 + MM_F12_SQR + MM_F12_MUL)
            + (sum(ate_bits) + 2) * (42 + MM_F12_MUL))


def mm_wpow(n_bits, cyc):
    """Montgomery products of one windowed power: 3 squares and 3 products
    for the table, then 3 squares and a product per further window."""
    sq = MM_F12_CSQR if cyc else MM_F12_SQR
    return 3 * (sq + MM_F12_MUL) + ((n_bits + 2) // 3 - 1) * (3 * sq
                                                              + MM_F12_MUL)


def mm_pow(k, n_bits):
    """Montgomery products, summed over the rows, that f^k needs for the
    low n_bits of each row's k (plain 16-bit limbs, LSB first): a square
    for each bit below the highest set one and a product for each set bit
    after the first (which only copies f into the accumulator). The kernel
    squares at every bit and computes the product at every bit, keeping it
    by mask; the bound counts only what this run's exponents need."""
    bits = (k.long()[:, :, None] >> torch.arange(16, device=k.device)) & 1
    bits = bits.reshape(k.shape[0], -1)[:, :n_bits]
    ones = bits.sum(1)
    top = torch.where(bits.bool(), torch.arange(n_bits, device=k.device),
                      -1).amax(1)
    set_rows = ones > 0
    return int((top[set_rows] * MM_F12_SQR
                + (ones[set_rows] - 1) * MM_F12_MUL).sum())


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report, kernel):
    """Registers, stack and spill bytes of `kernel` in a ptxas report."""
    lines = report.splitlines()
    for j, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            text = " ".join(lines[j:j + 4])
            nums = [re.search(pat, text) for pat in (
                r"Used (\d+) registers", r"(\d+) bytes stack frame",
                r"(\d+) bytes spill stores", r"(\d+) bytes spill loads")]
            regs, stack, st, ld = (m.group(1) if m else "?" for m in nums)
            return (f"{regs} registers, {stack}-byte stack, spill stores "
                    f"{st} B, spill loads {ld} B")
    return "not in the ptxas report"


def crafted_fixed_base_cases(C, F, refimpl, device):
    """(name, table, scalars) whose fixed-base sums send the team kernel's
    complete adds, in the lanes' windows and in the tree, through every
    branch (tests/test_torch_kernels_redesign.py checks that they do).
    Table "same" holds P at every digit of every window, table "alt" P in
    even windows and -P in odd ones; digit 0 is the table's infinity. The
    scalars' digits (window w is hex digit w, least significant first):
    all 1 ("same": every add is a double; "alt": a lane's P + (-P) is
    infinity and the tree adds infinities); a checkerboard whose partial
    sums 2P and -2P meet in the tree on "alt"; a zero upper half (the tree
    adds a point and infinity); all 0. C, F, refimpl: the port's curve,
    field and refimpl modules."""
    P = refimpl.g1_mul(refimpl.G1, 5)
    same = C.from_ref_batch([None] + [P] * 15)
    neg = C.from_ref_batch([None] + [refimpl.g1_neg(P)] * 15)
    tables = {"same": same.expand(64, 16, 3, 16),
              "alt": torch.stack([neg if w % 2 else same for w in range(64)])}
    digits = [[1] * 64, [int((w % 4 + w // 4) % 2 == 0) for w in range(64)],
              [3] * 32 + [0] * 32, [0] * 64]
    ks = F.from_int([sum(d << (4 * w) for w, d in enumerate(ds))
                     for ds in digits]).to(device)
    return [(name, t.contiguous().to(device), ks)
            for name, t in tables.items()]


# crafted scalars of the variable-base ladder: 0, 1, 15, 16, n - 1, n (its
# last add is P + (-P)), n + 1, 2^256 - 1, top and bottom digits with 62
# zero windows between, and 16 a + 15 with 16 a = 15 (mod n) (its last add
# is Q + Q, the complete add's double)
def crafted_ladder_scalars(n_order):
    return [0, 1, 15, 16, n_order - 1, n_order, n_order + 1, (1 << 256) - 1,
            (0xF << 252) | 0xF,
            16 * (15 * pow(16, -1, n_order) % n_order) + 15]


def crafted_ladder_cases(C, F, refimpl, device):
    """(points, scalars) for the variable-base ladder: the crafted scalars
    on multiples of the generator, then the point at infinity with 5. At
    W = 64 their ladders meet every branch of the complete add (a double,
    P + (-P), either operand at infinity; tests/test_torch_team_kernels.py
    checks that they do). C, F, refimpl: the port's curve, field and
    refimpl modules."""
    ks = crafted_ladder_scalars(refimpl.N) + [5]
    pts = [refimpl.g1_mul(refimpl.G1, 3 + j) for j in range(len(ks) - 1)]
    return (C.from_ref_batch(pts + [None]).to(device),
            F.from_int(ks).to(device))


def crafted_g2_ladder_cases(G2, F, refimpl, device):
    """(points, scalars) for the G2 ladder: the crafted scalars of
    crafted_ladder_scalars on multiples of the twist's generator, then the
    point at infinity with 5. Their ladders meet every branch of the
    complete add, as on G1 (tests/test_torch_team_kernels.py checks that
    they do). G2, F, refimpl: the port's g2, field and refimpl modules."""
    ks = crafted_ladder_scalars(refimpl.N) + [5]
    pts = [refimpl.g2_mul(refimpl.G2, 3 + j) for j in range(len(ks) - 1)]
    return (torch.stack([G2.from_ref(q) for q in pts + [None]]).to(device),
            F.from_int(ks).to(device))


WPOW_BITS = (1, 2, 3, 4, 63, 64, 128, 256)


def crafted_wpow_cases(F, F12, params, refimpl, device):
    """(f, k) for the windowed GT power: five GPhi12 members gtB^(j + 2)
    and, last, one value outside GPhi12 (where the cyclotomic square is not
    a square); exponents 0, 1, 2^256 - 1, u and two with set bits at the
    limb edges that 3-bit windows straddle (bits 15-17, 47-49, 127-129).
    F, F12, params, refimpl: the port's modules."""
    gtb = refimpl.pair(refimpl.G1, refimpl.G2)
    vals, cur = [], refimpl.fp12_mul(gtb, gtb)
    for _ in range(5):
        vals.append(cur)
        cur = refimpl.fp12_mul(cur, gtb)
    rng = np.random.default_rng(29)
    vals.append(tuple(tuple(int.from_bytes(rng.bytes(40), "little")
                            % refimpl.P for _ in range(2)) for _ in range(6)))
    edges = sum(7 << b for b in (15, 47, 127))
    ks = [0, 1, (1 << 256) - 1, params.U, edges, edges ^ ((1 << 256) - 1)]
    return (F12.from_ref_batch(vals).to(device), F.from_int(ks).to(device))


REDUCE_RS = (1, 2, 3, 10)


def crafted_reduce_cases(C, params, refimpl, r, device):
    """(r, 7, 3, 16) summands of the reduce, one column a case; for r >= 2
    their chains send the complete add through every branch
    (tests/test_torch_reduce_slotmul.py checks that they do):
      0. distinct multiples of the generator;
      1. row 0 at infinity;
      2. row r // 2 at infinity;
      3. the last row the sum of the rows before it (the last add doubles);
      4. row 1 the negation of row 0 (the sum meets infinity, then goes on);
      5. the last row the negation of the sum before it (the sum ends at
         infinity);
      6. every row at infinity.
    Finite summands are Jacobian with Z = 2 + j + c at row j, column c
    (not affine, as the main path's are not). Seven columns are not a
    multiple of the columns a block of the kernel holds. C, params,
    refimpl: the port's curve, params and refimpl modules."""
    P = params.P
    mont = lambda v: params.to_limbs(v * params.R % P)
    cols = [[refimpl.g1_mul(refimpl.G1, 5 + 7 * j + 100 * c)
             for j in range(r)] for c in range(7)]
    cols[1][0] = None
    cols[2][r // 2] = None
    if r >= 2:
        head = lambda col: functools.reduce(refimpl.g1_add, col[:-1], None)
        cols[3][-1] = head(cols[3])
        cols[4][1] = refimpl.g1_neg(cols[4][0])
        cols[5][-1] = refimpl.g1_neg(head(cols[5]))
    cols[6] = [None] * r

    def jac(pt, z):
        if pt is None:
            return C.from_ref(None)
        x, y = pt
        return torch.tensor([mont(x * z * z % P), mont(y * z ** 3 % P),
                             mont(z)], dtype=torch.int32)

    return torch.stack([torch.stack([jac(cols[c][j], 2 + j + c)
                                     for c in range(7)])
                        for j in range(r)]).to(device)


SLOTMUL_NS = (1, 5, 7)


def crafted_slotmul_cases(params, device):
    """(7, 6, 2, 16) Fp12 rows for the slot maps: every slot 0; every limb
    the canonical maximum p - 1 (stored residues, so the value (p - 1) /
    R); every slot -1 (Montgomery p - 1); two rows that mix 0, p - 1, -1
    and seeded values slot by slot and part by part; two seeded rows.
    Their first 1, 5 and 7 rows are the shapes the CPU tests and the card
    hold them at. params: the port's params module."""
    P = params.P
    rng = np.random.default_rng(31)
    rand = lambda: params.to_limbs(
        int.from_bytes(rng.bytes(40), "little") % P * params.R % P)
    zero, top = params.to_limbs(0), params.to_limbs(P - 1)
    minus1 = params.to_limbs((P - 1) * params.R % P)
    rows = [[(zero, zero)] * 6, [(top, top)] * 6, [(minus1, minus1)] * 6,
            [(zero, top), (top, zero), (minus1, zero), (zero, minus1),
             (rand(), zero), (top, rand())],
            [(rand(), top), (zero, rand()), (minus1, rand()),
             (rand(), minus1), (top, minus1), (zero, zero)],
            [(rand(), rand()) for _ in range(6)],
            [(rand(), rand()) for _ in range(6)]]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def crafted_inv_cases(F12, refimpl, device):
    """(6, 6, 2, 16) Fp12 rows for the inverse: 0 (which maps to 0); 1;
    the Miller loop's output for the generators (outside GPhi12, as the
    final exponentiation's input is); a seeded value (not in GPhi12); a
    seeded value with b = 0 (its odd slots zero, so the norm is a^2) and
    one with a = 0 (its even slots zero, so the norm is -v b^2). F12,
    refimpl: the port's fp12 and refimpl modules."""
    rng = np.random.default_rng(37)
    rand = lambda: [tuple(int.from_bytes(rng.bytes(40), "little")
                          % refimpl.P for _ in range(2)) for _ in range(6)]
    zero = refimpl.FP2_ZERO
    a_only = [c if k % 2 == 0 else zero for k, c in enumerate(rand())]
    b_only = [zero if k % 2 == 0 else c for k, c in enumerate(rand())]
    rows = [refimpl.FP12_ZERO, refimpl.FP12_ONE,
            refimpl.ate_miller_loop(refimpl.G1, refimpl.G2), rand(), a_only,
            b_only]
    return F12.from_ref_batch(rows).to(device)


def crafted_f2_inv_cases(F2, params, device):
    """(9, 2, 16) Fp2 rows for the Fp2 inverse: 0 (which maps to 0); 1;
    (a, 0) and (0, b) for seeded a, b (a norm of one square); -1 - i (the
    value (p - 1, p - 1)); the stored limbs (p - 1, p - 1), the largest
    canonical residues; three seeded values. F2, params: the port's fp2 and
    params modules."""
    rng = np.random.default_rng(43)
    rand = lambda: int.from_bytes(rng.bytes(40), "little") % params.P
    top = params.to_limbs(params.P - 1)
    rows = [F2.from_ref(v) for v in ((0, 0), (1, 0), (rand(), 0),
                                     (0, rand()),
                                     (params.P - 1, params.P - 1))]
    rows.append(torch.tensor([top, top], dtype=torch.int32))
    rows += [F2.from_ref((rand(), rand())) for _ in range(3)]
    return torch.stack(rows).to(device)


def crafted_csqr_cases(F12, refimpl, device):
    """(11, 6, 2, 16) Fp12 rows for the cyclotomic square: 0; 1; the six
    unit slots w^k, k = 0 ... 5 (a single non-zero slot, which a wrong slot
    map moves); a GPhi12 member, the pairing of the generators; two seeded
    values outside GPhi12, where the function is not the square. F12,
    refimpl: the port's fp12 and refimpl modules."""
    rng = np.random.default_rng(47)
    rand = lambda: [tuple(int.from_bytes(rng.bytes(40), "little")
                          % refimpl.P for _ in range(2)) for _ in range(6)]
    zero, one = refimpl.FP2_ZERO, refimpl.FP2_ONE
    units = [[one if m == k else zero for m in range(6)] for k in range(6)]
    rows = [refimpl.FP12_ZERO, refimpl.FP12_ONE, *units,
            refimpl.pair(refimpl.G1, refimpl.G2), rand(), rand()]
    return F12.from_ref_batch(rows).to(device)


def fp_inv_edge_inputs(F, params, device):
    """Edge inputs of the Fp inverse: 0, 1, p - 1, R mod p (the Montgomery
    one) and every power of two below p, as (260, 16) limbs. F, params:
    the port's field and params modules."""
    vals = [0, 1, params.P - 1, params.R % params.P] + [
        1 << k for k in range(256) if 1 << k < params.P]
    return F.from_int(vals).to(device)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def parse_payload(buf):
    """A DP's range-proof payload (RangeProofList bytes) -> its batches,
    each a dict of numpy byte arrays in the wire layout."""
    def take(n, dtype=np.uint8):
        nonlocal off
        out = np.frombuffer(buf[off:off + n], dtype=dtype)
        off += n
        return out

    off = 0
    _n_values, n_batches = take(16, "<i8")
    batches = []
    for _ in range(int(n_batches)):
        n_idx, _n_blob = take(16, "<i8")
        b = {"idx": take(8 * int(n_idx), "<i8")}
        u, l, v, ns = (int(x) for x in take(32, "<i8"))
        b.update(u=u, l=l)
        for name, shape in (("commit", (v, 128)), ("challenge", (v, 32)),
                            ("zr", (v, 32)), ("d", (v, 64)),
                            ("zphi", (v, l, 32)), ("zv", (ns, v, l, 32)),
                            ("v", (ns, v, l, 128)), ("a", (ns, v, l, 384))):
            b[name] = take(int(np.prod(shape))).reshape(shape)
        batches.append(b)
    if off != len(buf):
        raise SystemExit("payload has trailing bytes")
    return batches


def big(b):
    """A big-endian byte row -> a Python int."""
    return int.from_bytes(b.tobytes(), "big")


def digit_pairing_ok(refimpl, gtb, c, y, zphi, zv, v_bytes, a_bytes):
    """a == e(c y - Zphi B, V) gtB^Zv by the host oracle, every operand
    read from the wire bytes."""
    vals = [big(v_bytes[32 * k:32 * (k + 1)]) for k in range(4)]
    vpt = (None if not any(vals)
           else ((vals[0], vals[1]), (vals[2], vals[3])))
    a = tuple((big(a_bytes[64 * k:64 * k + 32]),
               big(a_bytes[64 * k + 32:64 * (k + 1)])) for k in range(6))
    g1 = refimpl.g1_add(refimpl.g1_mul(y, c),
                        refimpl.g1_neg(refimpl.g1_mul(refimpl.G1, zphi)))
    return refimpl.fp12_mul(refimpl.pair(g1, vpt),
                            refimpl.fp12_pow(gtb, zv)) == a


def tamper_zv(buf):
    """The payload with the last (least significant) byte of its first Zv
    scalar (server 0, value 0, digit 0) changed."""
    n_idx = int(np.frombuffer(buf[16:24], dtype="<i8")[0])
    head = 32 + 8 * n_idx
    _u, l, v, _ns = (int(x) for x in np.frombuffer(buf[head:head + 32], "<i8"))
    at = head + 32 + v * (128 + 32 + 32 + 64) + v * l * 32 + 31
    b = bytearray(buf)
    b[at] ^= 1
    return bytes(b)


class HostTimer:
    """Calls of a host function, with the wall time of each call and the
    CPU time of its thread in it, summed over every thread that calls it.
    Threads that wait for the interpreter lock add wall time, not CPU
    time."""

    def __init__(self, module, name):
        self.fn = getattr(module, name)
        self.lock = threading.Lock()
        self.reset()

        def timed(*a, **k):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.fn(*a, **k)
            finally:
                with self.lock:
                    self.seconds += time.perf_counter() - t0
                    self.cpu += time.thread_time() - c0
                    self.calls += 1
        setattr(module, name, timed)

    def reset(self):
        with self.lock:
            self.seconds, self.cpu, self.calls = 0.0, 0.0, 0


def phase7(stats, X, y, params, zero_launches, launch_counts):
    """The proofs-on survey of bench.py:_proofs_on_cluster through the
    port's LocalCluster on the card. Returns (launches, warm wall times)."""
    import pickle

    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.proofs import requests as rq
    from drynx_tpu_torch.proofs import schnorr
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=NUM_DPS, n_vns=N_VNS,
                           seed=CLUSTER_SEED, dlog_limit=DLOG_LIMIT)
    for i, dp in enumerate(cluster.dps.values()):
        dp.data = lr.shard_for_dp(X, y, i, NUM_DPS)
    V = stats.shape[1]
    sq = cluster.generate_survey_query("log_reg", proofs=1, lr_params=params,
                                       ranges=[(U, L)] * V, thresholds=1.0)
    cluster.ensure_range_sigs(U)
    torch.cuda.synchronize()
    print(f"phase 7 setup: cluster keys, tables and {N_SERVERS} signature "
          f"sets of u={U} {time.perf_counter() - t0:.1f} s", flush=True)
    sign = HostTimer(schnorr, "sign")
    check = HostTimer(schnorr, "verify")
    sid = sq.survey_id
    clear = stats.sum(0).cpu()

    def run():
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        sign.reset()
        check.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run_survey(sq, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if res.block is None:
            raise SystemExit("no audit block committed")
        bitmap = res.block.data.bitmap
        if (len(bitmap) != N_VNS * (NUM_DPS + 2 * N_SERVERS)
                or set(bitmap.values()) != {rq.BM_TRUE}):
            raise SystemExit(f"audit block bitmap: {len(bitmap)} entries, "
                             f"codes {sorted(set(bitmap.values()))}")
        dec = torch.from_numpy(res.decrypted.values)
        if not res.decrypted.found.all() or not torch.equal(dec, clear):
            raise SystemExit("decrypted values differ from the clear sums")
        return wall, res

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    first_s, res = run()
    launches7 = launch_counts()
    rows7 = {k: dict(sorted(v.items()))
             for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
    print(f"phase 7: first proofs-on cluster survey {first_s:.3f} s; "
          f"launches {launches7}", flush=True)
    print(f"phase 7: launch shapes, {{kernel: {{rows: launches}}}}: {rows7}",
          flush=True)
    if launches7 != EXPECTED_LAUNCHES_CLUSTER:
        raise SystemExit(f"cluster survey launches {launches7} differ from "
                         f"{EXPECTED_LAUNCHES_CLUSTER}")
    for name, want in CLUSTER_ROWS.items():
        if rows7.get(name) != want:
            raise SystemExit(f"cluster survey {name} shapes {rows7.get(name)}"
                             f" differ from {want}, phase 2's")
    w = torch.from_numpy(res.result)
    w_cpu = lr.train(lr.unpack(torch.from_numpy(res.decrypted.values),
                               params), params)
    w_err = float((w - w_cpu).abs().max())
    w_tol = 1e-3 * max(1.0, float(w_cpu.abs().max()))
    if w.shape != (D + 1,) or not bool(torch.isfinite(w).all()) or w_err > w_tol:
        raise SystemExit(f"cluster weights differ from CPU GD: {w_err}")
    digest = transcript_digest(cluster.vns, sid)
    print(f"  audit block #{res.block.index}: {len(res.block.data.bitmap)} "
          f"entries, all BM_TRUE; all {V} values exact and found; weights "
          f"max abs err vs CPU GD {w_err:.3g} (tolerance {w_tol:.3g}); "
          f"transcript {digest[:16]}; Schnorr {sign.calls} signs "
          f"{sign.cpu:.3f} s CPU, {check.calls} checks {check.cpu:.3f} s "
          f"CPU", flush=True)

    walls, splits, host = [], [], []
    for i in range(1 + CLUSTER_RUNS):
        wall, res = run()
        if i == 0:
            again = transcript_digest(cluster.vns, sid)
            if again != digest:
                raise SystemExit("a second run with the same seed gives "
                                 f"transcript {again}, not {digest}")
            continue
        walls.append(wall)
        splits.append(dict(res.timers.items()))
        host.append((sign.cpu, check.cpu, sign.seconds + check.seconds))

    # a key-switch payload from a VN's store, and a copy with one zx limb
    # changed, through the VN's own verifier
    vn = cluster.vns.vns[1]
    data = vn.stored_proofs(sid)[f"{sid}/keyswitch/cn0/keyswitch-cn0"]
    proof = safe_loads(data)
    proof.zx[1, 7, 0] ^= 1
    vks = vn.verify_fns["keyswitch"]
    ok, bad = vks(data, sid), vks(pickle.dumps(proof), sid)
    if ok is not True or bad is not False:
        raise SystemExit(f"key-switch verifier: honest {ok}, tampered {bad}")

    med = statistics.median(walls)
    split = {k: statistics.median(s.get(k, 0.0) for s in splits)
             for k in sorted({k for s in splits for k in s})}
    sign_s, check_s, wall_s = (statistics.median(h[j] for h in host)
                               for j in (0, 1, 2))
    print(f"  the same transcript from a second run; key-switch payload "
          f"accepted, with one zx limb changed rejected", flush=True)
    print(f"phase 7: cluster survey wall time median {med:.4f} s over "
          f"{CLUSTER_RUNS} warm runs after a warm-up (all: "
          f"{[round(x, 4) for x in walls]}); phase timers, median: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
          + f"; Schnorr, median CPU time: {sign.calls} signs {sign_s:.4f} s "
          f"+ {check.calls} checks {check_s:.4f} s = {sign_s + check_s:.4f} s"
          f" ({100 * (sign_s + check_s) / med:.1f} % of the wall time; "
          f"{wall_s:.4f} s of call wall time summed over threads); peak "
          f"device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    cluster.close()
    return launches7, walls


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from drynx_tpu_torch import flagship
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import fp2 as F2
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import gt as GT
    from drynx_tpu_torch.crypto import params as bn256, refimpl
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.proofs import encoding as enc
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.service import service as svc
    from drynx_tpu_torch.utils import cuda_build

    def zero_launches():
        for counts in (cuda_ops.LAUNCHES, cuda_pairing.LAUNCHES):
            for key in counts:
                counts[key] = 0
        cuda_build.reset_launch_rows()

    def launch_counts():
        return {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"card: {card}; max SM clock {sm_mhz} MHz", flush=True)

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"phase 1: built {sorted(reports)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "stack frame", "spill")):
                print(f"  ptxas[{name}] {line.strip()}")

    # -- inputs at the main path's shapes ------------------------------------
    X, y, params = flagship.pima_shaped_problem(
        num_dps=NUM_DPS, n_records=N_RECORDS, d=D, max_iterations=ITERS)
    t0 = time.perf_counter()
    setup = flagship.SurveySetup.create(n_servers=N_SERVERS,
                                        dlog_limit=DLOG_LIMIT, device=dev)
    stats, enc_rs, ks_rs = flagship.make_inputs(X, y, params, NUM_DPS,
                                                N_SERVERS, device=dev)
    V = stats.shape[1]
    print(f"setup: V={V} ciphertexts per DP, host keygen + tables "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = eg.BASE_TABLE.table.to(dev)
    mag, _ = eg.magnitude_limbs(stats.reshape(-1))
    cts = eg.encrypt_ints_with_tables(base, setup.coll_pub_table, stats,
                                      enc_rs)                # (10, V, 2, 3, 16)
    pts_v = cts[0, :, 0]                                     # (V, 3, 16)
    secrets = setup.server_secrets[:, None, :].expand(N_SERVERS, V, 16)
    qx = eg.secret_to_limbs(setup.query_secret).to(dev).expand(V, 16)
    pts_sv = pts_v[None].expand(N_SERVERS, V, 3, 16).reshape(-1, 3, 16)
    # adds: valid points, with lanes that hit P + P, P + (-P) and infinity
    a900 = cts[:, :, 0].reshape(-1, 3, 16)
    b900 = cts[:, :, 1].reshape(-1, 3, 16).clone()
    b900[0], b900[1] = a900[0], C.neg(a900[1:2])[0]
    b900[2] = C.infinity((), dev)
    zs = cts[0, :, 1, 2].contiguous()                        # (V, 16) nonzero Z
    # the key switch's sums over the servers: its callers hand the reduce
    # contiguous (R, N, 3, 16) tensors, as these are
    ks_k = cts[:N_SERVERS, :, 0].contiguous()
    ks_c = cts[:N_SERVERS, :, 1].contiguous()
    # B4 at the cluster survey's row counts: canonical residues from a seed
    inv_rng = np.random.default_rng(PROOF_SEED + 4)
    inv_x = F.from_int([int.from_bytes(inv_rng.bytes(40), "little") % bn256.P
                        for _ in range(max(CLUSTER_ROWS["fp_inv"]))]).to(dev)
    inv_edge = fp_inv_edge_inputs(F, bn256, dev)

    # proofs-on setup: the servers' digit signatures and their GT window
    # tables (host pairings, timed as setup), then the four proof kernels'
    # inputs at the shapes of phase 5, built from the same tables and digits
    t0 = time.perf_counter()
    sigs = svc.make_range_sigs(U, N_SERVERS, seed=SIG_SEED, device=dev)
    gtb_table = rp.gt_base_table().to(dev)
    print(f"setup: {N_SERVERS} signature sets of u={U}, their {N_SERVERS * U}"
          f" host pairings and GT window tables "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ranges = [(U, L)] * V
    n_vals = NUM_DPS * V
    n_proofs = N_SERVERS * n_vals * L
    digits = torch.from_numpy(rp.to_base(
        (stats + U ** L // 2).reshape(-1).cpu().numpy(), U, L)).to(dev)
    A_tab = torch.stack([sg.A for sg in sigs]).to(dev)
    kgen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 1)
    g2_p = A_tab[:, digits.long()].reshape(-1, 3, 2, 16)    # (13500, 3, 2, 16)
    g2_k = eg.random_scalars((n_proofs,), kgen, dev)
    g2_z = cuda_pairing.g2_scalar_mul_flat(g2_p, g2_k)[:, 2].contiguous()
    win = torch.arange(64, device=dev)
    base_idx = (torch.arange(N_SERVERS, device=dev)[:, None, None] * U
                + digits.long()[None]).reshape(-1)
    g_multi = rp.sig_gt_pow_tables(sigs, dev)[
        base_idx[:, None], win[None, :], cuda_pairing.window_digits(g2_k)]
    g_multi = g_multi.reshape(-1, 8, 6, 2, 16)             # (108000, 8, ...)
    g_multi2 = cuda_pairing.f12_mulreduce8_flat(g_multi).reshape(
        -1, 8, 6, 2, 16)
    t_k = eg.random_scalars((n_vals * L,), kgen, dev)
    g_gtb = gtb_table[win[None, :], cuda_pairing.window_digits(t_k)].reshape(
        -1, 8, 6, 2, 16)                                   # (36000, 8, ...)
    g_gtb2 = cuda_pairing.f12_mulreduce8_flat(g_gtb).reshape(-1, 8, 6, 2, 16)
    gt1 = cuda_pairing.f12_mulreduce8_flat(g_multi2)
    gt2 = cuda_pairing.f12_mulreduce8_flat(g_gtb2).expand(
        N_SERVERS, -1, 6, 2, 16).reshape(-1, 6, 2, 16).contiguous()

    # the five verification kernels' inputs, from the payloads of one
    # collection (phase 5's seed): the RLC check's weighted G1 arguments
    # and blinded signatures, affine, for the Miller loop; the GT
    # commitments a (GPhi12 members) and conj6(a) for the powers, the
    # squares and the slot maps; the Miller values for the inverse
    coll_tbl = setup.coll_pub_table
    _, lists0 = svc.collect_with_range_proofs(
        stats, enc_rs, ranges, {U: sigs}, coll_tbl,
        generator=torch.Generator(device=dev).manual_seed(PROOF_SEED))
    pubs = [sg.public for sg in sigs]
    vb = rp._concat_batches([lst.batches[0][1] for lst in lists0])
    r_w = eg.int_to_scalar(torch.from_numpy(
        np.random.default_rng(PROOF_SEED).integers(
            1, 1 << 62, size=(N_SERVERS, n_vals, L), dtype=np.int64)
    ).to(dev)).reshape(-1, 16)
    ml_px, ml_py, _ = C.normalize(C.scalar_mul_short(
        rp._g1_args(vb, pubs).reshape(-1, 3, 16), r_w, 64))
    ml_qx, ml_qy, _ = G2.normalize(vb.v_pts.reshape(-1, 3, 2, 16))
    ml_in = (ml_px, ml_py, ml_qx, ml_qy)
    gt_a = vb.a.reshape(-1, 6, 2, 16).contiguous()
    gt_ca = F12.conj6(gt_a).contiguous()
    t1_k = F.from_int(refimpl.P - refimpl.N).to(dev).expand(
        n_proofs, 16).contiguous()
    ml_out = cuda_pairing.miller_flat(*ml_in)
    f12_bytes = nbytes(gt_a)

    # the ladder's other main-path shapes: the D equation's c C2 (one row a
    # value), the VN's key-switch check (c U, zx K, c W, c Y), c y (a row a
    # value and server) and the RLC weighting of every digit proof's
    # c y - Zphi B by its 62-bit weight (16 windows)
    u_k = F.from_int(bn256.U).to(dev)[None]
    lgen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 3)
    ladder_rows = [
        (64, a900.repeat(3, 1, 1)[:n], eg.random_scalars((n,), lgen, dev),
         what) for n, what in ((n_vals, "D equation c C2"),
                               (4 * N_SERVERS * V, "key-switch check"),
                               (N_SERVERS * n_vals, "c y"))] + [
        (16, rp._g1_args(vb, pubs).reshape(-1, 3, 16), r_w,
         "RLC weighting")]
    K = NUM_DPS * V
    cases = {
        # kernel: list of (label, wrapper call, plain call, mont muls/elem,
        #                  elements, bytes moved)
        "fixed_base_mul": [
            (f"W=64 N={K} (rB)", lambda: cuda_ops.fixed_base_mul_flat(
                base, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, enc_rs.reshape(-1, 16)),
             mm_fixed_base(enc_rs.reshape(-1, 16), 64), K,
             nbytes(base, enc_rs) + K * 192),
            (f"W=16 N={K} (|m|B)", lambda: cuda_ops.fixed_base_mul_flat(
                base, mag, 16),
             lambda: cuda_ops.fixed_base_mul_plain(base, mag, 16),
             mm_fixed_base(mag, 16), K, nbytes(base[:16], mag) + K * 192),
            (f"W=64 N={K} (rP)", lambda: cuda_ops.fixed_base_mul_flat(
                setup.coll_pub_table, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.coll_pub_table,
                                                   enc_rs.reshape(-1, 16)),
             mm_fixed_base(enc_rs.reshape(-1, 16), 64), K,
             nbytes(base, enc_rs) + K * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rB)",
             lambda: cuda_ops.fixed_base_mul_flat(base, ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, ks_rs.reshape(-1, 16)),
             mm_fixed_base(ks_rs.reshape(-1, 16), 64), N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rQ)",
             lambda: cuda_ops.fixed_base_mul_flat(setup.query_pub_table,
                                                  ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.query_pub_table,
                                                   ks_rs.reshape(-1, 16)),
             mm_fixed_base(ks_rs.reshape(-1, 16), 64), N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
        ],
        "scalar_mul": [
            (f"W=64 N={N_SERVERS * V} (key switch xK)",
             lambda: cuda_ops.scalar_mul_flat(pts_sv, secrets.reshape(-1, 16)),
             lambda: cuda_ops.scalar_mul_plain(pts_sv, secrets.reshape(-1, 16)),
             mm_scalar_mul(secrets.reshape(-1, 16), 64), N_SERVERS * V,
             N_SERVERS * V * (192 + 64 + 192)),
            (f"W=64 N={V} (decrypt)",
             lambda: cuda_ops.scalar_mul_flat(pts_v, qx.contiguous()),
             lambda: cuda_ops.scalar_mul_plain(pts_v, qx.contiguous()),
             mm_scalar_mul(qx, 64), V, V * (192 + 64 + 192)),
        ] + [
            (f"W={w} N={len(k)} ({what})",
             (lambda p=p, k=k, w=w: cuda_ops.scalar_mul_flat(p, k, w)),
             (lambda p=p, k=k, w=w: cuda_ops.scalar_mul_plain(p, k, w)),
             mm_scalar_mul(k, w), len(k), len(k) * (192 + 64 + 192))
            for w, p, k, what in ladder_rows
        ],
        "point_reduce": [
            (f"R={NUM_DPS} N={2 * V} (aggregate)",
             lambda: cuda_ops.point_reduce_flat(cts.reshape(NUM_DPS, -1, 3, 16)),
             lambda: cuda_ops.point_reduce_plain(cts.reshape(NUM_DPS, -1, 3, 16)),
             MM_G1_ADD * (NUM_DPS - 1), 2 * V, (NUM_DPS + 1) * 2 * V * 192),
            (f"R={N_SERVERS} N={V} (key switch K sum)",
             lambda: cuda_ops.point_reduce_flat(ks_k),
             lambda: cuda_ops.point_reduce_plain(ks_k),
             MM_G1_ADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
            (f"R={N_SERVERS} N={V} (key switch C sum)",
             lambda: cuda_ops.point_reduce_flat(ks_c),
             lambda: cuda_ops.point_reduce_plain(ks_c),
             MM_G1_ADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
        ],
        "point_add": [
            (f"N={n} ({what})",
             (lambda n=n: cuda_ops.point_add_flat(a900[:n], b900[:n])),
             (lambda n=n: cuda_ops.point_add_plain(a900[:n], b900[:n])),
             MM_G1_ADD, n, 3 * n * 192)
            for n, what in ((K, "encrypt mB + rP"),
                            (N_SERVERS * V, "key switch rQ - xK"),
                            (V, "key switch finish"), (V, "decrypt C - xK"))
        ],
        # the survey's normalize, then the cluster survey's other shapes
        "fp_inv": [
            (f"N={V} (normalize)", lambda: cuda_pairing.fp_inv_flat(zs),
             lambda: cuda_pairing.fp_inv_plain(zs), MM_FP_INV, V, 2 * V * 64),
        ] + [
            (f"N={n} (cluster survey)",
             (lambda n=n: cuda_pairing.fp_inv_flat(inv_x[:n])),
             (lambda n=n: cuda_pairing.fp_inv_plain(inv_x[:n])), MM_FP_INV,
             n, 2 * n * 64)
            for n in sorted(CLUSTER_ROWS["fp_inv"]) if n != V
        ],
        "f2_inv": [
            (f"N={n_proofs} (normalize V)",
             lambda: cuda_pairing.f2_inv_flat(g2_z),
             lambda: cuda_pairing.f2_inv_plain(g2_z), MM_F2_INV, n_proofs,
             2 * nbytes(g2_z)),
        ],
        "g2_scalar_mul": [
            (f"N={n_proofs} (V = v A[digit])",
             lambda: cuda_pairing.g2_scalar_mul_flat(g2_p, g2_k),
             lambda: cuda_pairing.g2_scalar_mul_plain(g2_p, g2_k),
             mm_g2_ladder(g2_k), n_proofs, 2 * nbytes(g2_p) + nbytes(g2_k)),
        ],
        "f12_mul": [
            (f"N={n_proofs} (a = gt1 gt2)",
             lambda: cuda_pairing.f12_mul_flat(gt1, gt2),
             lambda: cuda_pairing.f12_mul_plain(gt1, gt2), MM_F12_MUL,
             n_proofs, 3 * nbytes(gt1)),
            ("N=1 (final exp, total)",
             lambda: cuda_pairing.f12_mul_flat(gt1[:1], gt2[:1]),
             lambda: cuda_pairing.f12_mul_plain(gt1[:1], gt2[:1]),
             MM_F12_MUL, 1, 3 * 768),
        ],
        "f12_mulreduce8": [
            (f"N={g.shape[0]} ({what})",
             (lambda g=g: cuda_pairing.f12_mulreduce8_flat(g)),
             (lambda g=g: cuda_pairing.f12_mulreduce8_plain(g)),
             7 * MM_F12_MUL, g.shape[0], nbytes(g) * 9 // 8)
            for g, what in ((g_multi, "digit power, pass 1"),
                            (g_multi2, "digit power, pass 2"),
                            (g_gtb, "gtB^t, pass 1"),
                            (g_gtb2, "gtB^t, pass 2"))
        ],
        "miller": [
            (f"N={n_proofs} (RLC Miller loop)",
             lambda: cuda_pairing.miller_flat(*ml_in),
             lambda: cuda_pairing.miller_plain(*ml_in),
             mm_miller(cuda_pairing.ATE_BITS), n_proofs,
             nbytes(*ml_in) + f12_bytes),
        ],
        # B8, B10, B11: the per-value check's final exponentiation at
        # 13,500 rows, the joint check's at N = 1
        "f12_inv": [
            (f"N={n} ({what} final exp)",
             (lambda n=n: cuda_pairing.f12_inv_flat(ml_out[:n])),
             (lambda n=n: cuda_pairing.f12_inv_plain(ml_out[:n])),
             MM_F12_INV, n, 2 * n * 768)
            for n, what in ((n_proofs, "per-value"), (1, "joint check"))
        ],
        "f12_csqr": [
            (f"N={n} ({what} final exp)",
             (lambda n=n: cuda_pairing.f12_csqr_flat(gt_a[:n])),
             (lambda n=n: cuda_pairing.f12_csqr_plain(gt_a[:n])),
             MM_F12_CSQR, n, 2 * n * 768)
            for n, what in ((n_proofs, "per-value"), (1, "joint check"))
        ],
        "f12_slotmul": [
            (f"N={n} ({w})",
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_flat(gt_a[:n], w)),
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_plain(gt_a[:n], w)),
             MM_F12_SLOTMUL, n, 2 * n * 768)
            for n in (n_proofs, 1) for w in cuda_pairing.SLOT_MAPS
        ],
        "f12_wpow": [
            (f"N={n_proofs} 128 bits cyc (order gate)",
             lambda: cuda_pairing.f12_wpow_flat(gt_a, t1_k, 128, cyc=True),
             lambda: cuda_pairing.f12_wpow_plain(gt_a, t1_k, 128, True),
             mm_wpow(128, True), n_proofs, 2 * f12_bytes + nbytes(t1_k)),
            (f"N={n_proofs} 63 bits cyc (a^r)",
             lambda: cuda_pairing.f12_wpow_flat(gt_ca, r_w, 63, cyc=True),
             lambda: cuda_pairing.f12_wpow_plain(gt_ca, r_w, 63, True),
             mm_wpow(63, True), n_proofs, 2 * f12_bytes + nbytes(r_w)),
            ("N=1 63 bits cyc (final exp, power by u)",
             lambda: cuda_pairing.f12_wpow_flat(gt_a[:1], u_k, 63, cyc=True),
             lambda: cuda_pairing.f12_wpow_plain(gt_a[:1], u_k, 63, True),
             mm_wpow(63, True), 1, 2 * 768 + 64),
        ],
        # square-and-multiply-always; the bound counts the squares and the
        # set bits' products that these exponents need (mm_pow)
        "f12_pow": [
            (f"N={n_proofs} {n} bits", (lambda n=n: cuda_pairing.f12_pow_flat(
                gt_a, g2_k, n)),
             (lambda n=n: F12.pow_var(gt_a, g2_k, n)),
             mm_pow(g2_k, n) / n_proofs, n_proofs,
             2 * f12_bytes + nbytes(g2_k))
            for n in (48, 256)
        ],
    }
    # the team kernels and the slot map at more shapes than the main
    # path's and on crafted inputs (the 8-way product at the joint check's
    # small shapes, the add at the cluster survey's other shapes): checked
    # and timed like the rows above, not summed. The crafted sums repeat
    # one point or meet infinity, which compute in far fewer products than
    # adds of distinct points: their bound counts only bytes
    rng_x = np.random.default_rng(PROOF_SEED + 2)
    ladder_crafted = crafted_ladder_cases(C, F, refimpl, dev)
    g2_crafted = crafted_g2_ladder_cases(G2, F, refimpl, dev)
    wpow_crafted = crafted_wpow_cases(F, F12, bn256, refimpl, dev)
    reduce_crafted = [crafted_reduce_cases(C, bn256, refimpl, r, dev)
                      for r in REDUCE_RS]
    slot_crafted = crafted_slotmul_cases(bn256, dev)
    # B5's other cluster shapes: the survey's operands, repeated; its
    # crafted pairs, the reduce's R = 2 chains (every branch of the
    # complete add)
    a13500, b13500 = a900.repeat(15, 1, 1), b900.repeat(15, 1, 1)
    add_p, add_q = reduce_crafted[REDUCE_RS.index(2)]
    # B8's crafted rows, alone and tiled to the per-value check's 13,500
    inv_crafted = crafted_inv_cases(F12, refimpl, dev)
    inv_tiled = inv_crafted.repeat(n_proofs // len(inv_crafted) + 1, 1, 1,
                                   1)[:n_proofs].contiguous()
    # B14's and B10's crafted rows, and tiled to their 13,500-row launches
    f2_crafted = crafted_f2_inv_cases(F2, bn256, dev)
    f2_tiled = f2_crafted.repeat(n_proofs // len(f2_crafted) + 1, 1,
                                 1)[:n_proofs].contiguous()
    csqr_crafted = crafted_csqr_cases(F12, refimpl, dev)
    csqr_tiled = csqr_crafted.repeat(n_proofs // len(csqr_crafted) + 1, 1, 1,
                                     1)[:n_proofs].contiguous()

    def scalars(n, n_windows):
        lim = min(refimpl.N, 16 ** n_windows)
        return F.from_int([int.from_bytes(rng_x.bytes(32), "little") % lim
                           for _ in range(n)]).to(dev)

    extra = {
        # the crafted chains (every branch of the complete add), a reduce
        # of one row, and a partly filled block
        "point_reduce": [
            (f"crafted R={len(t)} N={t.shape[1]}",
             (lambda t=t: cuda_ops.point_reduce_flat(t)),
             (lambda t=t: cuda_ops.point_reduce_plain(t)), 0, t.shape[1],
             (len(t) + 1) * t.shape[1] * 192)
            for t in reduce_crafted
        ] + [
            (f"R={r} N={n}",
             (lambda r=r, n=n: cuda_ops.point_reduce_flat(
                 a900[:r * n].reshape(r, n, 3, 16))),
             (lambda r=r, n=n: cuda_ops.point_reduce_plain(
                 a900[:r * n].reshape(r, n, 3, 16))),
             MM_G1_ADD * (r - 1), n, (r + 1) * n * 192)
            for r, n in ((1, V), (10, 13))
        ],
        "point_add": [
            (f"N={n} (cluster survey)",
             (lambda n=n: cuda_ops.point_add_flat(a13500[:n], b13500[:n])),
             (lambda n=n: cuda_ops.point_add_plain(a13500[:n], b13500[:n])),
             MM_G1_ADD, n, 3 * n * 192)
            for n in (810, 13_500)
        ] + [
            (f"crafted pairs N={len(add_p)}",
             lambda: cuda_ops.point_add_flat(add_p, add_q),
             lambda: cuda_ops.point_add_plain(add_p, add_q), 0, len(add_p),
             3 * len(add_p) * 192)
        ],
        # the crafted rows (0, 1, a Miller output, b = 0, a = 0), each alone
        # and tiled to 13,500 rows
        "f12_inv": [
            (f"crafted row {k} N=1",
             (lambda k=k: cuda_pairing.f12_inv_flat(inv_crafted[k:k + 1])),
             (lambda k=k: cuda_pairing.f12_inv_plain(inv_crafted[k:k + 1])),
             MM_F12_INV, 1, 2 * 768)
            for k in range(len(inv_crafted))
        ] + [
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f12_inv_flat(inv_tiled),
             lambda: cuda_pairing.f12_inv_plain(inv_tiled), MM_F12_INV,
             n_proofs, 2 * nbytes(inv_tiled))
        ],
        # the crafted rows (0, 1, (a, 0), (0, b), -1 - i, limbs at p - 1,
        # seeded) in one launch and tiled to 13,500 rows
        "f2_inv": [
            (f"crafted N={len(f2_crafted)}",
             lambda: cuda_pairing.f2_inv_flat(f2_crafted),
             lambda: cuda_pairing.f2_inv_plain(f2_crafted), MM_F2_INV,
             len(f2_crafted), 2 * nbytes(f2_crafted)),
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f2_inv_flat(f2_tiled),
             lambda: cuda_pairing.f2_inv_plain(f2_tiled), MM_F2_INV,
             n_proofs, 2 * nbytes(f2_tiled)),
        ],
        # the crafted rows (0, 1, the unit slots, GPhi12, outside it), each
        # alone (one team) and tiled to 13,500 rows
        "f12_csqr": [
            (f"crafted row {k} N=1",
             (lambda k=k: cuda_pairing.f12_csqr_flat(csqr_crafted[k:k + 1])),
             (lambda k=k: cuda_pairing.f12_csqr_plain(
                 csqr_crafted[k:k + 1])),
             MM_F12_CSQR, 1, 2 * 768)
            for k in range(len(csqr_crafted))
        ] + [
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f12_csqr_flat(csqr_tiled),
             lambda: cuda_pairing.f12_csqr_plain(csqr_tiled), MM_F12_CSQR,
             n_proofs, 2 * nbytes(csqr_tiled))
        ],
        # the crafted rows (zero slots, limbs at p - 1, -1, mixed)
        "f12_slotmul": [
            (f"crafted N={n} ({w})",
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_flat(
                 slot_crafted[:n], w)),
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_plain(
                 slot_crafted[:n], w)),
             MM_F12_SLOTMUL, n, 2 * n * 768)
            for n in SLOTMUL_NS for w in cuda_pairing.SLOT_MAPS
        ],
        # partly filled last blocks, whole blocks (128 rows) and the edge
        # inputs (0 among them)
        "fp_inv": [
            (f"N={n}", (lambda n=n: cuda_pairing.fp_inv_flat(inv_x[:n])),
             (lambda n=n: cuda_pairing.fp_inv_plain(inv_x[:n])), MM_FP_INV,
             n, 2 * n * 64)
            for n in (1, 5, 21, 128, 129)
        ] + [
            ("edge inputs", lambda: cuda_pairing.fp_inv_flat(inv_edge),
             lambda: cuda_pairing.fp_inv_plain(inv_edge), MM_FP_INV,
             len(inv_edge), 2 * nbytes(inv_edge))
        ],
        "f12_mul": [
            (f"N={n} (a partly filled block)",
             (lambda n=n: cuda_pairing.f12_mul_flat(gt1[:n], gt2[:n])),
             (lambda n=n: cuda_pairing.f12_mul_plain(gt1[:n], gt2[:n])),
             MM_F12_MUL, n, 3 * n * 768)
            for n in (5, 21)
        ],
        "fixed_base_mul": [
            (f"W={w} N={n}",
             (lambda k=k, w=w: cuda_ops.fixed_base_mul_flat(base, k, w)),
             (lambda k=k, w=w: cuda_ops.fixed_base_mul_plain(base, k, w)),
             mm_fixed_base(k, w), n, nbytes(base[:w], k) + n * 192)
            for w in (1, 16, 17, 64) for n in (1, 90, 270, 900)
            for k in [scalars(n, w)]
        ] + [
            (f"crafted table {name}",
             (lambda t=t, k=k: cuda_ops.fixed_base_mul_flat(t, k)),
             (lambda t=t, k=k: cuda_ops.fixed_base_mul_plain(t, k)),
             0, len(k), nbytes(t, k) + len(k) * 192)
            for name, t, k in crafted_fixed_base_cases(C, F, refimpl, dev)
        ],
        "scalar_mul": [
            (f"crafted W={w}",
             (lambda w=w: cuda_ops.scalar_mul_flat(*ladder_crafted, w)),
             (lambda w=w: cuda_ops.scalar_mul_plain(*ladder_crafted, w)),
             mm_scalar_mul(ladder_crafted[1], w), len(ladder_crafted[1]),
             len(ladder_crafted[1]) * (192 + 64 + 192))
            for w in (1, 2, 16, 64)
        ] + [
            (f"W=64 N={n} (a partly filled block)",
             (lambda k=k: cuda_ops.scalar_mul_flat(a900[:len(k)], k)),
             (lambda k=k: cuda_ops.scalar_mul_plain(a900[:len(k)], k)),
             mm_scalar_mul(k, 64), n, n * (192 + 64 + 192))
            for n in (1, 5, 21) for k in [scalars(n, 64)]
        ],
        "g2_scalar_mul": [
            ("crafted", lambda: cuda_pairing.g2_scalar_mul_flat(*g2_crafted),
             lambda: cuda_pairing.g2_scalar_mul_plain(*g2_crafted),
             mm_g2_ladder(g2_crafted[1]), len(g2_crafted[1]),
             2 * nbytes(g2_crafted[0]) + nbytes(g2_crafted[1]))
        ] + [
            (f"N={n} (a partly filled block)",
             (lambda n=n: cuda_pairing.g2_scalar_mul_flat(g2_p[:n],
                                                          g2_k[:n])),
             (lambda n=n: cuda_pairing.g2_scalar_mul_plain(g2_p[:n],
                                                           g2_k[:n])),
             mm_g2_ladder(g2_k[:n]), n,
             2 * nbytes(g2_p[:n]) + nbytes(g2_k[:n]))
            for n in (1, 5, 21)
        ],
        "f12_wpow": [
            (f"crafted {nb} bits cyc={cyc}",
             (lambda nb=nb, cyc=cyc: cuda_pairing.f12_wpow_flat(
                 *wpow_crafted, nb, cyc=cyc)),
             (lambda nb=nb, cyc=cyc: cuda_pairing.f12_wpow_plain(
                 *wpow_crafted, nb, cyc)),
             mm_wpow(nb, cyc), len(wpow_crafted[0]),
             len(wpow_crafted[0]) * (2 * 768 + 64))
            for nb in WPOW_BITS for cyc in (True, False)
        ] + [
            (f"N={n} 63 bits cyc (a partly filled block)",
             (lambda n=n: cuda_pairing.f12_wpow_flat(gt_ca[:n], r_w[:n], 63,
                                                     cyc=True)),
             (lambda n=n: cuda_pairing.f12_wpow_plain(gt_ca[:n], r_w[:n], 63,
                                                      True)),
             mm_wpow(63, True), n, n * (2 * 768 + 64))
            for n in (1, 5, 21)
        ],
        # the joint check's folds (five passes each over 13,500 values
        # padded to 8^5) and its gtB^S (two passes on one power), and
        # partly filled blocks (21, 5)
        "f12_mulreduce8": [
            (f"N={n} (joint check fold or gtB^S pass)",
             (lambda n=n: cuda_pairing.f12_mulreduce8_flat(g_multi[:n])),
             (lambda n=n: cuda_pairing.f12_mulreduce8_plain(g_multi[:n])),
             7 * MM_F12_MUL, n, nbytes(g_multi[:n]) * 9 // 8)
            for n in (4096, 512, 64, 21, 8, 5, 1)
        ],
        "miller": [
            (f"N={n}",
             (lambda n=n: cuda_pairing.miller_flat(*(t[:n] for t in ml_in))),
             (lambda n=n: cuda_pairing.miller_plain(*(t[:n] for t in ml_in))),
             mm_miller(cuda_pairing.ATE_BITS), n,
             nbytes(*(t[:n] for t in ml_in)) + n * 768)
            for n in (1, 1000)
        ],
    }
    meta = {
        "fixed_base_mul": ("drynx_tpu_torch/csrc/g1_ops.cu",
                           "drynx_tpu/crypto/pallas_ops.py:338"),
        "scalar_mul": ("drynx_tpu_torch/csrc/g1_ops.cu",
                       "drynx_tpu/crypto/pallas_ops.py:231"),
        "point_reduce": ("drynx_tpu_torch/csrc/g1_ops.cu",
                         "drynx_tpu/crypto/pallas_ops.py:437"),
        "point_add": ("drynx_tpu_torch/csrc/g1_ops.cu",
                      "drynx_tpu/crypto/pallas_ops.py:429"),
        "fp_inv": ("drynx_tpu_torch/csrc/fp_inv.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:949"),
        "f2_inv": ("drynx_tpu_torch/csrc/g2_ops.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:993"),
        "g2_scalar_mul": ("drynx_tpu_torch/csrc/g2_ops.cu",
                          "drynx_tpu/crypto/pallas_pairing.py:1114"),
        "f12_mul": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:529"),
        "f12_mulreduce8": ("drynx_tpu_torch/csrc/gt_ops.cu",
                           "drynx_tpu/crypto/pallas_pairing.py:629"),
        "miller": ("drynx_tpu_torch/csrc/miller.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:313"),
        "f12_inv": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:535"),
        "f12_csqr": ("drynx_tpu_torch/csrc/gt_ops.cu",
                     "drynx_tpu/crypto/pallas_pairing.py:851"),
        "f12_slotmul": ("drynx_tpu_torch/csrc/gt_ops.cu",
                        "drynx_tpu/crypto/pallas_pairing.py:645"),
        "f12_wpow": ("drynx_tpu_torch/csrc/gt_ops.cu",
                     "drynx_tpu/crypto/pallas_pairing.py:572"),
        "f12_pow": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:541"),
    }

    # -- phase 2: every kernel against its plain version ---------------------
    imad_per_ms = SMS * IMAD_PER_CLK_SM * sm_mhz * 1e3
    summary = {}
    print("phase 2: kernels vs plain versions (byte for byte)", flush=True)
    for name, rows in cases.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, err=0)
        source = meta[name][0].rsplit("/", 1)[1][:-3]
        symbol = f"{len(name) + 7}{name}_kernel"     # as mangled
        print(f"  {name}: ptxas {ptxas_summary(reports[source], symbol)}",
              flush=True)
        n_main = len(rows)
        for j, (label, kern, plain, mm, n, moved) in enumerate(
                rows + extra.get(name, [])):
            got = kern()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = int((got.long() - want.long()).abs().max())
            if got.shape != want.shape or err != 0:
                raise SystemExit(f"{name} {label}: kernel != plain version "
                                 f"(max abs err {err})")
            ms = cuda_ms(kern, KERNEL_REPS)
            ops_ms = mm * IMAD_PER_MONT_MUL * n / imad_per_ms
            bytes_ms = moved / MEM_BYTES_PER_S * 1e3
            print(f"  {name:15s} {label:32s} ok  kernel {ms:9.4f} ms  "
                  f"plain {plain_ms:10.2f} ms  bound {max(ops_ms, bytes_ms):.6f}"
                  f" ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})"
                  + ("" if j < n_main else "  (extra shape, not summed)"),
                  flush=True)
            if j >= n_main:
                continue
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
        summary[name] = tot

    # -- phase 3: the main path, counted --------------------------------------
    fn = flagship.build_pipeline(setup, params)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, dec, found = fn(stats, enc_rs, ks_rs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"phase 3: first survey run {first_s:.3f} s; launches {launches}",
          flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise SystemExit(f"main-path launches {launches} differ from "
                         f"{EXPECTED_LAUNCHES}")

    clear = stats.sum(0).cpu()
    if dec.shape != (V,) or not torch.equal(dec.cpu().long(), clear):
        raise SystemExit("decrypted sums differ from the clear sums")
    if not bool(found.all()):
        raise SystemExit("a discrete-log lookup missed")
    # GD from the same sums on the CPU. Both run 450 float32 steps on sums
    # of up to ~1e4 (7680 records), taken in another order on the card, so
    # the weights part in the fourth digit: the tolerance is 1e-3 of the
    # largest weight
    w_cpu = lr.train(lr.unpack(dec.cpu(), params), params)
    w_err = float((w.cpu() - w_cpu).abs().max())
    w_tol = 1e-3 * max(1.0, float(w_cpu.abs().max()))
    if w.shape != (D + 1,) or not bool(torch.isfinite(w).all()) or w_err > w_tol:
        raise SystemExit(f"weights differ from CPU GD: max abs err {w_err}")
    print(f"  all {V} sums exact and found; weights {w.cpu().tolist()}; max abs"
          f" err vs CPU GD {w_err:.3g} (tolerance {w_tol:.3g})", flush=True)

    # -- phase 4: timings -------------------------------------------------------
    walls = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(stats, enc_rs, ks_rs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gd_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr.train(lr.unpack(dec, params), params)
        torch.cuda.synchronize()
        gd_s.append(time.perf_counter() - t0)
    print(f"phase 4: survey wall time median {statistics.median(walls):.4f} s "
          f"over {TIMED_RUNS} runs after warm-up (all: "
          f"{[round(x, 4) for x in walls]}); GD alone median "
          f"{statistics.median(gd_s):.4f} s", flush=True)

    # -- phase 5: proofs-on data collection, counted --------------------------
    def collect():
        gen = torch.Generator(device=dev).manual_seed(PROOF_SEED)
        cts5, lists = svc.collect_with_range_proofs(
            stats, enc_rs, ranges, {U: sigs}, coll_tbl, generator=gen)
        return cts5, lists, [lst.to_bytes() for lst in lists]

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cts5, lists, payloads = collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches5 = launch_counts()
    print(f"phase 5: first proofs-on collection ({n_vals} values, {n_proofs} "
          f"digit proofs) {first_s:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches5}", flush=True)
    if launches5 != EXPECTED_LAUNCHES_PROOFS:
        raise SystemExit(f"proofs-on launches {launches5} differ from "
                         f"{EXPECTED_LAUNCHES_PROOFS}")

    # (a) D == c C2 + Zr P + (sum_j u^j Zphi_j) B for every value
    pbs = [lst.batches[0][1] for lst in lists]
    if len(lists) != NUM_DPS or any(
            len(lst.batches) != 1 or lst.batches[0][0].tolist() != list(range(V))
            for lst in lists):
        raise SystemExit("a payload does not cover its DP's values in one batch")
    cat = lambda name: torch.cat([getattr(pb, name) for pb in pbs])
    if not torch.equal(cat("commit"), cts5.reshape(-1, 2, 3, 16)):
        raise SystemExit("the proofs commit to other ciphertexts")
    wz = rp._weighted_sum_mod_n(cat("zphi"), rp._upow_mont(U, L, dev))
    d_want = C.add(C.scalar_mul(cat("commit")[:, 1], cat("challenge")),
                   C.add(eg.fixed_base_mul(coll_tbl, cat("zr")),
                         eg.fixed_base_mul(base, wz)))
    d_ok = C.eq(d_want, cat("d"))
    if d_ok.shape != (n_vals,) or not bool(d_ok.all()):
        raise SystemExit(f"D equation fails for {int((~d_ok).sum())} values")

    # (b) every challenge, recomputed from the serialized payload bytes
    wires = [parse_payload(p)[0] for p in payloads]
    sum_y = rp.sum_publics_bytes(sigs)
    for dp, w in enumerate(wires):
        if (w["u"], w["l"]) != (U, L) or w["idx"].tolist() != list(range(V)):
            raise SystemExit(f"DP {dp}: payload header differs")
        c_host = rp.challenge_from_wire(w, sum_y, U, L)
        if not np.array_equal(enc.limbs_to_bytes(c_host), w["challenge"]):
            raise SystemExit(f"DP {dp}: a challenge does not hash its "
                             f"transcript")

    # (c) the pairing equation of sampled digit proofs, by the host oracle,
    # and (d) a changed Zv fails it
    gtb = refimpl.pair(refimpl.G1, refimpl.G2)
    t0 = time.perf_counter()
    for dp, i, val, j in CHECK_SAMPLES:
        w = wires[dp]
        args = (big(w["challenge"][val]), sigs[i].public,
                big(w["zphi"][val, j]), big(w["zv"][i, val, j]),
                w["v"][i, val, j], w["a"][i, val, j])
        if not digit_pairing_ok(refimpl, gtb, *args):
            raise SystemExit(f"pairing equation fails at DP {dp} server {i}"
                             f" value {val} digit {j}")
    dp, i, val, j = CHECK_SAMPLES[-1]
    w = wires[dp]
    bad_zv = (big(w["zv"][i, val, j]) + 1) % refimpl.N
    if digit_pairing_ok(refimpl, gtb, big(w["challenge"][val]),
                        sigs[i].public, big(w["zphi"][val, j]), bad_zv,
                        w["v"][i, val, j], w["a"][i, val, j]):
        raise SystemExit("the pairing check accepts a tampered Zv")
    print(f"  (a) D equation holds for all {n_vals} values; (b) all "
          f"{n_vals} challenges recomputed from the payload bytes; (c) "
          f"pairing equation holds for {len(CHECK_SAMPLES)} sampled digit "
          f"proofs (DPs 0 and {NUM_DPS - 1}, all {N_SERVERS} servers, last "
          f"value and digit); (d) a tampered Zv fails it "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)

    # timings: whole collections, then the same work stage by stage (the
    # same generator seed, so the same bytes)
    def staged():
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        gen = torch.Generator(device=dev).manual_seed(PROOF_SEED)
        shifted = stats.to(torch.int64) + U ** L // 2
        cts_s = eg.encrypt_ints_with_tables(base, coll_tbl, shifted, enc_rs)
        mark()
        ctf = cts_s.reshape(-1, 2, 3, 16)
        dig = torch.from_numpy(rp.to_base(shifted.reshape(-1).cpu().numpy(),
                                          U, L)).to(dev, torch.int64)
        s_, t_, m_, v_ = [eg.random_scalars(shape, gen, dev) for shape in
                          [(n_vals, L)] * 3 + [(N_SERVERS, n_vals, L)]]
        d5, m_tot, v_pts, a5 = rp._commit_kernel(
            dig, s_, t_, m_, v_, A_tab, coll_tbl,
            rp.sig_gt_pow_tables(sigs, dev), U, L)
        mark()
        wire = rp._range_wire_dict(ctf, d5, v_pts, a5)
        c5 = rp.challenge_from_wire(wire, sum_y, U, L).to(dev)
        mark()
        zphi, zr, zv = rp._response_kernel(dig, c5, enc_rs.reshape(-1, 16),
                                           s_, t_, m_tot, v_)
        whole = rp.RangeProofBatch(ctf, c5, zr, d5, zphi, zv, v_pts, a5, U,
                                   L, wire)
        out = [rp.RangeProofList(V, [(np.arange(V), rp._slice_batch(
            whole, np.arange(dp * V, (dp + 1) * V)))]).to_bytes()
            for dp in range(NUM_DPS)]
        mark()
        if out != payloads:
            raise SystemExit("the staged run's payloads differ")
        return np.diff(marks)

    walls5 = []
    for _ in range(PROOF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, again = collect()
        torch.cuda.synchronize()
        walls5.append(time.perf_counter() - t0)
        if again != payloads:
            raise SystemExit("a warm collection's payloads differ")
    split = np.median([staged() for _ in range(PROOF_RUNS)], axis=0)
    print(f"phase 5: proofs-on collection wall time median "
          f"{statistics.median(walls5):.4f} s over {PROOF_RUNS} warm runs "
          f"(all: {[round(x, 4) for x in walls5]}); staged split, median of "
          f"{PROOF_RUNS}: encryption {split[0]:.4f} s, commit kernels "
          f"{split[1]:.4f} s, wire encoding + hash {split[2]:.4f} s, "
          f"response + payloads {split[3]:.4f} s", flush=True)

    # -- phase 6: the verifying node's joint check, counted ------------------
    def verify(datas):
        return svc.verify_collected_range_proofs(datas, ranges, {U: sigs},
                                                 coll_tbl)

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok6 = verify(payloads)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches6 = launch_counts()
    print(f"phase 6: first joint check of the {NUM_DPS} payloads ({n_proofs} "
          f"digit proofs) {first_s:.3f} s; verdicts {ok6}; launches "
          f"{launches6}", flush=True)
    if ok6 != [True] * NUM_DPS:
        raise SystemExit(f"the joint check rejects honest payloads: {ok6}")
    if launches6 != EXPECTED_LAUNCHES_VERIFY:
        raise SystemExit(f"verification launches {launches6} differ from "
                         f"{EXPECTED_LAUNCHES_VERIFY}")

    bad = list(payloads)
    bad[TAMPER_DP] = tamper_zv(payloads[TAMPER_DP])
    ok_bad = verify(bad)
    if ok_bad != [dp != TAMPER_DP for dp in range(NUM_DPS)]:
        raise SystemExit(f"with DP {TAMPER_DP}'s Zv changed the joint check "
                         f"gives {ok_bad}")

    def decode(datas):
        return rp._concat_batches([rp.RangeProofList.from_bytes(b, dev)
                                   .batches[0][1] for b in datas])

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok_v = rp.verify_range_proofs(decode(payloads), pubs, coll_tbl)
    torch.cuda.synchronize()
    per_value_s = time.perf_counter() - t0
    launches_pv = launch_counts()
    if ok_v.shape != (n_vals,) or not ok_v.all():
        raise SystemExit(f"the per-value check rejects {int((~ok_v).sum())} "
                         f"honest values")
    if launches_pv != EXPECTED_LAUNCHES_PER_VALUE:
        raise SystemExit(f"per-value launches {launches_pv} differ from "
                         f"{EXPECTED_LAUNCHES_PER_VALUE}")
    ok_vb = rp.verify_range_proofs(decode(bad), pubs, coll_tbl)
    want_vb = np.arange(n_vals) != TAMPER_DP * V
    if not np.array_equal(ok_vb, want_vb):
        raise SystemExit("the per-value check of the tampered bytes rejects "
                         f"values {np.nonzero(~ok_vb)[0].tolist()}, not "
                         f"[{TAMPER_DP * V}]")
    print(f"  DP {TAMPER_DP} with one Zv byte changed: joint verdicts {ok_bad};"
          f" per-value check: all {n_vals} honest values accepted "
          f"({per_value_s:.3f} s, {n_proofs} pairings), on the tampered bytes"
          f" only value {TAMPER_DP * V} rejected; per-value launches "
          f"{launches_pv}", flush=True)

    def staged_verify():
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        pb = decode(payloads)
        mark()
        pre_ok, r_int, gtb_s = rp.rlc_prelude(pb, pubs, coll_tbl)
        mark()
        r = eg.int_to_scalar(torch.from_numpy(r_int).to(dev))
        px, py, _ = C.normalize(C.scalar_mul_short(rp._g1_args(pb, pubs), r,
                                                   64))
        qx, qy, _ = G2.normalize(pb.v_pts)
        mark()
        m = GT.miller(px, py, qx, qy)
        mark()
        ar = GT.gt_pow64(F12.conj6(pb.a), r)
        mark()
        fe = cuda_pairing.final_exp_flat(
            GT.gt_reduce_prod(m.reshape(-1, 6, 2, 16))[None])
        pa = GT.gt_reduce_prod(ar.reshape(-1, 6, 2, 16))
        total = GT.gt_mul(GT.gt_mul(fe, pa[None]), gtb_s[None])[0]
        mark()
        if not pre_ok or not bool(F12.eq(total, F12.one((), dev))):
            raise SystemExit("the staged joint check rejects")
        return np.diff(marks)

    walls6 = []
    for _ in range(PROOF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = verify(payloads)
        torch.cuda.synchronize()
        walls6.append(time.perf_counter() - t0)
        if again != [True] * NUM_DPS:
            raise SystemExit(f"a warm joint check gives {again}")
    split6 = np.median([staged_verify() for _ in range(PROOF_RUNS)], axis=0)
    print(f"phase 6: joint check wall time median "
          f"{statistics.median(walls6):.4f} s over {PROOF_RUNS} warm runs "
          f"(all: {[round(x, 4) for x in walls6]}); staged split, median of "
          f"{PROOF_RUNS}: decode {split6[0]:.4f} s, prelude (D equation, "
          f"challenges, GPhi12 and order gates, gtB^S) {split6[1]:.4f} s, G1 "
          f"weighting + normalize {split6[2]:.4f} s, Miller {split6[3]:.4f} s,"
          f" a^r {split6[4]:.4f} s, reductions + final exp {split6[5]:.4f} s;"
          f" peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # -- phase 7: the proofs-on LocalCluster survey, counted -----------------
    launches7, walls7 = phase7(stats, X, y, params, zero_launches,
                               launch_counts)

    kernels = []
    for name, tot in summary.items():
        source, replaces = meta[name]
        ops_ms, bytes_ms = tot["ops_ms"], tot["bytes_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches[name] + launches5[name] + launches6[name]
                         + launches_pv[name] + launches7[name]),
            "max_abs_err": tot["err"], "ms": round(tot["ms"], 6),
            "plain_ms": round(tot["plain_ms"], 3),
            "bound_ms": round(max(ops_ms, bytes_ms), 6),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    print("(ms, plain_ms, bound_ms: summed over the kernel's main-path shapes "
          "above, one launch each; launches: the survey's, the proofs-on "
          "collection's, the joint check's, the per-value check's and the "
          "proofs-on cluster survey's)")
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
