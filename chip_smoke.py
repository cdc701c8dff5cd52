#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):
  1. Print the card's name and power limit; build every CUDA source of
     drynx_tpu_torch/csrc with nvcc (one process each, in parallel) and
     print the ptxas lines (registers, stack, spills).
  2. Run each kernel at the shapes of the main path on the card and hold
     its output against its plain PyTorch version on the same inputs, byte
     for byte; time both with CUDA events.
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
     audit block of 3 VNs x 16 proofs, every entry BM_TRUE; all 90
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
import json
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

# H100 SXM: 132 SMs, 64 32-bit integer multiply-adds per SM per clock,
# 3.35 TB/s device memory (NVIDIA data sheet and Hopper white paper)
SMS, IMAD_PER_CLK_SM, MEM_BYTES_PER_S = 132, 64, 3.35e12
# 32-bit multiply-adds in one 8-word CIOS Montgomery product
IMAD_PER_MONT_MUL = 256
# Montgomery products per element (counted from the algorithms)
MM_PADD = 23          # complete add: 16 for the add, 7 for the double
# G2 over Fp2 (3 products per Fp2 product, 2 per square): a double is
# 5 squares + 2 products = 16, a complete add 5 squares + 11 products + a
# double = 59; the ladder builds 7 doubles and 7 adds, then 63 windows of
# 4 doubles and an add
MM_G2_LADDER = 7 * 16 + 7 * 59 + 63 * (4 * 16 + 59)
MM_F2_INV = 2 + 255 + 124 + 2   # norm, Fermat over p - 2, two products
MM_F12_MUL = 18 * 3             # 18 Fp2 products
MM_F12_SQR = 12 * 3             # complex method: 12 Fp2 products
MM_F12_CSQR = 9 * 2             # Granger-Scott: 9 Fp2 squares
MM_F12_SLOTMUL = 6 * 3          # 6 Fp2 products by constants
# the tower inverse: the norm (2 Fp6 products = 36), the Fp6 adjugate (3
# squares, 6 products = 24), the Fp2 inverse (383) and 3 products (9), then
# 2 Fp6 products (36)
MM_F12_INV = 36 + 24 + MM_F2_INV + 9 + 36


def mm_miller(ate_bits):
    """Montgomery products of one Miller loop over the bits of 6u + 2 below
    its leading one: a double step per bit (a square, 5 products, 2 by an
    Fp element, 5 more squares = 31; the Fp12 square 36; the line product
    54), an add step where the bit is set and for each of the 2 Frobenius
    corrections (4 squares, 10 products, 2 by an Fp element = 42; the line
    product 54). The kernel computes the add step at every bit and keeps it
    by mask; the bits are public, so the bound counts only the adds kept."""
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
    print(f"phase 7: first proofs-on cluster survey {first_s:.3f} s; "
          f"launches {launches7}", flush=True)
    if launches7 != EXPECTED_LAUNCHES_CLUSTER:
        raise SystemExit(f"cluster survey launches {launches7} differ from "
                         f"{EXPECTED_LAUNCHES_CLUSTER}")
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
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import gt as GT
    from drynx_tpu_torch.crypto import refimpl
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.proofs import encoding as enc
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.service import service as svc
    from drynx_tpu_torch.utils import cuda_build

    def zero_launches():
        for counts in (cuda_ops.LAUNCHES, cuda_pairing.LAUNCHES):
            for key in counts:
                counts[key] = 0

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

    K = NUM_DPS * V
    cases = {
        # kernel: list of (label, wrapper call, plain call, mont muls/elem,
        #                  elements, bytes moved)
        "fixed_base_mul": [
            (f"W=64 N={K} (rB)", lambda: cuda_ops.fixed_base_mul_flat(
                base, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, enc_rs.reshape(-1, 16)),
             MM_PADD * 64, K, nbytes(base, enc_rs) + K * 192),
            (f"W=16 N={K} (|m|B)", lambda: cuda_ops.fixed_base_mul_flat(
                base, mag, 16),
             lambda: cuda_ops.fixed_base_mul_plain(base, mag, 16),
             MM_PADD * 16, K, nbytes(base[:16], mag) + K * 192),
            (f"W=64 N={K} (rP)", lambda: cuda_ops.fixed_base_mul_flat(
                setup.coll_pub_table, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.coll_pub_table,
                                                   enc_rs.reshape(-1, 16)),
             MM_PADD * 64, K, nbytes(base, enc_rs) + K * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rB)",
             lambda: cuda_ops.fixed_base_mul_flat(base, ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, ks_rs.reshape(-1, 16)),
             MM_PADD * 64, N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rQ)",
             lambda: cuda_ops.fixed_base_mul_flat(setup.query_pub_table,
                                                  ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.query_pub_table,
                                                   ks_rs.reshape(-1, 16)),
             MM_PADD * 64, N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
        ],
        "scalar_mul": [
            (f"W=64 N={N_SERVERS * V} (key switch xK)",
             lambda: cuda_ops.scalar_mul_flat(pts_sv, secrets.reshape(-1, 16)),
             lambda: cuda_ops.scalar_mul_plain(pts_sv, secrets.reshape(-1, 16)),
             210 + 63 * (4 * 7 + MM_PADD), N_SERVERS * V,
             N_SERVERS * V * (192 + 64 + 192)),
            (f"W=64 N={V} (decrypt)",
             lambda: cuda_ops.scalar_mul_flat(pts_v, qx.contiguous()),
             lambda: cuda_ops.scalar_mul_plain(pts_v, qx.contiguous()),
             210 + 63 * (4 * 7 + MM_PADD), V, V * (192 + 64 + 192)),
        ],
        "point_reduce": [
            (f"R={NUM_DPS} N={2 * V} (aggregate)",
             lambda: cuda_ops.point_reduce_flat(cts.reshape(NUM_DPS, -1, 3, 16)),
             lambda: cuda_ops.point_reduce_plain(cts.reshape(NUM_DPS, -1, 3, 16)),
             MM_PADD * (NUM_DPS - 1), 2 * V, (NUM_DPS + 1) * 2 * V * 192),
            (f"R={N_SERVERS} N={V} (key switch K sum)",
             lambda: cuda_ops.point_reduce_flat(cts[:N_SERVERS, :, 0]),
             lambda: cuda_ops.point_reduce_plain(cts[:N_SERVERS, :, 0]),
             MM_PADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
            (f"R={N_SERVERS} N={V} (key switch C sum)",
             lambda: cuda_ops.point_reduce_flat(cts[:N_SERVERS, :, 1]),
             lambda: cuda_ops.point_reduce_plain(cts[:N_SERVERS, :, 1]),
             MM_PADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
        ],
        "point_add": [
            (f"N={n} ({what})",
             (lambda n=n: cuda_ops.point_add_flat(a900[:n], b900[:n])),
             (lambda n=n: cuda_ops.point_add_plain(a900[:n], b900[:n])),
             MM_PADD, n, 3 * n * 192)
            for n, what in ((K, "encrypt mB + rP"),
                            (N_SERVERS * V, "key switch rQ - xK"),
                            (V, "key switch finish"), (V, "decrypt C - xK"))
        ],
        "fp_inv": [
            (f"N={V} (normalize)", lambda: cuda_pairing.fp_inv_flat(zs),
             lambda: cuda_pairing.fp_inv_plain(zs), 255 + 124, V, 2 * V * 64),
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
             MM_G2_LADDER, n_proofs, 2 * nbytes(g2_p) + nbytes(g2_k)),
        ],
        "f12_mul": [
            (f"N={n_proofs} (a = gt1 gt2)",
             lambda: cuda_pairing.f12_mul_flat(gt1, gt2),
             lambda: cuda_pairing.f12_mul_plain(gt1, gt2), MM_F12_MUL,
             n_proofs, 3 * nbytes(gt1)),
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
        "f12_inv": [
            (f"N={n_proofs} (per-value final exp)",
             lambda: cuda_pairing.f12_inv_flat(ml_out),
             lambda: cuda_pairing.f12_inv_plain(ml_out), MM_F12_INV,
             n_proofs, 2 * f12_bytes),
        ],
        "f12_csqr": [
            (f"N={n_proofs} (per-value final exp)",
             lambda: cuda_pairing.f12_csqr_flat(gt_a),
             lambda: cuda_pairing.f12_csqr_plain(gt_a), MM_F12_CSQR,
             n_proofs, 2 * f12_bytes),
        ],
        "f12_slotmul": [
            (f"N={n_proofs} ({w})",
             (lambda w=w: cuda_pairing.f12_slotmul_flat(gt_a, w)),
             (lambda w=w: cuda_pairing.f12_slotmul_plain(gt_a, w)),
             MM_F12_SLOTMUL, n_proofs, 2 * f12_bytes)
            for w in cuda_pairing.SLOT_MAPS
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
        for label, kern, plain, mm, n, moved in rows:
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
                  f" ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})",
                  flush=True)
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
