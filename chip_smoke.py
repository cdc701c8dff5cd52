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
  4. Print the survey's wall time (median of timed runs after a warm-up),
     the kernels' times, launch counts and bounds as one JSON line, the
     card's name and power limit, and last the contract line
     {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the drynx_tpu package.
"""
import json
import statistics
import subprocess
import sys
import time

import torch

# Pima width of the reference's exec benchmark (bench.py:bench_exec)
NUM_DPS, N_SERVERS, N_RECORDS, D, ITERS, DLOG_LIMIT = 10, 3, 768, 8, 450, 10000
TIMED_RUNS = 5
KERNEL_REPS = 10
# launches of one survey: encrypt rB, |m|B, rP and key switch rB, rQ;
# key switch xK and decrypt; aggregate and the two key-switch sums;
# encrypt, key switch and its finish, decrypt; one normalize
EXPECTED_LAUNCHES = {"fixed_base_mul": 5, "scalar_mul": 2, "point_reduce": 3,
                     "point_add": 4, "fp_inv": 1}

# H100 SXM: 132 SMs, 64 32-bit integer multiply-adds per SM per clock,
# 3.35 TB/s device memory (NVIDIA data sheet and Hopper white paper)
SMS, IMAD_PER_CLK_SM, MEM_BYTES_PER_S = 132, 64, 3.35e12
# 32-bit multiply-adds in one 8-word CIOS Montgomery product
IMAD_PER_MONT_MUL = 256
# Montgomery products per element (counted from the algorithms)
MM_PADD = 23          # complete add: 16 for the add, 7 for the double


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from drynx_tpu_torch import flagship
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.utils import cuda_build

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
    for counts in (cuda_ops.LAUNCHES, cuda_pairing.LAUNCHES):
        for key in counts:
            counts[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, dec, found = fn(stats, enc_rs, ks_rs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
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

    kernels = []
    for name, tot in summary.items():
        source, replaces = meta[name]
        ops_ms, bytes_ms = tot["ops_ms"], tot["bytes_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": tot["err"], "ms": round(tot["ms"], 6),
            "plain_ms": round(tot["plain_ms"], 3),
            "bound_ms": round(max(ops_ms, bytes_ms), 6),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    print("(ms, plain_ms, bound_ms: summed over the kernel's main-path shapes "
          "above, one launch each)")
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
