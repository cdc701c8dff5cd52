#!/usr/bin/env python3
"""Time versions of the port's two team kernels side by side on one card.

    python3 scripts/torch_team_variants.py

Each variant is the package's csrc/miller.cu or csrc/g1_ops.cu with one
line changed by an exact text edit: the fixed-base team size
kFixedBaseTeam (16, 32, 64), or, for the Miller loop, its Fp2 product
inlined, two warps a block, or its registers capped. `cuda_build` builds
them all at once with the package's flags. Every variant is checked
against the package's plain versions before it is timed: the Miller loop
byte for byte against `miller_plain`, the fixed-base ladder as points
(another team size sums in another order, so its Jacobian representative
differs). Times are CUDA-event means at the main path's shapes: the Miller
loop at 13,500 pairings, the fixed-base ladder at W = 64 with 900 and 270
rows and at W = 16 with 900 rows. Prints one JSON line per variant with
its ptxas registers, stack and spills, then the card's name and power
limit. The package keeps one kernel per function; PERF.md records the
readings and the choice.

It imports nothing of JAX and nothing of the drynx_tpu package. Without a
card it exits with code 2.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 20
MILLER_N = 13_500
TEAM = "constexpr int kFixedBaseTeam = 32;"
FIXED_BASE_SHAPES = (("W=64 N=900", 900, 64), ("W=64 N=270", 270, 64),
                     ("W=16 N=900", 900, 16))

# (label, source, (old, new) edit or None)
VARIANTS = [
    ("miller", "miller", None),
    ("miller, mul2 inlined", "miller",
     ("static __device__ __noinline__ Fp2 mul2",
      "static __device__ __forceinline__ Fp2 mul2")),
    ("miller, 2 warps a block", "miller",
     ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")),
    ("miller, at most 168 registers", "miller",
     ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")),
    ("miller, at most 128 registers", "miller",
     ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")),
] + [(f"fixed_base G={g}", "g1_ops",
      (TEAM, f"constexpr int kFixedBaseTeam = {g};")) for g in (16, 32, 64)]


def edited(source, edit, cuda_build):
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    if edit is None:
        return text
    old, new = edit
    if text.count(old) != 1:
        raise SystemExit(f"csrc/{source}.cu holds {old!r} "
                         f"{text.count(old)} times, not once")
    return text.replace(old, new)


def timed(fn):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def main():
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from chip_smoke import ptxas_summary
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import params, refimpl
    from drynx_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = cuda_build.build_copies(
        [(source, edited(source, edit, cuda_build))
         for _, source, edit in VARIANTS])

    rng = np.random.default_rng(11)
    rand = lambda n, bits: F.from_int(
        [int.from_bytes(rng.bytes(32), "little") % min(params.N, 1 << bits)
         for _ in range(n)]).to(dev)
    base = eg.BASE_TABLE.table.to(dev)
    # Miller inputs: affine multiples of the generators, made on the card
    px, py, _ = C.normalize(cuda_ops.fixed_base_mul_flat(
        base, rand(MILLER_N, 256)))
    g2_gen = G2.from_ref(refimpl.G2).to(dev).expand(
        MILLER_N, 3, 2, 16).contiguous()
    qx, qy, _ = G2.normalize(cuda_pairing.g2_scalar_mul_flat(
        g2_gen, rand(MILLER_N, 256)))
    p2 = torch.stack([px, py], dim=1).contiguous()
    q2 = torch.stack([qx, qy], dim=1).contiguous()
    miller_want = cuda_pairing.miller_plain(px[:1000], py[:1000], qx[:1000],
                                            qy[:1000])
    fixed = []
    for label, n, w in FIXED_BASE_SHAPES:
        k = rand(n, 4 * w)
        want = C.normalize(cuda_ops.fixed_base_mul_plain(base, k, w))
        fixed.append((label, k, w, want))
    stream = lambda: torch.cuda.current_stream().cuda_stream

    for (name, source, _), (lib, log) in zip(VARIANTS, libs):
        row = {"variant": name}
        if source == "miller":
            row["ptxas"] = ptxas_summary(log, "miller_kernel")
            out = torch.empty((MILLER_N, 6, 2, 16), dtype=torch.int32,
                              device=dev)
            run = lambda: cuda_build.check(
                lib.miller(p2.data_ptr(), q2.data_ptr(), out.data_ptr(),
                           MILLER_N, stream()), name)
            run()
            torch.cuda.synchronize()
            if not torch.equal(out[:1000], miller_want):
                raise SystemExit(f"{name}: differs from miller_plain")
            row["ms N=13500"] = timed(run)
        else:
            row["ptxas"] = ptxas_summary(log, "fixed_base_mul_kernel")
            for label, k, w, want in fixed:
                out = torch.empty((len(k), 3, 16), dtype=torch.int32,
                                  device=dev)
                run = lambda k=k, w=w, out=out: cuda_build.check(
                    lib.g1_fixed_base_mul(base.data_ptr(), k.data_ptr(),
                                          out.data_ptr(), len(k), w,
                                          stream()), name)
                run()
                torch.cuda.synchronize()
                got = C.normalize(out)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name} {label}: another point than "
                                     "the plain version's")
                row[f"ms {label}"] = timed(run)
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
