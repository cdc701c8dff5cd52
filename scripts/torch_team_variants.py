#!/usr/bin/env python3
"""Time versions of the port's team kernels side by side on one card.

    python3 scripts/torch_team_variants.py

Each variant is one of the package's sources with one line changed by an
exact text edit: the fixed-base team size kFixedBaseTeam (16, 32, 64) in
csrc/g1_ops.cu; for the Miller loop (csrc/miller.cu) two warps a block or
its registers capped; the variable-base ladder's team size kLadderTeam (4,
6, 8) in csrc/g1_ops.cu; the G2 ladder's kG2LadderTeam (4, 6, 8), or its
registers capped at 168, in csrc/g2_ops.cu; the windowed GT power's team
size kPowTeam (6 lanes with one Fp2 slot each, or 3 with two) and the
product teams' kProdTeam (6 or 3), which the 8-way product and the Fp12
product share, the 8-way product's register cap kProdWarpsPerSM (168
registers, none, or 128) and the Fp12 product's (none, or 168) in
csrc/gt_ops.cu; the Fp inverse's block size kThreads (32, 64, 128) in
csrc/fp_inv.cu; the reduce's team size kReduceTeam (4, 8) in
csrc/g1_ops.cu, or its summands staged in shared memory by lane 0 where
every lane loads them itself; the batched add's team size, the same
kReduceTeam (1, one thread a row, 4, 8: the add is the reduce's body at R =
2); the slot map's kSlotmulSlots in csrc/gt_ops.cu (1, one thread a slot,
or 6, one thread a row); the Fp12 inverse's kInvTeam in csrc/gt_ops.cu (1,
one thread a row, 2, 3 or 6) and its register cap (none, 168 or 128 at 6
lanes); the Fp2 inverse's block size kF2InvThreads (32, 64, 128) in
csrc/g2_ops.cu; the cyclotomic square's team, the windowed power's
kPowTeam (6 lanes, or 3 with two slots each: the two kernels share it);
the Fp12 power's bit in csrc/gt_ops.cu (its product and square in one
exchange round, or as two team products one after the other), its
registers capped at 168, or its team, kPowTeam, at 3 lanes.
`cuda_build` builds them all at once with the package's flags. Every
variant is checked against the package's plain versions before it is timed:
the Miller loop, the ladders, the power, the products, the inverses, the
reduce, the add and the slot map byte for byte against `miller_plain`,
`scalar_mul_plain`, `g2_scalar_mul_plain`, `f12_wpow_plain`,
`f12_mulreduce8_plain`, `f12_mul_plain`, `fp_inv_plain`,
`point_reduce_plain` (on chip_smoke.crafted_reduce_cases too),
`point_add_plain` (on the crafted reduce's R = 2 pairs too),
`f12_slotmul_plain` (on chip_smoke.crafted_slotmul_cases too),
`f12_inv_plain` (on chip_smoke.crafted_inv_cases too), `f2_inv_plain` (on
chip_smoke.crafted_f2_inv_cases too), `f12_csqr_plain` (on
chip_smoke.crafted_csqr_cases too) and `f12_pow_plain` (on
chip_smoke.crafted_pow_cases at each of chip_smoke.POW_BITS), the fixed-base
ladder as points (another team size sums in another order, so its Jacobian
representative differs). Times are CUDA-event means at the main path's
shapes: the Miller loop at 13,500 pairings; the fixed-base ladder at W = 64
with 900 and 270 rows and at W = 16 with 900 rows; the variable-base ladder
at W = 64 with 90, 270 and 2,700 rows and at W = 16 with 13,500; the G2
ladder at 13,500 rows; the power with cyclotomic squares at 63 bits on 1
row (the final exponentiation's power by u) and at 63 and 128 bits on
13,500; the 8-way product at the collection's 108,000, 36,000, 13,500 and
4,500 rows and the joint check's 4,096, 512, 64, 8 and 1, and in the same
builds the Fp12 product at 1 and 13,500 rows; the Fp inverse, the reduce
and the slot maps at the cluster survey's shapes (chip_smoke.CLUSTER_ROWS:
the reduce at R = 10 over 180 columns and R = 3 over 90, each slot map at 1
and 13,500 rows), the add at its cluster shapes (90, 270, 810, 900, 13,500
rows), the Fp12 inverse on Miller outputs at 1 and 13,500 rows, the Fp2
inverse on 13,500 G2 Z coordinates, the cyclotomic square on GPhi12
members at 1 and 13,500 rows and the Fp12 power on them at 48 and 256
bits on 13,500 rows (chip_smoke.py phase 2's shapes) and at 256 bits on
one. Variants are called through their C entry
points, without the package's wrappers; the reduce's, the add's, the slot
map's, the inverses' and the square's are also timed from a CUDA graph of
the same calls ("graph ms": the kernel's own device
time, without the host's launch path). Prints one JSON line per variant
with its ptxas registers, stack and spills, then the card's name and power
limit. The package keeps one kernel per function; PERF.md records the
readings and the choice.

    python3 scripts/torch_team_variants.py --kinds fp_inv,prod

builds and times only the variants of the kinds named (miller,
fixed_base, ladder, wpow, g2, prod, fp_inv, reduce, slotmul, add,
f12inv, f2inv, csqr, pow), for a change that touches only those kernels.

    python3 scripts/torch_team_variants.py --against OTHER_ROOT

times this checkout's variable-base ladder, G2 ladder, windowed GT power,
8-way product, Fp12 product, Fp inverse, reduce, slot maps, add, Fp12
inverse, Fp2 inverse, cyclotomic square and Fp12 power against another
checkout's
instead (for instance a parent commit unpacked with `git archive` under
build/, which .gitignore lists). Each tree runs in a process of its own
(the two packages share a name), in the order this, other, other, this;
each builds its kernels with its own `cuda_build`, makes the same inputs
from one seed, checks its kernels against its plain versions on the first
rows and times the main path's shapes: the ladder at W = 64 on 90, 270,
900, 1,080 and 2,700 rows and at W = 16 on 13,500, the G2 ladder on
13,500, the power at 63 bits on 1 row and at 63 and 128 bits on 13,500,
the 8-way product at the nine shapes above, the Fp12 product at 1 and
13,500 rows, the Fp inverse, the reduce and the four slot maps at the
cluster survey's shapes, the add at its cluster shapes, the Fp12 inverse
and the cyclotomic square at 1 and 13,500 rows, the Fp2 inverse at
13,500 and the Fp12 power at 48 and 256 bits on 13,500 and at 256 on
one row, all through the package's wrappers (the add, the inverses and the
square also from a CUDA graph of the wrapper's calls).
Prints one JSON line per run with each shape's time and a digest of each
output (the two trees must agree), then the card's name and power
limit.

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

from chip_smoke import CLUSTER_ROWS  # noqa: E402  (numpy and torch only)

REPS = 20
MILLER_N = 13_500
TEAM = "constexpr int kFixedBaseTeam = 32;"
LADDER_TEAM = "constexpr int kLadderTeam = 4;"
POW_TEAM = "constexpr int kPowTeam = 6;"
G2_TEAM = "constexpr int kG2LadderTeam = 8;"
PROD_TEAM = "constexpr int kProdTeam = 6;"
PROD_CAP = "constexpr int kProdWarpsPerSM = 12;"
INV_BLOCK = "constexpr int kThreads = 32;"
REDUCE_TEAM = "constexpr int kReduceTeam = 8;"
REDUCE_LOAD = "    const G1 q = load_g1_v(rows(j, i));\n"
# lane 0 loads each summand into shared memory and the team reads it there;
# the buffer is written again only after the add's exchanges, which every
# lane passes after its read
REDUCE_STAGED = (
    "    __shared__ G1 staged[kReduceTeamsPerWarp];\n"
    "    if (slot == 0) staged[team] = load_g1_v(rows(j, i));\n"
    "    __syncwarp(tm.mask);\n"
    "    const G1 q = staged[team];\n")
INV_TEAM = "constexpr int kInvTeam = 6;"
F2_INV_BLOCK = "constexpr int kF2InvThreads = 32;"
SLOT_THREADS = "constexpr int kSlotmulSlots = 1;"
# the Fp12 power's bit as one round of two products, or as two rounds of
# one product each
POW_ROUND = "    team_f12muls<2>(tm, r, v, b, 2u);\n"
POW_TWO_ROUNDS = ("    team_f12mul(tm, r[0], v[0], &v[1]);\n"
                  "    team_f12mul(tm, r[1], v[1], nullptr);\n")
FIXED_BASE_SHAPES = (("W=64 N=900", 900, 64), ("W=64 N=270", 270, 64),
                     ("W=16 N=900", 900, 16))
LADDER_SHAPES = (("W=64 N=90", 90, 64), ("W=64 N=270", 270, 64),
                 ("W=64 N=2700", 2700, 64), ("W=16 N=13500", 13_500, 16))
POW_SHAPES = (("63 bits N=1", 1, 63), ("63 bits N=13500", 13_500, 63),
              ("128 bits N=13500", 13_500, 128))
G2_N = 13_500
PROD_SHAPES = (108_000, 36_000, 13_500, 4_500, 4_096, 512, 64, 8, 1)
MUL_SHAPES = (1, 13_500)
INV_SHAPES = tuple(sorted(CLUSTER_ROWS["fp_inv"]))
REDUCE_SHAPES = tuple(sorted(CLUSTER_ROWS["point_reduce"]))   # (R, N)
SLOT_SHAPES = tuple(sorted(CLUSTER_ROWS["f12_slotmul"]))
# the batched add's cluster launches (90 x 3, 270 x 3, 810, 900 x 4,
# 13,500) and the Fp12 inverse's (the final exponentiation's N = 1; the
# per-value check's 13,500)
ADD_SHAPES = (90, 270, 810, 900, 13_500)
F12_INV_SHAPES = (1, 13_500)
# the Fp2 inverse's (the normalizations of V, 13,500 x 2) and the
# cyclotomic square's (the final exponentiation's N = 1 x 4; the per-value
# check's 13,500)
F2_INV_SHAPES = tuple(sorted(CLUSTER_ROWS["f2_inv"]))
CSQR_SHAPES = (1, 13_500)
# the Fp12 power's (n_bits, rows): chip_smoke.py phase 2's, and one row,
# where a row's chain alone sets the time
F12_POW_SHAPES = ((48, 13_500), (256, 13_500), (256, 1))

# (label, kind, source, (old, new) edit or None)
VARIANTS = [
    ("miller", "miller", "miller", None),
    ("miller, 2 warps a block", "miller", "miller",
     ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")),
    ("miller, at most 168 registers", "miller", "miller",
     ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")),
    ("miller, at most 128 registers", "miller", "miller",
     ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")),
] + [(f"fixed_base G={g}", "fixed_base", "g1_ops",
      (TEAM, f"constexpr int kFixedBaseTeam = {g};")) for g in (16, 32, 64)
     ] + [(f"scalar_mul lanes={g}", "ladder", "g1_ops",
           (LADDER_TEAM, f"constexpr int kLadderTeam = {g};"))
          for g in (4, 6, 8)
     ] + [(f"f12_wpow lanes={g}", "wpow", "gt_ops",
           (POW_TEAM, f"constexpr int kPowTeam = {g};")) for g in (6, 3)
     ] + [(f"g2_scalar_mul lanes={g}", "g2", "g2_ops",
           (G2_TEAM, f"constexpr int kG2LadderTeam = {g};"))
          for g in (4, 6, 8)
     ] + [("g2_scalar_mul, at most 168 registers", "g2", "g2_ops",
           ("__launch_bounds__(32)\n    g2_scalar_mul_kernel",
            "__launch_bounds__(32, 12)\n    g2_scalar_mul_kernel"))
     ] + [(f"products lanes={g}", "prod", "gt_ops",
           (PROD_TEAM, f"constexpr int kProdTeam = {g};")) for g in (6, 3)
     ] + [(f"products, {what}", "prod", "gt_ops",
           (PROD_CAP, f"constexpr int kProdWarpsPerSM = {w};"))
          for what, w in (("registers not capped", 1),
                          ("at most 128 registers", 16))
     ] + [("products, f12_mul at most 168 registers", "prod", "gt_ops",
           ("__launch_bounds__(32)\n    f12_mul_kernel",
            "__launch_bounds__(32, kProdWarpsPerSM)\n    f12_mul_kernel"))
     ] + [(f"fp_inv {t} threads a block", "fp_inv", "fp_inv",
           (INV_BLOCK, f"constexpr int kThreads = {t};"))
          for t in (32, 64, 128)
     ] + [(f"point_reduce lanes={g}", "reduce", "g1_ops",
           (REDUCE_TEAM, f"constexpr int kReduceTeam = {g};"))
          for g in (4, 8)
     ] + [("point_reduce, summands staged by lane 0", "reduce", "g1_ops",
           (REDUCE_LOAD, REDUCE_STAGED))
     ] + [(f"f12_slotmul {k} slots a thread", "slotmul", "gt_ops",
           (SLOT_THREADS, f"constexpr int kSlotmulSlots = {k};"))
          for k in (1, 6)
     ] + [(f"point_add lanes={g}", "add", "g1_ops",
           (REDUCE_TEAM, f"constexpr int kReduceTeam = {g};"))
          for g in (1, 4, 8)
     ] + [(f"f12_inv lanes={g}, safegcd", "f12inv", "gt_ops",
           (INV_TEAM, f"constexpr int kInvTeam = {g};")) for g in (1, 2, 3)
     ] + [("f12_inv lanes=6, safegcd", "f12inv", "gt_ops", None)
     ] + [(f"f12_inv lanes=6, at most {r} registers", "f12inv", "gt_ops",
           ("__launch_bounds__(32)\n    f12_inv_kernel",
            f"__launch_bounds__(32, {65536 // (32 * r)})\n    f12_inv_kernel"))
          for r in (168, 128)
     ] + [(f"f2_inv {t} threads a block", "f2inv", "g2_ops",
           (F2_INV_BLOCK, f"constexpr int kF2InvThreads = {t};"))
          for t in (32, 64, 128)
     ] + [(f"f12_csqr lanes={g}", "csqr", "gt_ops",
           (POW_TEAM, f"constexpr int kPowTeam = {g};")) for g in (6, 3)
     ] + [("f12_pow, product and square in one round", "pow", "gt_ops",
           None),
          ("f12_pow, product and square as two rounds", "pow", "gt_ops",
           (POW_ROUND, POW_TWO_ROUNDS)),
          ("f12_pow, at most 168 registers", "pow", "gt_ops",
           ("__launch_bounds__(32)\n    f12_pow_kernel",
            "__launch_bounds__(32, 12)\n    f12_pow_kernel")),
          ("f12_pow lanes=3", "pow", "gt_ops",
           (POW_TEAM, "constexpr int kPowTeam = 3;"))]


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


def graph_timed(fn):
    """Device time per call of fn: REPS calls captured in one CUDA graph
    and replayed, so the host's launch path (ctypes, the checks) is not in
    it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


CHECK_ROWS = 32
TREE_LADDER = ((64, 90), (64, 270), (64, 900), (64, 1080), (64, 2700),
               (16, 13_500))
TREE_POWER = ((63, 1), (63, 13_500), (128, 13_500))


def time_tree(root):
    """Time the ladders, the power, the products, the inverse, the reduce
    and the slot maps of the package under `root` (a process of its own);
    prints one JSON line."""
    import hashlib
    sys.path.insert(0, str(root))
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import params, refimpl
    from drynx_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    pts = C.from_ref_batch([refimpl.g1_mul(refimpl.G1, 3 + j)
                            for j in range(90)]).to(dev)
    g2s = torch.stack([G2.from_ref(refimpl.g2_mul(refimpl.G2, 3 + j))
                       for j in range(90)]).to(dev)
    gtb = refimpl.pair(refimpl.G1, refimpl.G2)
    vals, cur = [], gtb
    for _ in range(90):
        cur = refimpl.fp12_mul(cur, gtb)
        vals.append(cur)
    gts = F12.from_ref_batch(vals).to(dev)
    rows = lambda t, n: t.repeat((n + len(t) - 1) // len(t),
                                 *[1] * (t.dim() - 1))[:n].contiguous()
    scalars = lambda n, bits: F.from_int(
        [int.from_bytes(rng.bytes(32), "little") % min(params.N, 1 << bits)
         for _ in range(n)]).to(dev)
    eights = lambda n: gts[(torch.arange(8 * n, device=dev) * 37 + 11)
                           % len(gts)].reshape(n, 8, 6, 2, 16)
    # (label, operands, kernel, plain version)
    shapes = [(f"scalar_mul W={w} N={n}", (rows(pts, n), scalars(n, 4 * w)),
               (lambda p, k, w=w: cuda_ops.scalar_mul_flat(p, k, w)),
               (lambda p, k, w=w: cuda_ops.scalar_mul_plain(p, k, w)))
              for w, n in TREE_LADDER]
    shapes += [(f"g2_scalar_mul N={G2_N}",
                (rows(g2s, G2_N), scalars(G2_N, 256)),
                cuda_pairing.g2_scalar_mul_flat,
                cuda_pairing.g2_scalar_mul_plain)]
    shapes += [(f"f12_wpow {b} bits N={n}", (rows(gts, n), scalars(n, b)),
                (lambda f, k, b=b: cuda_pairing.f12_wpow_flat(f, k, b, True)),
                (lambda f, k, b=b: cuda_pairing.f12_wpow_plain(f, k, b,
                                                               True)))
               for b, n in TREE_POWER]
    shapes += [(f"f12_mulreduce8 N={n}", (eights(n),),
                cuda_pairing.f12_mulreduce8_flat,
                cuda_pairing.f12_mulreduce8_plain) for n in PROD_SHAPES]
    shapes += [(f"f12_mul N={n}", (rows(gts, n), rows(gts.flip(0), n)),
                cuda_pairing.f12_mul_flat, cuda_pairing.f12_mul_plain)
               for n in MUL_SHAPES]
    inv_x = F.from_int([int.from_bytes(rng.bytes(40), "little") % params.P
                        for _ in range(max(INV_SHAPES))]).to(dev)
    shapes += [(f"fp_inv N={n}", (inv_x[:n],), cuda_pairing.fp_inv_flat,
                cuda_pairing.fp_inv_plain) for n in INV_SHAPES]
    shapes += [(f"point_reduce R={r} N={n}",
                (pts[torch.from_numpy(rng.integers(0, len(pts), (r, n)))
                     .to(dev)],),
                cuda_ops.point_reduce_flat, cuda_ops.point_reduce_plain)
               for r, n in REDUCE_SHAPES]
    shapes += [(f"f12_slotmul {w} N={n}", (rows(gts, n),),
                (lambda a, w=w: cuda_pairing.f12_slotmul_flat(a, w)),
                (lambda a, w=w: cuda_pairing.f12_slotmul_plain(a, w)))
               for n in SLOT_SHAPES for w in cuda_pairing.SLOT_MAPS]
    shapes += [(f"point_add N={n}", (rows(pts, n), rows(pts.flip(0), n)),
                cuda_ops.point_add_flat, cuda_ops.point_add_plain)
               for n in ADD_SHAPES]
    shapes += [(f"f12_inv N={n}", (rows(gts, n),), cuda_pairing.f12_inv_flat,
                cuda_pairing.f12_inv_plain) for n in F12_INV_SHAPES]
    # Z coordinates of Jacobian multiples of the twist's generator
    g2z = G2.double(g2s)[:, 2].contiguous()
    shapes += [(f"f2_inv N={n}", (rows(g2z, n),), cuda_pairing.f2_inv_flat,
                cuda_pairing.f2_inv_plain) for n in F2_INV_SHAPES]
    shapes += [(f"f12_csqr N={n}", (rows(gts, n),),
                cuda_pairing.f12_csqr_flat, cuda_pairing.f12_csqr_plain)
               for n in CSQR_SHAPES]
    shapes += [(f"f12_pow {b} bits N={n}", (rows(gts, n), scalars(n, 256)),
                (lambda f, k, b=b: cuda_pairing.f12_pow_flat(f, k, b)),
                (lambda f, k, b=b: cuda_pairing.f12_pow_plain(f, k, b)))
               for b, n in F12_POW_SHAPES]
    out = {"tree": str(root)}
    for label, args, kern, plain in shapes:
        got = kern(*args)
        torch.cuda.synchronize()
        c = min(CHECK_ROWS, len(got))
        # the first rows of the output, from the first rows of the inputs
        # (a reduce's columns)
        head = [a[:, :c] if label.startswith("point_reduce") else a[:c]
                for a in args]
        if not torch.equal(got[:c], plain(*head)):
            raise SystemExit(f"{root}: {label} differs from its plain "
                             "version")
        out[label] = {"ms": timed(lambda: kern(*args)),
                      "sha": hashlib.sha256(got.cpu().numpy().tobytes())
                      .hexdigest()[:16]}
        if label.startswith(("point_add", "f12_inv", "f2_inv", "f12_csqr")):
            out[label]["graph ms"] = graph_timed(lambda: kern(*args))
    print(json.dumps(out), flush=True)


def against(other):
    """This tree's ladders, power, products, inverse, reduce and slot maps
    against `other`'s, in turn this, other, other, this; the trees' outputs
    must agree."""
    if not (other / "drynx_tpu_torch").is_dir():
        raise SystemExit(f"{other} holds no drynx_tpu_torch package")
    lines = []
    for root in (ROOT, other, other, ROOT):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(root)], cwd=root, capture_output=True, text=True,
            timeout=1500)
        if res.returncode != 0:
            raise SystemExit(f"{root}: exit {res.returncode}\n"
                             f"{res.stdout}\n{res.stderr}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append({k: v["sha"] for k, v in json.loads(line).items()
                      if k != "tree"})
    if any(d != lines[0] for d in lines):
        raise SystemExit("the two trees' outputs differ")


def main():
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tree"]:
        time_tree(Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--against"]:
        against(Path(sys.argv[2]).resolve())
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip())
        return 0
    from chip_smoke import ptxas_summary
    kinds = (set(sys.argv[2].split(",")) if sys.argv[1:2] == ["--kinds"]
             else {kind for _, kind, _, _ in VARIANTS})
    variants = [v for v in VARIANTS if v[1] in kinds]
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
         for _, _, source, edit in variants])

    rng = np.random.default_rng(11)
    rand = lambda n, bits: F.from_int(
        [int.from_bytes(rng.bytes(32), "little") % min(params.N, 1 << bits)
         for _ in range(n)]).to(dev)
    base = eg.BASE_TABLE.table.to(dev)
    # Miller inputs: affine multiples of the generators, made on the card
    pts = cuda_ops.fixed_base_mul_flat(base, rand(MILLER_N, 256))
    px, py, _ = C.normalize(pts)
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
    # the ladder on Jacobian multiples of B; the power on pairing values
    # (GPhi12 members)
    ladder = []
    for label, n, w in LADDER_SHAPES:
        k = rand(n, 4 * w)
        ladder.append((label, pts[:n], k, w,
                       cuda_ops.scalar_mul_plain(pts[:n], k, w)))
    gts = cuda_pairing.final_exp_flat(cuda_pairing.miller_flat(px, py, qx,
                                                               qy))
    power = []
    for label, n, bits in POW_SHAPES:
        k = rand(n, bits)
        power.append((label, gts[:n], k, bits,
                      cuda_pairing.f12_wpow_plain(gts[:n], k, bits, True)))
    # the G2 ladder on Jacobian multiples of the twist's generator; the
    # 8-way product on rows of pairing values drawn from gts
    g2_p = cuda_pairing.g2_scalar_mul_flat(g2_gen, rand(G2_N, 256))
    g2_k = rand(G2_N, 256)
    g2_want = cuda_pairing.g2_scalar_mul_plain(g2_p, g2_k)
    pick = torch.from_numpy(rng.integers(0, MILLER_N, 8 * PROD_SHAPES[0]))
    prod_g = gts[pick.to(dev)].reshape(-1, 8, 6, 2, 16)
    prod_want = cuda_pairing.f12_mulreduce8_plain(prod_g)
    # the Fp12 product on pairing values; the inverse on residues from the
    # seed
    mul_a, mul_b = gts, gts.flip(0).contiguous()
    mul_want = cuda_pairing.f12_mul_plain(mul_a, mul_b)
    inv_x = rand(max(INV_SHAPES), 256)
    inv_want = cuda_pairing.fp_inv_plain(inv_x)
    # the reduce on the crafted chains, then on Jacobian multiples of B at
    # the cluster survey's (R, N); the slot maps on the crafted rows, then
    # on pairing values
    from chip_smoke import (crafted_inv_cases, crafted_reduce_cases,
                            crafted_slotmul_cases)
    from drynx_tpu_torch.crypto import fp12 as F12
    reduce_cases = [(f"crafted R={r}", crafted_reduce_cases(
        C, params, refimpl, r, dev), False) for r in (2, 3, 10)] + [
        (f"R={r} N={n}", pts[:r * n].reshape(r, n, 3, 16), True)
        for r, n in REDUCE_SHAPES]
    slot_cases = [("crafted N=7", crafted_slotmul_cases(params, dev),
                   False)] + [(f"N={n}", gts[:n], True) for n in SLOT_SHAPES]
    # the add on the crafted reduce's R = 2 pairs, then on Jacobian
    # multiples of B (q the rows reversed); the Fp12 inverse on the crafted
    # rows, then on Miller outputs (the final exponentiation's input)
    add_q = pts.flip(0).contiguous()
    add_cases = [("crafted N=7", *crafted_reduce_cases(
        C, params, refimpl, 2, dev), False)] + [
        (f"N={n}", pts[:n], add_q[:n], True) for n in ADD_SHAPES]
    ml = cuda_pairing.miller_flat(px, py, qx, qy)
    inv_cases = [("crafted N=6", crafted_inv_cases(F12, refimpl, dev),
                  False)] + [(f"N={n}", ml[:n], True) for n in F12_INV_SHAPES]
    # the Fp2 inverse on its crafted rows, then on the G2 ladder's Z
    # coordinates; the cyclotomic square on its crafted rows, then on
    # pairing values
    from chip_smoke import crafted_csqr_cases, crafted_f2_inv_cases
    from drynx_tpu_torch.crypto import fp2 as F2
    f2_cases = [("crafted N=9", crafted_f2_inv_cases(F2, params, dev),
                 False)] + [(f"N={n}", g2_p[:n, 2].contiguous(), True)
                            for n in F2_INV_SHAPES]
    csqr_cases = [("crafted N=11", crafted_csqr_cases(F12, refimpl, dev),
                   False)] + [(f"N={n}", gts[:n], True) for n in CSQR_SHAPES]
    # the Fp12 power on its crafted rows at each POW_BITS, then on pairing
    # values with seeded exponents at phase 2's shapes
    from chip_smoke import POW_BITS, crafted_pow_cases
    pow_k = rand(max(n for _, n in F12_POW_SHAPES), 256)
    pow_cases = [(f"crafted {b} bits", *crafted_pow_cases(
        F, F12, refimpl, b, dev), b, False) for b in POW_BITS] + [
        (f"{b} bits N={n}", gts[:n], pow_k[:n], b, True)
        for b, n in F12_POW_SHAPES]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def held(name, label, got, want, same):
        if not same(got, want):
            raise SystemExit(f"{name} {label}: differs from the plain "
                             "version")

    points = lambda a, b: all(torch.equal(x, y)
                              for x, y in zip(C.normalize(a), b))
    for (name, kind, _, _), (lib, log) in zip(variants, libs):
        row = {"variant": name}
        if kind == "miller":
            row["ptxas"] = ptxas_summary(log, "miller_kernel")
            out = torch.empty((MILLER_N, 6, 2, 16), dtype=torch.int32,
                              device=dev)
            run = lambda: cuda_build.check(
                lib.miller(p2.data_ptr(), q2.data_ptr(), out.data_ptr(),
                           MILLER_N, stream()), name)
            run()
            torch.cuda.synchronize()
            held(name, "", out[:1000], miller_want, torch.equal)
            row["ms N=13500"] = timed(run)
        elif kind == "fixed_base":
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
                held(name, label, out, want, points)
                row[f"ms {label}"] = timed(run)
        elif kind == "ladder":
            row["ptxas"] = ptxas_summary(log, "scalar_mul_kernel")
            for label, p, k, w, want in ladder:
                out = torch.empty_like(want)
                run = lambda p=p, k=k, w=w, out=out: cuda_build.check(
                    lib.g1_scalar_mul(p.data_ptr(), k.data_ptr(),
                                      out.data_ptr(), len(k), w, stream()),
                    name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                row[f"ms {label}"] = timed(run)
        elif kind == "g2":
            row["ptxas"] = ptxas_summary(log, "g2_scalar_mul_kernel")
            out = torch.empty_like(g2_want)
            run = lambda: cuda_build.check(
                lib.g2_scalar_mul(g2_p.data_ptr(), g2_k.data_ptr(),
                                  out.data_ptr(), G2_N, stream()), name)
            run()
            torch.cuda.synchronize()
            held(name, "", out, g2_want, torch.equal)
            row[f"ms N={G2_N}"] = timed(run)
        elif kind == "prod":
            row["ptxas"] = ptxas_summary(log, "f12_mulreduce8_kernel")
            for n in PROD_SHAPES:
                out = torch.empty_like(prod_want[:n])
                run = lambda n=n, out=out: cuda_build.check(
                    lib.f12_mulreduce8(prod_g.data_ptr(), out.data_ptr(), n,
                                       stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, f"N={n}", out, prod_want[:n], torch.equal)
                row[f"ms N={n}"] = timed(run)
            row["f12_mul ptxas"] = ptxas_summary(log, "f12_mul_kernel")
            for n in MUL_SHAPES:
                out = torch.empty_like(mul_want[:n])
                run = lambda n=n, out=out: cuda_build.check(
                    lib.f12_mul(mul_a.data_ptr(), mul_b.data_ptr(),
                                out.data_ptr(), n, stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, f"f12_mul N={n}", out, mul_want[:n], torch.equal)
                row[f"f12_mul ms N={n}"] = timed(run)
        elif kind == "reduce":
            row["ptxas"] = ptxas_summary(log, "point_reduce_kernel")
            for label, t, timed_here in reduce_cases:
                want = cuda_ops.point_reduce_plain(t)
                out = torch.empty_like(want)
                run = lambda t=t, out=out: cuda_build.check(
                    lib.g1_point_reduce(t.data_ptr(), out.data_ptr(), len(t),
                                        t.shape[1], stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                if timed_here:
                    row[f"ms {label}"] = timed(run)
                    row[f"graph ms {label}"] = graph_timed(run)
        elif kind == "slotmul":
            row["ptxas"] = ptxas_summary(log, "f12_slotmul_kernel")
            for label, a, timed_here in slot_cases:
                for w in cuda_pairing.SLOT_MAPS:
                    want = cuda_pairing.f12_slotmul_plain(a, w)
                    c = cuda_pairing._slot_constants(w, str(dev))
                    out = torch.empty_like(want)
                    run = lambda a=a, c=c, w=w, out=out: cuda_build.check(
                        lib.f12_slotmul(a.data_ptr(), c.data_ptr(),
                                        out.data_ptr(), len(a),
                                        int(cuda_pairing._conjugates(w)),
                                        stream()), name)
                    run()
                    torch.cuda.synchronize()
                    held(name, f"{label} {w}", out, want, torch.equal)
                    if timed_here:
                        row[f"ms {label} {w}"] = timed(run)
                        row[f"graph ms {label} {w}"] = graph_timed(run)
        elif kind == "add":
            row["ptxas"] = ptxas_summary(log, "point_add_kernel")
            for label, p, q, timed_here in add_cases:
                want = cuda_ops.point_add_plain(p, q)
                out = torch.empty_like(want)
                run = lambda p=p, q=q, out=out: cuda_build.check(
                    lib.g1_point_add(p.data_ptr(), q.data_ptr(),
                                     out.data_ptr(), len(p), stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                if timed_here:
                    row[f"ms {label}"] = timed(run)
                    row[f"graph ms {label}"] = graph_timed(run)
        elif kind in ("f12inv", "f2inv", "csqr"):
            fn, cases_here, plain = {
                "f12inv": ("f12_inv", inv_cases, cuda_pairing.f12_inv_plain),
                "f2inv": ("f2_inv", f2_cases, cuda_pairing.f2_inv_plain),
                "csqr": ("f12_csqr", csqr_cases,
                         cuda_pairing.f12_csqr_plain)}[kind]
            row["ptxas"] = ptxas_summary(log, f"{fn}_kernel")
            for label, a, timed_here in cases_here:
                want = plain(a)
                out = torch.empty_like(want)
                run = lambda a=a, out=out, fn=fn: cuda_build.check(
                    getattr(lib, fn)(a.data_ptr(), out.data_ptr(), len(a),
                                     stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                if timed_here:
                    row[f"ms {label}"] = timed(run)
                    row[f"graph ms {label}"] = graph_timed(run)
        elif kind == "pow":
            row["ptxas"] = ptxas_summary(log, "f12_pow_kernel")
            for label, f, k, bits, timed_here in pow_cases:
                want = cuda_pairing.f12_pow_plain(f, k, bits)
                out = torch.empty_like(want)
                run = lambda f=f, k=k, bits=bits, out=out: cuda_build.check(
                    lib.f12_pow(f.data_ptr(), k.data_ptr(), out.data_ptr(),
                                len(k), bits, stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                if timed_here:
                    row[f"ms {label}"] = timed(run)
        elif kind == "fp_inv":
            row["ptxas"] = ptxas_summary(log, "fp_inv_kernel")
            for n in INV_SHAPES:
                out = torch.empty_like(inv_want[:n])
                run = lambda n=n, out=out: cuda_build.check(
                    lib.fp_inv(inv_x.data_ptr(), out.data_ptr(), n,
                               stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, f"N={n}", out, inv_want[:n], torch.equal)
                row[f"ms N={n}"] = timed(run)
        else:
            row["ptxas"] = ptxas_summary(log, "f12_wpow_kernel")
            for label, f, k, bits, want in power:
                out = torch.empty_like(want)
                run = lambda f=f, k=k, bits=bits, out=out: cuda_build.check(
                    lib.f12_wpow(f.data_ptr(), k.data_ptr(), out.data_ptr(),
                                 len(k), bits, 1, stream()), name)
                run()
                torch.cuda.synchronize()
                held(name, label, out, want, torch.equal)
                row[f"ms {label}"] = timed(run)
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
