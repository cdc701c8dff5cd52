#!/usr/bin/env python3
"""What the kernel warm-up saves a cold process's first survey, on one
card.

    python3 scripts/torch_warm_cost.py [--dps 10] [--values 90] [--repeats 2]

Each run is a fresh process (no CUDA module loaded, an empty caching
allocator) that builds a proofs-on cluster (3 CNs, the given DPs, 2 VNs)
and warms it one of three ways before it times two surveys of one shape,
a `frequency_count` over [0, values) with ranges (16, 5) on every value
(at 10 DPs and 90 values, phase 7's 13,500 digit proofs):

  tables   the registry's library and table entries only: the first
           survey pays every kernel's first launch and its allocator
           segments;
  modules  those, and the registry of another shape (2 CNs, 2 DPs, one
           value, one digit): each kernel launched once, which shows that
           a kernel's warmth carries across shapes;
  full     the whole registry at the survey's shape
           (`LocalCluster._warm_kernels`, as a served survey is warmed).

The variants run in the order tables, modules, full, then reversed, each
`--repeats` times in all (`--variants` picks some). `--trace` adds, for
each survey, the seconds of the main path's steps on the main thread
(each between two device synchronizations, keyed by call number): the
DPs' encodings, the survey's draws, the encryption and its parts (the
plaintexts' limbs, the fixed-base products, the negation and the adds),
the fold, the key switch and the decryption; and, before the surveys,
the time of an add of two distinct points at the encryption's rows,
twice, then of a point to itself. Every run prints one JSON line (the
warm-up's seconds, the first and the second survey's wall seconds, the
first survey's phase timers); the last line holds the medians by
variant and the card's name and power limit. The script builds the
libraries (one nvcc a source, all at once) before the runs. `--cpu` runs
the same flow on the CPU at the given size (no kernel entry is driven
there) to check the script.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("tables", "modules", "full")


def _child(args) -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from drynx_tpu_torch import compilecache as cc
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.utils import cuda_build
    from drynx_tpu_torch.utils.timers import PhaseTimers

    dev = "cpu" if args.cpu else "cuda"
    sync = (lambda: torch.cuda.synchronize()) if dev == "cuda" else (
        lambda: None)
    steps = collections.Counter()
    if args.trace:
        from drynx_tpu_torch.crypto import curve, elgamal
        from drynx_tpu_torch.service import service as svc

        from drynx_tpu_torch.crypto import cuda_ops
        from drynx_tpu_torch.utils import cuda_build as cb

        calls = collections.Counter()
        for owner, name in ((cb, "launch"), (cuda_ops, "_empty_points"),
                            (svc.DataProvider, "local_stats"),
                            (svc.LocalCluster, "_draw"),
                            (elgamal, "magnitude_limbs"),
                            (elgamal, "fixed_base_mul"),
                            (curve, "neg"), (curve, "add"),
                            (elgamal, "encrypt_ints_with_tables"),
                            (svc.topo, "fold_cts"),
                            (svc.LocalCluster, "_key_switch"),
                            (svc.LocalCluster, "_decrypt")):
            def timed(*a, _fn=getattr(owner, name), _name=name, **k):
                if threading.current_thread() is not threading.main_thread():
                    return _fn(*a, **k)
                calls[_name] += 1
                key = f"{_name}#{calls[_name]}"
                sync()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                sync()
                steps[key] += time.perf_counter() - t0
                return out
            setattr(owner, name, timed)
    cl = LocalCluster(n_cns=3, n_dps=args.dps, n_vns=2, seed=7,
                      dlog_limit=10 * args.dps, device=dev)
    rng = np.random.default_rng(3)
    for dp in cl.dps.values():
        dp.data = rng.integers(0, args.values, size=(8,)).astype(np.int64)
    sqs = [cl.generate_survey_query("frequency_count", 0, args.values - 1,
                                    proofs=1,
                                    ranges=[(16, 5)] * args.values,
                                    thresholds=1.0)
           for _ in range(2)]
    sync()
    t0 = time.perf_counter()
    if args.child == "full":
        cl._warm_kernels(PhaseTimers(), sqs[0].query)
    else:
        profile = cc.query_profile(cl, sqs[0].query)
        with cuda_build.uncounted(collections.Counter()):
            for e in cc.build_registry(profile, cl):
                if e.kind != "kernel" and e.dispatched():
                    e.call()
        if args.child == "modules":
            cc.precompile(cc.Profile(n_cns=2, n_dps=2, n_values=1, u=16,
                                     l=1), cluster=cl,
                          stats=cc.CompileStats(), log=lambda m: None)
        cl._aot_warmed = True       # the survey runs no warm-up of its own
    sync()
    warm_s = time.perf_counter() - t0
    probes = {}
    if args.trace:
        # the encryption's add at its rows before any survey: two distinct
        # points (mB + rP), then a point and itself (as the warm-up's)
        from drynx_tpu_torch.crypto import curve, elgamal

        tab = cl.base_table
        n = args.dps * args.values
        gen = torch.Generator(device=dev).manual_seed(5)
        a = elgamal.fixed_base_mul(tab, elgamal.random_scalars((n,), gen, dev))
        b = elgamal.fixed_base_mul(tab, elgamal.random_scalars((n,), gen, dev))
        for name, (p, q) in (("distinct#1", (a, b)), ("distinct#2", (a, b)),
                             ("same#1", (a, a))):
            sync()
            t1 = time.perf_counter()
            curve.add(p, q)
            sync()
            probes[name] = round(time.perf_counter() - t1, 4)
    walls, timers, traces = [], None, []
    for i, sq in enumerate(sqs):
        steps.clear()
        if args.trace:
            calls.clear()
        t0 = time.perf_counter()
        res = cl.run_survey(sq, seed=i)
        sync()
        walls.append(time.perf_counter() - t0)
        if res.block is None or set(res.block.data.bitmap.values()) != {1}:
            raise SystemExit(f"survey {i}: not every proof accepted")
        timers = timers or {k: round(v, 4) for k, v in res.timers.items()}
        traces.append({k: round(v, 4) for k, v in steps.items()
                       if v >= 0.01 or k.endswith("#1")})
    cl.close()
    out = {"variant": args.child, "warm_s": warm_s, "first_s": walls[0],
           "second_s": walls[1], "first_minus_second_s": walls[0] - walls[1],
           "first_timers": timers}
    if args.trace:
        out["steps"] = traces
        out["probes"] = probes
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dps", type=int, default=10)
    ap.add_argument("--values", type=int, default=90)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--child", choices=VARIANTS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args)), flush=True)
        return 0

    sys.path.insert(0, str(ROOT))
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device (pass --cpu to check the script)",
                  file=sys.stderr)
            return 2
        from drynx_tpu_torch.utils import cuda_build

        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"libraries built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    variants = [v for v in VARIANTS if v in args.variants.split(",")]
    n = args.repeats * len(variants)
    order = (variants + variants[::-1]) * args.repeats
    runs = []
    base = [sys.executable, __file__, "--dps", str(args.dps), "--values",
            str(args.values)] + (["--cpu"] if args.cpu else []) + (
            ["--trace"] if args.trace else [])
    for v in order[:n]:
        out = subprocess.run(base + ["--child", v], capture_output=True,
                             text=True, env=dict(os.environ), timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {v: {k: statistics.median(r[k] for r in runs
                                        if r["variant"] == v)
                   for k in ("warm_s", "first_s", "second_s",
                             "first_minus_second_s")}
               for v in variants}
    card = "cpu"
    if not args.cpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"medians": summary, "card": card, "dps": args.dps,
                      "values": args.values, "runs": len(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
