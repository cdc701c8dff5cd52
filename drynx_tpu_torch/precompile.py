"""Kernel warm-up CLI: build, load and launch a survey shape's kernels.

The port's counterpart of drynx_tpu/precompile.py. A cold process pays
nvcc, each library's load, each kernel's first launch and the range
proofs' tables inside its first timed survey; this drives the
compilecache registry serially on the main thread instead:

    python -m drynx_tpu_torch.precompile           # on the card: execute
    python -m drynx_tpu_torch.precompile --build   # nvcc only (no card)
    python -m drynx_tpu_torch.precompile --cpu     # tables only
    python -m drynx_tpu_torch.precompile --list    # enumerate, drive nothing

The reference's profile flags have no counterpart: without a cluster the
entries driven are the same for every shape (the libraries, one launch a
kernel and the gtB table; a shape's signature tables need its cluster),
so the CLI lists and drives the flagship bench profile's. Exits non-zero
if any entry errs.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m drynx_tpu_torch.precompile",
        description="warm the proofs-on survey's kernels, libraries and "
                    "tables")
    ap.add_argument("--list", action="store_true",
                    help="print the registry and exit (nothing driven)")
    ap.add_argument("--build", action="store_true",
                    help="build the missing libraries with nvcc only")
    ap.add_argument("--cpu", action="store_true",
                    help="no card: build the tables, skip the kernels")
    ap.add_argument("--quiet", action="store_true",
                    help="no per-entry stderr rows")
    args = ap.parse_args(argv)

    from drynx_tpu_torch import compilecache as cc

    profile = cc.BENCH
    mode = "build" if args.build else "execute"
    if args.list:
        entries = cc.build_registry(profile, mode=mode)
        w = max(len(e.name) for e in entries)
        for e in entries:
            print(f"{e.name:<{w}}  {e.kind:<7} {e.phase}")
        print(f"-- {len(entries)} entries")
        return 0
    if not args.cpu and not args.build:
        import torch

        if not torch.cuda.is_available():
            print("[precompile] no CUDA device: pass --cpu (tables only) "
                  "or --build (nvcc only)", file=sys.stderr)
            return 2
    cc.CompileStats.echo = not args.quiet
    stats = cc.precompile(profile, mode=mode,
                          device="cpu" if args.cpu else None)
    print(stats.table())
    return 1 if stats.count("error") else 0


if __name__ == "__main__":
    sys.exit(main())
