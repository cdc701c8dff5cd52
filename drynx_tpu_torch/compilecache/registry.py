"""The kernel warm-up registry: what a survey of one shape finds cold.

The port's counterpart of drynx_tpu/compilecache/registry.py. Nothing in
the port compiles per shape: a kernel library is built once by nvcc and
then holds every row count. What the first survey of a shape pays is

  * `library:<csrc name>`: nvcc for a missing `.so` (a minute for a fresh
    build of all five), then the dlopen (`cuda_build.load`);
  * `kernel:<wrapper>`: the first launch of each kernel of the survey
    path, one launch at POOL rows on distinct valid operands (the 14
    kernels but the Fp12 power, B15, which no survey launches);
  * `table:range_sigs@u<u>`: the cluster's digit-signature tables of base
    u (`LocalCluster.ensure_range_sigs`: GT tables on the card, window
    tables on the host);
  * `table:gt_base`: the gtB window table (`range_proof.gt_base_table`).

Measured on an H100 80GB HBM3 at 700 W (scripts/torch_warm_cost.py): a
cold process's first proofs-on survey at 13,500 digit proofs took
0.4-0.9 s longer after the libraries and tables alone than after one
launch a kernel, and launching every kernel once at each row count the
survey gives it saved nothing more. So warmth is keyed on the kernel, not on
its rows, and only a shape's range base u names anything of its own.

`build_registry(profile)` names every entry a survey of that shape
reaches. `precompile(profile, mode, cluster)` drives them serially on
the calling thread. Its launches, and those of the table builds it runs,
go to its stats (`cuda_build.uncounted`), never to the wrappers'
`LAUNCHES` or to `LAUNCH_ROWS`, so a warmed survey's launch counts are
its own.

Left out against the reference: the profile fields that would name no
entry here: `n_shards` (the card is one device; ROADMAP queue A, step
13), `n_fold` (the port's cluster folds its ciphertexts in one reduce,
not along a tree), `dlog_limit` (the decryption table is built with the
cluster), `n_buckets` (a grid survey's tiles are host work), and
`n_queue`, `n_noise` and `n_pane` (the cross flush, the DRO phase and
the stream launch the survey's kernels, at other rows); the reference's
lowered and compiled modes with their worker-op filter (`WORKER_OPS`),
its bucketed, fused and wire program families, and `trace_guard`
(nothing here traces).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import sys
import time
from typing import Callable

import torch

from .stats import STATS, CompileStats

# the C sources under drynx_tpu_torch/csrc (utils/cuda_build.ENTRY_POINTS)
LIBRARIES = ("g1_ops", "fp_inv", "g2_ops", "gt_ops", "miller")
MODES = ("build", "execute")
# the kernels a proofs-on survey launches, each with the phase that first
# reaches it (documentation only): encryption, aggregation, the key
# switch, the range proofs' creation and their check
KERNELS = {
    "fixed_base_mul": "DataCollection", "point_add": "DataCollection",
    "point_reduce": "Aggregation", "fp_inv": "Aggregation",
    "scalar_mul": "KeySwitch", "g2_scalar_mul": "RangeProofCreate",
    "f12_mulreduce8": "RangeProofCreate", "f12_mul": "RangeProofCreate",
    "f2_inv": "RangeProofCreate", "f12_slotmul": "VerifyRange",
    "f12_wpow": "VerifyRange", "miller": "VerifyRange",
    "f12_inv": "VerifyRange", "f12_csqr": "VerifyRange",
}


@dataclasses.dataclass(frozen=True)
class Profile:
    """A proofs-on survey's shape (defaults: the reference's flagship bench
    survey): the key by which the server groups surveys for one cross
    flush, and, through its base u, the signature tables it needs."""

    n_cns: int = 3
    n_dps: int = 10
    n_values: int = 9       # V: values a DP (the ranges' length)
    u: int = 16             # range-proof base
    l: int = 5              # range-proof digits


BENCH = Profile()


def query_profile(cluster, q) -> Profile:
    """The shape of a proofs-on query `q` on `cluster` (any object with
    `cns`, `dp_idents` and `_ranges_per_value`): the key of
    LocalCluster's warm-up and of the server's admission alike. Its
    values take the first (u, l) spec of the query's ranges."""
    ranges = cluster._ranges_per_value(q)
    u0, l0 = ranges[0] if ranges else (16, 5)
    return Profile(
        n_cns=len(cluster.cns), n_dps=len(cluster.dp_idents),
        n_values=max(len(ranges), 1), u=int(u0) or 16, l=int(l0) or 5)


def noise_size(q) -> int:
    """A query's DRO noise-list size, 0 without a diffp block."""
    d = getattr(q, "diffp", None)
    return int(d.noise_list_size) if d is not None and d.enabled() else 0


@dataclasses.dataclass(frozen=True)
class Entry:
    """One warm-up entry: `call()` drives it, `dispatched()` says whether
    `precompile` drives it here (a kernel entry on a CUDA device only, a
    cluster's table only when a cluster is given)."""

    name: str               # "library:g1_ops", "kernel:miller", ...
    kind: str               # "library" | "kernel" | "table"
    phase: str              # the survey phase that reaches it (doc only)
    dispatched: Callable[[], bool]
    call: Callable[[], object]
    kernel: str = ""        # a kernel entry's kernel


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _device(cluster, device=None) -> torch.device:
    """The kernels' device: the cluster's, else `device`, else the card
    when there is one."""
    if cluster is not None:
        return torch.device(cluster.device)
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


POOL = 8           # distinct operands a warm-up launch cycles through


@functools.cache
def _operand_pools() -> dict:
    """POOL distinct valid operands of each type, on the CPU: the G1 and
    G2 multiples k*G (k = 1..POOL, affine, Z = 1), gtB^k, and full-width
    scalars n - 1 - 7919 k. Distinct rows and operands take the general
    branch of the complete add, as a survey's do (one point added to
    itself would take the doubling)."""
    from ..crypto import curve as C
    from ..crypto import field as F
    from ..crypto import fp12 as F12
    from ..crypto import g2 as G2
    from ..crypto import params, refimpl
    from ..proofs import range_proof as rp

    ks = range(1, POOL + 1)
    gtb = F12.to_ref(rp.gt_base())
    gts = [gtb]
    for _ in ks[1:]:
        gts.append(refimpl.fp12_mul(gts[-1], gtb))
    return {
        "g1": C.from_ref_batch([refimpl.g1_mul(refimpl.G1, k) for k in ks]),
        "g2": torch.stack([G2.from_ref(refimpl.g2_mul(refimpl.G2, k))
                           for k in ks]),
        "gt": F12.from_ref_batch(gts),
        "k": torch.stack([F.from_int(params.N - 1 - 7919 * k)
                          for k in ks]).to(torch.int32),
    }


def _kernel_inputs(kernel: str, dev, n: int = POOL):
    """Valid operands for one launch on n rows (a reduce of 3 rows over n
    columns), distinct from row to row and between a launch's operands:
    (args, kwargs) of the wrapper."""
    from ..crypto import elgamal as eg

    pools = {k: v.to(dev) for k, v in _operand_pools().items()}
    idx = torch.arange(n, device=dev) % POOL
    # operand j of a launch: the pool shifted by j, so row i's operands
    # differ
    take = lambda pool, j=0: pool[(idx + j) % POOL].contiguous()
    g1, g2, gt, k = pools["g1"], pools["g2"], pools["gt"], pools["k"]
    if kernel == "fixed_base_mul":
        return (eg.BASE_TABLE.table.to(dev), take(k)), {}
    if kernel == "scalar_mul":
        return (take(g1), take(k, 1)), {}
    if kernel == "g2_scalar_mul":
        return (take(g2), take(k, 1)), {}
    if kernel == "point_add":
        return (take(g1), take(g1, 1)), {}
    if kernel == "point_reduce":
        return (torch.stack([take(g1, j) for j in range(3)]),), {}
    if kernel == "fp_inv":
        return (take(g1)[:, 0],), {}
    if kernel == "f2_inv":
        return (take(g2)[:, 0],), {}
    if kernel == "f12_mul":
        return (take(gt), take(gt, 1)), {}
    if kernel == "f12_mulreduce8":
        return (torch.stack([take(gt, j) for j in range(8)], dim=1),), {}
    if kernel == "miller":
        p, q = take(g1), take(g2, 1)            # affine: Z = 1
        return (p[:, 0], p[:, 1], q[:, 0], q[:, 1]), {}
    if kernel in ("f12_inv", "f12_csqr"):
        return (take(gt),), {}
    if kernel == "f12_slotmul":
        return (take(gt), "frob1"), {}
    if kernel == "f12_wpow":
        return (take(gt), take(k, 1)), {"n_bits": 63, "cyc": True}
    raise KeyError(f"no warm-up inputs for kernel {kernel!r}")


def _kernel_call(kernel: str, dev: torch.device):
    def call():
        from ..crypto import cuda_ops, cuda_pairing

        mod = cuda_ops if kernel in cuda_ops.LAUNCHES else cuda_pairing
        args, kw = _kernel_inputs(kernel, dev)
        out = getattr(mod, f"{kernel}_flat")(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    return call


def _library_entry(name: str, mode: str, dev: torch.device) -> Entry:
    def call():
        from ..utils import cuda_build

        cached = cuda_build.library_path(name).exists()
        if mode == "build":
            cuda_build.build(name)
        else:
            cuda_build.load(name)
        return cached

    def dispatched():
        return mode == "build" or dev.type == "cuda"

    return Entry(f"library:{name}", "library", "Load", dispatched, call)


def build_registry(profile: Profile = BENCH, cluster=None,
                   mode: str = "execute", device=None) -> list[Entry]:
    """Every entry a survey of shape `profile` reaches, cheap first: the
    libraries, the tables, then the kernels in the order the survey
    reaches them. `cluster` binds the table entries that need one and
    sets the kernels' device (else `device`, else the card when there is
    one)."""
    dev = _device(cluster, device)
    entries: dict[str, Entry] = {}
    for lib in LIBRARIES:
        e = _library_entry(lib, mode, dev)
        entries[e.name] = e
    from ..proofs import range_proof as rp

    entries["table:gt_base"] = Entry("table:gt_base", "table", "RangeProof",
                                     lambda: True, rp.gt_base_table)
    name = f"table:range_sigs@u{profile.u}"
    entries[name] = Entry(
        name, "table", "RangeProof", lambda: cluster is not None,
        lambda: cluster.ensure_range_sigs(profile.u))
    on_card = lambda: dev.type == "cuda"
    for kernel, phase in KERNELS.items():
        name = f"kernel:{kernel}"
        entries[name] = Entry(name, "kernel", phase, on_card,
                              _kernel_call(kernel, dev), kernel=kernel)
    return list(entries.values())


# ---------------------------------------------------------------------------
# Serial driver
# ---------------------------------------------------------------------------

def precompile(profile: Profile = BENCH, mode: str = "execute",
               cluster=None, log: Callable[[str], None] | None = None,
               stats: CompileStats | None = None,
               device=None) -> CompileStats:
    """Drive every dispatched entry of `profile`, serially, on the calling
    thread.

    mode:
      "build"   -- nvcc for every missing library (the toolkit, not the
                   card); kernel and table entries are skipped
      "execute" -- build and load every library, launch each kernel once
                   (on a CUDA device; skipped elsewhere) and build the
                   tables (the cluster's only when given)

    The kernels run on the cluster's device, else on `device`: the card
    unless the CPU is named, where only the tables are built.

    The entries' launches, and those of the table builds, are kept in
    `stats.launches` and leave `cuda_ops.LAUNCHES`,
    `cuda_pairing.LAUNCHES` and `cuda_build.LAUNCH_ROWS` as they were."""
    assert mode in MODES, mode
    from ..utils import cuda_build
    from ..utils.device import resolve

    if cluster is None and mode == "execute":
        device = resolve(device)    # the card unless the CPU is named
    stats = stats or STATS
    if log is None:
        log = lambda m: print(f"[precompile] {m}", file=sys.stderr,
                              flush=True)
    entries = build_registry(profile, cluster, mode, device)
    log(f"{len(entries)} entries registered (mode={mode})")
    errors = 0
    sink = collections.Counter()
    with cuda_build.uncounted(sink):
        for e in entries:
            if not e.dispatched() or (mode == "build"
                                      and e.kind != "library"):
                stats.record(e.name, "skipped",
                             detail="not driven here")
                continue
            t0 = time.perf_counter()
            try:
                got = e.call()
            except Exception as exc:  # record and go on; the CLI exits 1
                errors += 1
                stats.record(e.name, "error", time.perf_counter() - t0,
                             detail=f"{type(exc).__name__}: {exc}")
                continue
            dt = time.perf_counter() - t0
            if e.kind == "library":
                stats.record(e.name, "built" if mode == "build" else
                             "loaded", dt, cached=bool(got))
            else:
                stats.record(e.name, "executed", dt)
    stats.add_launches(sink)
    t = stats.totals()
    log(f"done: {t['built']} built / {t['loaded']} loaded / "
        f"{t['executed']} executed / {t['skipped']} skipped / {errors} "
        f"errors; {t['seconds']:.1f} s")
    return stats


__all__ = ["BENCH", "Entry", "KERNELS", "LIBRARIES", "MODES", "POOL",
           "Profile", "build_registry", "noise_size", "precompile",
           "query_profile"]
