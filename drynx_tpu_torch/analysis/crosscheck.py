"""The runtime recorders' cross-checks, each run in a fresh interpreter.

    python -m drynx_tpu_torch.analysis.crosscheck locks|bytes|lifecycles \\
        [--device cpu|cuda]

runs one workload under its recorder and prints one JSON line. Its
environment must arm the recorder (``DRYNX_LOCK_TRACE=1``,
``DRYNX_DET_TRACE=1``, ``DRYNX_PROTO_TRACE=1``): ``drynx_tpu_torch`` is
the first import, and its ``__init__`` installs the recorder before any
lock of the package exists. The workloads are the reference analyzer's
own cross-check children at their sizes
(``tests/test_concurrency_analysis.py``, ``test_determinism_analysis.py``,
``test_typestate_analysis.py``):

* ``locks`` — a 2-worker pipelined ``SurveyServer`` over
  ``LocalCluster(n_cns=1, n_dps=2, n_vns=0, seed=23)`` takes a burst of
  8 proofs-off sums with a queue of 4 and shedding at half of it, then
  drains; the observed named-lock edges, acquisitions, shed and
  completed counts;
* ``bytes`` — one proofs-on sum (ranges (4, 2)) through
  ``SurveyServer(max_batch=1)`` over ``LocalCluster(n_cns=2, n_dps=2,
  n_vns=2, seed=13)``, its transcript, then a ProofDB ``pane:`` put and
  an epsilon charge; the recorder's snapshot;
* ``lifecycles`` — three slab refills, ``consume_dro(10)``, a second
  store over the same root, the checkpoint's fresh and resumed cycles,
  and a ConnPool echo conversation (8 reuses, a discard, a direct
  ``Conn``); the recorder's snapshot.

Every child also reports its kernel launches and their rows. The
``check_*`` functions are the gates a caller applies to the children's
lines. Nothing here is imported by the analyzer itself.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Sequence

from .core import REPO_ROOT

ENV = {"locks": "DRYNX_LOCK_TRACE", "bytes": "DRYNX_DET_TRACE",
       "lifecycles": "DRYNX_PROTO_TRACE"}

# the reference children's sizes
LOCKS_CLUSTER = {"n_cns": 1, "n_dps": 2, "n_vns": 0, "seed": 23,
                 "dlog_limit": 1000}
LOCKS_SERVER = {"pipeline": True, "workers": 2, "max_batch": 1,
                "max_depth": 4, "tenant_quota": 8, "shed_fraction": 0.5}
LOCKS_BURST = 8
BYTES_CLUSTER = {"n_cns": 2, "n_dps": 2, "n_vns": 2, "seed": 13,
                 "dlog_limit": 4000}
# a key of the skipchain's blocks, which embed the wall-clock sample_time
# that transcripts exclude by design
BYTES_EXEMPT = ("proofdb:chain/block",)
LIFECYCLE_MIN = {"kinds": 3, "events": 20, "slab": 3, "conn": 8, "ckpt": 2}


def _launches() -> Dict[str, object]:
    from ..crypto import cuda_ops, cuda_pairing
    from ..utils import cuda_build
    counts = {k: v for k, v in {**cuda_ops.LAUNCHES,
                                **cuda_pairing.LAUNCHES}.items() if v}
    rows = {k: sorted([list(r) if isinstance(r, tuple) else r, n]
                      for r, n in c.items())
            for k, c in cuda_build.LAUNCH_ROWS.items() if c}
    return {"launches": counts, "rows": rows}


def run_locks(device: str) -> Dict[str, object]:
    from . import locktrace
    import numpy as np
    from ..server import Overloaded, QueueFull, SurveyServer
    from ..service.service import LocalCluster

    cl = LocalCluster(**LOCKS_CLUSTER, device=device)
    for i, dp in enumerate(cl.dps.values()):
        dp.data = np.arange(4, dtype=np.int64) + i
    # a small queue and early shedding: the burst drives the scheduler
    # through the Overloaded path, whose retry-after hint reads the
    # completion clock (results lock) under the intake lock
    srv = SurveyServer(cl, **LOCKS_SERVER)
    shed = done = 0
    for i in range(LOCKS_BURST):
        try:
            srv.submit(cl.generate_survey_query(
                "sum", query_min=0, query_max=9, proofs=0,
                survey_id=f"trace{i}"))
            done += 1
        except (Overloaded, QueueFull):
            shed += 1
    results = srv.drain()
    if len(results) != done:
        raise SystemExit(f"drained {len(results)} of {done} surveys")
    return {"edges": sorted(locktrace.observed_edges()),
            "acquires": locktrace.acquisition_count(),
            "shed": shed, "completed": done, **_launches()}


def run_bytes(device: str) -> Dict[str, object]:
    from . import dettrace
    import numpy as np
    from ..pool.epsilon import EpsilonLedger
    from ..server import SurveyServer, survey_transcript
    from ..service.service import LocalCluster
    from ..service.store import ProofDB

    cl = LocalCluster(**BYTES_CLUSTER, device=device)
    rng = np.random.default_rng(5)
    for dp in cl.dps.values():
        dp.data = rng.integers(0, 4, size=(2,)).astype(np.int64)
    sq = cl.generate_survey_query("sum", query_min=0, query_max=15,
                                  proofs=1, ranges=[(4, 2)],
                                  survey_id="det0")
    srv = SurveyServer(cl, max_batch=1, pipeline=False)
    srv.submit(sq)
    results = srv.drain()
    if "det0" not in results:
        raise SystemExit(f"survey det0 missing from {sorted(results)}")
    blob = survey_transcript(cl.vns, "det0")
    if not blob:
        raise SystemExit("the proofs-on survey gave an empty transcript")
    # the other byte-identity sinks, with deterministic content
    with tempfile.TemporaryDirectory() as td:
        db = ProofDB(os.path.join(td, "p.db"))
        db.put("pane:det0/0", blob)
        led = EpsilonLedger(os.path.join(td, "eps"), budget=10.0)
        led.charge("dp0", "det0", 0.5)
    return {"snapshot": dettrace.snapshot(), **_launches()}


def run_lifecycles(device: str) -> Dict[str, object]:
    from . import prototrace
    import numpy as np
    import torch
    from .. import pool as pool_mod
    from ..crypto import elgamal as eg
    from ..pool import replenish

    with tempfile.TemporaryDirectory() as td:
        # atomic/journal/slab: three slabs, consumed across a simulated
        # crash (a second store over the same root replays the ledger
        # before serving the remaining balance)
        rng = np.random.default_rng(42)
        _, pub = eg.keygen(rng)
        table = eg.pub_table(pub).table.to(device)
        root = os.path.join(td, "pool")
        store = pool_mod.CryptoPool(root, slab_elems=8)
        dig = pool_mod.key_digest(table)
        gen = torch.Generator(device=device).manual_seed(0)
        for _ in range(3):
            replenish.refill_slab(store, gen, table)
        store.consume_dro(dig, 10)
        store2 = pool_mod.CryptoPool(root, slab_elems=8)
        if store2.dro_balance(dig) != 8:
            raise SystemExit(f"balance {store2.dro_balance(dig)} after "
                             f"the replay, expected 8")
        store2.consume_dro(dig, 4)
        launches = _launches()
        checkpoint_cycle(td)
    conversation()
    return {"snapshot": prototrace.snapshot(), **launches}


def checkpoint_cycle(directory: str) -> None:
    """A checkpoint's fresh save/enter cycle, then a load/enter/save
    resume, through a ProofDB in `directory`."""
    from ..service.store import ProofDB, SurveyCheckpoint

    db = ProofDB(os.path.join(directory, "p.db"))
    ck = SurveyCheckpoint("chaos0")
    ck.enter("admitted")
    ck.save(db)
    ck.enter("collect")
    ck.save(db)
    resumed = SurveyCheckpoint.load(db, "chaos0")
    resumed.enter("collect")
    resumed.save(db)


def conversation() -> None:
    """A TCP conversation through a ConnPool: a fresh checkout, 7 idle
    reuses, an explicit discard, and a direct Conn closed."""
    from ..service.transport import Conn, ConnPool, NodeServer

    srv = NodeServer()
    srv.register("echo", lambda m: {"payload": m["payload"]})
    srv.start()
    cp = ConnPool()
    try:
        for i in range(8):
            c = cp.get(srv.host, srv.port)
            if c.call({"type": "echo", "payload": [i]})["payload"] != [i]:
                raise SystemExit("echo answered wrongly")
            cp.put(c)
        c = cp.get(srv.host, srv.port)
        cp.discard(c)
        direct = Conn(srv.host, srv.port)
        direct.call({"type": "echo", "payload": [99]})
        direct.close()
    finally:
        cp.close_all()
        srv.stop()


RUNS = {"locks": run_locks, "bytes": run_bytes, "lifecycles": run_lifecycles}


# -- the gates -----------------------------------------------------------------

def static_lock_edges(paths: Sequence = ()) -> set:
    """The named-lock edges of the static lock-order graph of the port."""
    from .concurrency import concurrency_for
    from .project import ProjectInfo
    project, errors = ProjectInfo.from_paths(
        list(paths) or [REPO_ROOT / "drynx_tpu_torch"])
    if errors:
        raise SystemExit(f"unparseable files: {errors}")
    return concurrency_for(project).named_lock_edges()


def check_locks(out: dict, static: set) -> List[str]:
    bad = []
    if not (out["acquires"] > 0 and out["shed"] > 0 and out["completed"] > 0):
        bad.append(f"vacuous run: acquires {out['acquires']}, shed "
                   f"{out['shed']}, completed {out['completed']}")
    observed = {tuple(e) for e in out["edges"]}
    if not observed:
        bad.append("the shed path exhibited no named-lock nesting")
    missing = observed - static
    if missing:
        bad.append(f"observed lock-order edges missing from the static "
                   f"graph: {sorted(missing)} (static: {sorted(static)})")
    return bad


def check_bytes(a: dict, b: dict) -> List[str]:
    from .dettrace import divergence
    bad = []
    for snap in (a["snapshot"], b["snapshot"]):
        keys = set(snap["records"])
        for prefix in ("transcript:", "epsilon.journal:", "proofdb:pane:"):
            if not any(k.startswith(prefix) for k in keys):
                bad.append(f"no {prefix} write recorded")
        if not set(snap["laundered"]) & keys:
            bad.append("no laundered key recorded")
    diverged = divergence(a["snapshot"], b["snapshot"], exempt=BYTES_EXEMPT)
    if diverged:
        bad.append(f"same-seed runs diverged at {diverged}")
    for key in ("launches", "rows"):
        if a[key] != b[key]:
            bad.append(f"the two runs' {key} differ: {a[key]} / {b[key]}")
    return bad


def check_lifecycles(out: dict) -> List[str]:
    from .prototrace import coverage, violations
    snap = out["snapshot"]
    bad = list(violations(snap))
    cover = coverage(snap)
    need = LIFECYCLE_MIN
    if len(cover) < need["kinds"] or sum(cover.values()) < need["events"] \
            or any(cover.get(k, 0) < need[k] for k in ("slab", "conn",
                                                          "ckpt")):
        bad.append(f"coverage {cover} below {need}")
    return bad


def spawn(which: str, device: str,
          stdout=subprocess.PIPE) -> subprocess.Popen:
    """Start one child, its recorder armed; its JSON line goes to
    `stdout` (a pipe unless a file is given)."""
    env = dict(os.environ, **{ENV[which]: "1"})
    return subprocess.Popen(
        [sys.executable, "-m", "drynx_tpu_torch.analysis.crosscheck",
         which, "--device", device], cwd=str(REPO_ROOT), env=env,
        stdout=stdout, text=True)


def result(proc: subprocess.Popen, which: str) -> dict:
    """Wait for a child and parse its line; raises if it failed."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"the {which} child exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m drynx_tpu_torch.analysis.crosscheck")
    ap.add_argument("which", choices=sorted(RUNS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from . import dettrace, locktrace, prototrace
    armed = {"locks": locktrace, "bytes": dettrace, "lifecycles": prototrace}
    if not armed[args.which].installed():
        print(f"{ENV[args.which]}=1 did not arm the recorder",
              file=sys.stderr)
        return 2
    out = RUNS[args.which](args.device)
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
