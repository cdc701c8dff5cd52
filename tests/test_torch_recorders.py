"""The port's runtime recorders (drynx_tpu_torch/analysis/locktrace.py,
dettrace.py, prototrace.py) and their hook sites, on the CPU.

* locktrace records an edge between two named locks, none for an unnamed
  one, and keeps Condition, RLock re-entry and timed acquires working;
* dettrace's divergence finds a changed write, and the reference's
  divergence reads the port's snapshots the same way;
* in children started with the recorders armed (no crypto): the ConnPool
  echo conversation, the checkpoint cycles and a pool store's deposits,
  consumption and replay are accepted by the port's and the reference's
  automata; the ProofDB, journal and transcript hooks record their writes;
* slow: the three cross-check children of chip_smoke.py's phase 17 at the
  reference's sizes on the CPU, through the same gates (the card runs them
  in tests/test_torch_port.py, which imports no JAX).
"""
import json
import os
import subprocess
import sys
import threading

import pytest

from drynx_tpu.analysis import dettrace as ref_dettrace
from drynx_tpu.analysis import prototrace as ref_prototrace
from drynx_tpu_torch.analysis import REPO_ROOT, crosscheck, dettrace
from drynx_tpu_torch.analysis import locktrace, prototrace


@pytest.fixture
def traced_locks():
    locktrace.reset()
    locktrace.install()
    try:
        yield
    finally:
        locktrace.uninstall()
        locktrace.reset()


def test_locktrace_records_named_edges_only(traced_locks):
    from drynx_tpu_torch.resilience.policy import named_lock
    outer = named_lock("test_outer_lock")
    inner = named_lock("test_inner_lock", reentrant=True)
    plain = threading.Lock()
    with outer:
        with plain:
            with inner:
                with inner:                  # re-entry is not an edge
                    pass
    assert locktrace.observed_edges() == {("test_outer_lock",
                                           "test_inner_lock")}
    assert locktrace.acquisition_count() == 3


def test_locktrace_keeps_the_lock_protocols(traced_locks):
    lock = threading.Lock()
    assert lock.acquire(timeout=0.01)
    assert not lock.acquire(timeout=0.01)       # held: a timed acquire fails
    lock.release()
    lock._at_fork_reinit()                      # forwarded to the real lock
    assert not lock.locked()
    for make in (threading.Lock, threading.RLock):
        cond = threading.Condition(make())
        box = []

        def wait(cond=cond):
            with cond:
                box.append(cond.wait_for(lambda: len(box) > 0, timeout=5)
                           or "timeout")

        t = threading.Thread(target=wait)
        t.start()
        with cond:
            box.append("go")
            cond.notify_all()
        t.join(5)
        assert box[-1] is True, box


def test_dettrace_divergence_finds_a_changed_write():
    dettrace.reset()
    dettrace.install()
    try:
        dettrace.record("proofdb", "k", b"one")
        dettrace.record("transcript", "s0", b"lines", laundered=True)
        a = dettrace.snapshot()
        dettrace.reset()
        dettrace.record("proofdb", "k", b"two")
        dettrace.record("transcript", "s0", b"lines", laundered=True)
        b = dettrace.snapshot()
    finally:
        dettrace.uninstall()
        dettrace.reset()
    assert dettrace.divergence(a, a) == []
    assert dettrace.divergence(a, b) == ["proofdb:k"]
    assert dettrace.divergence(a, b, exempt=("proofdb:",)) == []
    # the reference reads the port's snapshots the same way
    assert ref_dettrace.divergence(a, b) == ["proofdb:k"]
    assert a["laundered"] == ["transcript:s0"]


def _child(env_var, body):
    env = dict(os.environ, **{env_var: "1"})
    proc = subprocess.run([sys.executable, "-c", body], cwd=str(REPO_ROOT),
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


_PROTO_CHILD = """\
import json, os, tempfile
import numpy as np
import drynx_tpu_torch
from drynx_tpu_torch.analysis import crosscheck, prototrace
from drynx_tpu_torch.pool import CryptoPool
assert prototrace.installed()
with tempfile.TemporaryDirectory() as td:
    root = os.path.join(td, "pool")
    store = CryptoPool(root, slab_elems=4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        store.deposit_dro("d0", rng.integers(0, 1 << 16, (4, 2, 3, 16)),
                          rng.integers(0, 1 << 16, (4, 16)))
    store.consume_dro("d0", 5)
    again = CryptoPool(root, slab_elems=4)
    assert again.dro_balance("d0") == 4, again.dro_balance("d0")
    again.consume_dro("d0", 1)
    crosscheck.checkpoint_cycle(td)
crosscheck.conversation()
print(json.dumps(prototrace.snapshot()))
"""


def test_prototrace_accepts_the_conn_ckpt_and_slab_lifecycles():
    snap = _child("DRYNX_PROTO_TRACE", _PROTO_CHILD)
    assert prototrace.violations(snap) == []
    cover = prototrace.coverage(snap)
    assert cover.get("conn", 0) >= 8 and cover.get("ckpt", 0) >= 2, cover
    assert cover.get("slab", 0) >= 3 and cover.get("atomic", 0) >= 3, cover
    assert crosscheck.check_lifecycles({"snapshot": snap}) == []
    # the reference's automata accept the port's snapshot, with the same
    # coverage
    assert ref_prototrace.violations(snap) == []
    assert ref_prototrace.coverage(snap) == cover


_DET_CHILD = """\
import json, os, tempfile
import drynx_tpu_torch
from drynx_tpu_torch.analysis import dettrace
from drynx_tpu_torch.pool import EpsilonLedger
from drynx_tpu_torch.server import survey_transcript
from drynx_tpu_torch.service.store import ProofDB
assert dettrace.installed()

class VN:
    name = "vn0"
    def stored_proofs(self, sid):
        return {"range/dp0": b"proof"}
    def bitmap_for(self, sid):
        return {"range/dp0": 1}

class VNs:
    vns = [VN()]

blob = survey_transcript(VNs(), "s0")
with tempfile.TemporaryDirectory() as td:
    ProofDB(os.path.join(td, "p.db")).put("pane:s0/0", blob)
    EpsilonLedger(os.path.join(td, "eps"), budget=1.0).charge("dp0", "c", 0.25)
print(json.dumps(dettrace.snapshot()))
"""


def test_dettrace_hooks_record_the_byte_identity_sinks():
    a = _child("DRYNX_DET_TRACE", _DET_CHILD)
    b = _child("DRYNX_DET_TRACE", _DET_CHILD)
    keys = set(a["records"])
    assert "transcript:s0" in keys and "proofdb:pane:s0/0" in keys, keys
    assert any(k.startswith("epsilon.journal:") for k in keys), keys
    assert set(a["laundered"]) == {k for k in keys
                                   if not k.startswith("proofdb:")}
    assert dettrace.divergence(a, b) == []
    assert ref_dettrace.divergence(a, b) == []


# -- the cross-checks of chip_smoke.py's phase 17 --------------------------------

def _run(which, device):
    proc = crosscheck.spawn(which, device)
    return crosscheck.result(proc, which)


@pytest.mark.slow
def test_locks_crosscheck_on_the_cpu():
    out = _run("locks", "cpu")
    assert crosscheck.check_locks(out, crosscheck.static_lock_edges()) == []


@pytest.mark.slow
def test_bytes_crosscheck_on_the_cpu():
    procs = [crosscheck.spawn("bytes", "cpu") for _ in range(2)]
    a, b = (crosscheck.result(p, "bytes") for p in procs)
    assert crosscheck.check_bytes(a, b) == []
    assert ref_dettrace.divergence(a["snapshot"], b["snapshot"],
                                   exempt=crosscheck.BYTES_EXEMPT) == []


@pytest.mark.slow
def test_lifecycles_crosscheck_on_the_cpu():
    out = _run("lifecycles", "cpu")
    assert crosscheck.check_lifecycles(out) == []
    assert ref_prototrace.violations(out["snapshot"]) == []
