"""The PyTorch port's crypto pool and epsilon ledger against the JAX
reference, on the CPU.

`drynx_tpu_torch.pool` keeps the reference's on-disk layout, ledger
events and `.npz` members: a slab, a table or an epsilon journal written
by either package is consumed or read by the other, and `key_digest` is
the same for the same key. Single consumption is load-bearing privacy
(reusing a DRO re-randomization mask across surveys lets a proof observer
cancel the masks and recover both permutations), so the reference's
double-consumption, crash-recovery and torn-ledger cases
(tests/test_pool.py) run against the port. The store and the ledger are
numpy and pure Python in both packages; the reference's crypto reaches
drynx_tpu/crypto/pallas_ops.py, which does not import under this jax, so
the module-scoped `reference` fixture installs the `jax.enable_x64`
stand-in of tests/test_torch_survey.py while this module runs and forgets
every reference module imported under it at teardown. Slab mechanics use
deposited arrays; the port's replenish computes real slabs on its plain
versions, on one torch thread.
"""
import hashlib
import json
import os
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from drynx_tpu_torch import pool as tpool
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.parallel import dro as TD
from drynx_tpu_torch.pool import replenish as TREP
from drynx_tpu_torch.proofs import range_proof as TRP
from test_torch_cluster import _x64

SLAB = 4


@pytest.fixture(scope="module")
def reference():
    """The reference's pool, elgamal and range-proof modules, importable
    on this jax while this module's tests run."""
    saved, threads = jax.enable_x64, torch.get_num_threads()
    before = set(sys.modules)
    jax.enable_x64 = _x64
    torch.set_num_threads(1)
    try:
        from drynx_tpu import pool
        from drynx_tpu.crypto import elgamal
        from drynx_tpu.proofs import range_proof
        yield SimpleNamespace(pool=pool, elgamal=elgamal,
                              range_proof=range_proof)
    finally:
        jax.enable_x64 = saved
        torch.set_num_threads(threads)
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


@pytest.fixture(autouse=True)
def _no_global_pool():
    """Each test controls its own active pool; never leak one."""
    tpool.activate(None)
    yield
    tpool.activate(None)


@pytest.fixture(scope="module")
def keypair():
    x, pub = TE.keygen(np.random.default_rng(42))
    return x, pub, TE.pub_table(pub)


def _slab(seed, elems=SLAB):
    """A slab-shaped pair of limb arrays (mechanics only)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, (elems, 2, 3, 16)).astype(np.uint32),
            rng.integers(0, 1 << 16, (elems, 16)).astype(np.uint32))


def _fill(pool, digest, n_slabs, elems=SLAB):
    return [pool.deposit_dro(digest, *_slab(i, elems))
            for i in range(n_slabs)]


def _walk(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            yield os.path.join(d, f)


# ---------------------------------------------------------------------------
# Store mechanics (reference tests/test_pool.py:53-175, against the port)
# ---------------------------------------------------------------------------

def test_deposit_consume_roundtrip(tmp_path, keypair):
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=8)
    dig = tpool.key_digest(keypair[2].table)
    _fill(pool, dig, 3, elems=8)
    assert pool.dro_balance(dig) == 24
    z, r = pool.consume_dro(dig, 10)
    # exact trim; the remaining tail of the second slab goes with it
    assert z.shape == (10, 2, 3, 16) and r.shape == (10, 16)
    assert pool.dro_balance(dig) == 8
    assert pool.counters["consumed"] == 2
    assert pool.try_consume_dro(dig, 9) is None
    with pytest.raises(tpool.InsufficientBalance):
        pool.consume_dro(dig, 9)


def test_consume_under_wrong_key_digest_finds_nothing(tmp_path, keypair):
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    _fill(pool, tpool.key_digest(keypair[2].table), 1)
    _, pub2 = TE.keygen(np.random.default_rng(43))
    other = tpool.key_digest(TE.pub_table(pub2).table)
    assert pool.dro_balance(other) == 0
    assert pool.try_consume_dro(other, 1) is None


def test_double_consumption_across_threads(tmp_path, keypair):
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    dig = tpool.key_digest(keypair[2].table)
    (sid,) = _fill(pool, dig, 1)
    wins, raises = [], []
    barrier = threading.Barrier(8)

    def claim():
        barrier.wait()
        try:
            pool.consume_slab(dig, sid)
            wins.append(1)
        except tpool.DoubleConsumption:
            raises.append(1)

    ts = [threading.Thread(target=claim) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(wins) == 1 and len(raises) == 7


def test_double_consumption_across_restart(tmp_path, keypair):
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    dig = tpool.key_digest(keypair[2].table)
    (sid,) = _fill(pool, dig, 1)
    pool.consume_slab(dig, sid)
    pool2 = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    with pytest.raises(tpool.DoubleConsumption):
        pool2.consume_slab(dig, sid)
    assert pool2.dro_balance(dig) == 0


def test_crash_recovery_discards_partials_and_claimed(tmp_path, keypair):
    """A writer killed mid-write leaves a *.tmp; a consumer killed between
    tombstone and release leaves a *.claimed. Reopen discards both, and the
    claimed slab stays tombstoned across later reopens."""
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    dig = tpool.key_digest(keypair[2].table)
    _fill(pool, dig, 2)
    live = pool._live_slabs(dig)
    assert len(live) == 2
    with open(os.path.join(os.path.dirname(live[0]),
                           "slab_deadbeef.npz.tmp"), "wb") as f:
        f.write(b"partial garbage")
    os.rename(live[0], live[0] + ".claimed")
    claimed_sid = os.path.basename(live[0])[len("slab_"):-len(".npz")]

    pool2 = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    assert pool2.dro_balance(dig) == SLAB
    assert pool2.counters["recovered"] == 1
    assert not any(p.endswith((".tmp", ".claimed"))
                   for p in _walk(str(tmp_path)))
    pool3 = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    with pytest.raises(tpool.DoubleConsumption):
        pool3.consume_slab(dig, claimed_sid)


def test_ledger_survives_torn_tail(tmp_path, keypair):
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    dig = tpool.key_digest(keypair[2].table)
    (sid,) = _fill(pool, dig, 1)
    pool.consume_slab(dig, sid)
    with open(pool._ledger_path, "a", encoding="utf-8") as f:
        f.write('{"ev": "cons')        # torn
    pool2 = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    with pytest.raises(tpool.DoubleConsumption):
        pool2.consume_slab(dig, sid)


@pytest.mark.parametrize("mmap", ["on", "off"])
def test_sig_tables_read_lazily_either_way(tmp_path, monkeypatch, mmap):
    """DRYNX_POOL_MMAP (the reference's switch between mapped and eager
    reads) gives the same arrays."""
    monkeypatch.setenv("DRYNX_POOL_MMAP", mmap)
    pool = tpool.CryptoPool(str(tmp_path))
    a = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    pool.save_sig("fb", "abc", table=a)
    got = pool.load_sig("fb", "abc")
    assert got.keys() == ["table"] and "table" in got and len(got) == 1
    assert np.array_equal(got["table"], a)
    assert isinstance(got["table"], np.memmap) == (mmap == "on")
    assert pool.load_sig("fb", "missing") is None


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def test_key_digest_is_the_references(reference, keypair):
    _, pub, tbl = keypair
    with _x64(False):
        ref_tbl = reference.elgamal.pub_table(pub).table
    assert np.array_equal(np.asarray(ref_tbl).astype(np.int32),
                          tbl.table.numpy())
    assert tpool.key_digest(tbl.table) == reference.pool.key_digest(ref_tbl)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_slabs_cross_packages(reference, tmp_path, keypair, writer):
    """A slab deposited by one package is consumed by the other, once: the
    same arrays, the claim journaled, a second claim refused by a restart
    of either package."""
    dig = tpool.key_digest(keypair[2].table)
    mods = {"reference": reference.pool, "port": tpool}
    other = "port" if writer == "reference" else "reference"
    src = mods[writer].CryptoPool(str(tmp_path), slab_elems=SLAB)
    z, r = _slab(5)
    if writer == "port":
        sid = src.deposit_dro(dig, torch.from_numpy(z.astype(np.int32)),
                              torch.from_numpy(r.astype(np.int32)))
    else:
        sid = src.deposit_dro(dig, z, r)
    dst = mods[other].CryptoPool(str(tmp_path), slab_elems=SLAB)
    assert dst.dro_balance(dig) == SLAB
    gz, gr = dst.consume_slab(dig, sid)
    assert gz.dtype == np.uint32 and np.array_equal(gz, z)
    assert np.array_equal(gr, r)
    for mod in mods.values():
        with pytest.raises(mod.DoubleConsumption):
            mod.CryptoPool(str(tmp_path)).consume_slab(dig, sid)
    with open(os.path.join(tmp_path, "ledger.jsonl")) as f:
        events = [json.loads(line)["ev"] for line in f]
    assert events == ["deposit", "consume"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_epsilon_journal_crosses_packages(reference, tmp_path, writer):
    """A journal written by either package's EpsilonLedger is read by the
    other: the same spend, the same refusal at the budget."""
    mods = {"reference": reference.pool, "port": tpool}
    other = "port" if writer == "reference" else "reference"
    led = mods[writer].EpsilonLedger(str(tmp_path), budget=1.0)
    led.charge("dp0", "c", 0.25)
    led.charge("dp0", "c", 0.5)
    led.charge("dp1", "c", 1.0)
    with pytest.raises(mods[writer].EpsilonExhausted):
        led.charge("dp1", "c", 0.01)
    with open(os.path.join(tmp_path, "epsilon.jsonl"), "a") as f:
        f.write('{"ev": "cons')        # torn tail of a crashed append
    back = mods[other].EpsilonLedger(str(tmp_path), budget=1.0)
    assert back.spent("dp0", "c") == 0.75 and back.spent("dp1", "c") == 1.0
    assert back.remaining("dp0", "c") == 0.25
    assert back.check("dp0", "c", 0.25) and not back.check("dp0", "c", 0.26)
    with pytest.raises(mods[other].EpsilonExhausted):
        back.charge("dp1", "c", 0.01)
    assert back.charge("dp0", "c", 0.25) == 1.0


def test_epsilon_ledger_serializes_the_last_charge(tmp_path, monkeypatch):
    """Two threads racing the last slice of budget admit exactly one; a
    negative charge is refused; the default budget is the policy's, or
    DRYNX_EPSILON_BUDGET."""
    led = tpool.EpsilonLedger(str(tmp_path))
    monkeypatch.setenv("DRYNX_EPSILON_BUDGET", "0.5")
    led.charge("dp", "c", 0.3)
    wins, raises = [], []
    barrier = threading.Barrier(2)

    def charge():
        barrier.wait()
        try:
            led.charge("dp", "c", 0.2)
            wins.append(1)
        except tpool.EpsilonExhausted:
            raises.append(1)

    ts = [threading.Thread(target=charge) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(wins) == 1 and len(raises) == 1
    assert led.counters == {"charges": 2, "rejections": 1}
    with pytest.raises(tpool.PoolError):
        led.charge("dp", "c", -0.1)
    monkeypatch.delenv("DRYNX_EPSILON_BUDGET")
    assert led.remaining("dp2", "c") == 1.0


@torch.inference_mode()
def test_fixed_base_tables_cross_packages(reference, tmp_path):
    """The "fb" tenant: a table the port stores is loaded by the
    reference's pub_table without a build, and the other way round."""
    _, pub = TE.keygen(np.random.default_rng(44))
    _, pub2 = TE.keygen(np.random.default_rng(45))
    tpool.activate(tpool.CryptoPool(str(tmp_path)))
    reference.pool.activate(reference.pool.CryptoPool(str(tmp_path)))
    try:
        n = TE.FB_BUILD_COUNT
        port_tbl = TE.pub_table(pub)
        assert TE.FB_BUILD_COUNT == n + 1
        assert np.array_equal(TE.pub_table(pub).table, port_tbl.table)
        assert TE.FB_BUILD_COUNT == n + 1
        with _x64(False):
            m = reference.elgamal.FB_BUILD_COUNT
            got = reference.elgamal.pub_table(pub).table
            ref_tbl = reference.elgamal.pub_table(pub2).table
            assert reference.elgamal.FB_BUILD_COUNT == m + 1
        assert np.array_equal(np.asarray(got).astype(np.int32),
                              port_tbl.table.numpy())
        assert np.array_equal(TE.pub_table(pub2).table.numpy(),
                              np.asarray(ref_tbl).astype(np.int32))
        assert TE.FB_BUILD_COUNT == n + 1
    finally:
        reference.pool.activate(None)


@torch.inference_mode()
def test_signature_tables_cross_packages(reference, tmp_path):
    """The "gt" and "pow" tenants: the port's tables are stored under the
    reference's digests of A and read back by the reference with no
    pairing or host build; the reference's files are read by a fresh port
    RangeSig, the build counters flat."""
    seed, u = 7, 2
    port_sigs = [TRP.init_range_sig(u, np.random.default_rng(seed))]
    ref_sigs = [reference.range_proof.init_range_sig(
        u, np.random.default_rng(seed))]
    tpool.activate(tpool.CryptoPool(str(tmp_path / "a")))
    counts = dict(TRP.SIG_BUILD_COUNTS)
    gt = TRP.sig_gt_table(port_sigs, "cpu")
    T = TRP.sig_gt_pow_tables(port_sigs, "cpu")
    assert TRP.SIG_BUILD_COUNTS == {k: v + 1 for k, v in counts.items()}

    RP = reference.range_proof
    reference.pool.activate(reference.pool.CryptoPool(str(tmp_path / "a")))
    try:
        ref_counts = dict(RP.SIG_BUILD_COUNTS)
        with _x64(False):
            assert np.array_equal(np.asarray(RP.sig_gt_table(ref_sigs))
                                  .astype(np.int32), gt.numpy())
            assert np.array_equal(RP.sig_gt_pow_tables(ref_sigs)
                                  .astype(np.int32), T.numpy())
        assert RP.SIG_BUILD_COUNTS == ref_counts
    finally:
        reference.pool.activate(None)

    # the reference's files (its digests and members), read by the port
    store = reference.pool.CryptoPool(str(tmp_path / "b"))
    # one signature set: the "pow" digest (over every set's A) is the "gt"
    # digest of its one A
    key = hashlib.sha256(ref_sigs[0].A.tobytes()).hexdigest()
    store.save_sig("gt", key, gt=gt[0].numpy().astype(np.uint32))
    store.save_sig("pow", key, T=T.numpy().astype(np.uint32))
    tpool.activate(tpool.CryptoPool(str(tmp_path / "b")))
    fresh = [TRP.init_range_sig(u, np.random.default_rng(seed))]
    counts = dict(TRP.SIG_BUILD_COUNTS)
    assert torch.equal(TRP.sig_gt_pow_tables(fresh, "cpu"), T)
    assert torch.equal(TRP.sig_gt_table(fresh, "cpu"), gt)
    assert TRP.SIG_BUILD_COUNTS == counts


# ---------------------------------------------------------------------------
# Pooled randomness through the port's DRO
# ---------------------------------------------------------------------------

@torch.inference_mode()
def test_refill_to_deposits_fresh_slabs(tmp_path, keypair):
    """refill_to deposits slabs of fresh zero-encryptions (one fresh
    precomputation each, advancing the generator) under the key's digest
    until the balance covers the target. (A survey served from such a
    slab decrypts to its noise: tests/test_torch_dro.py.)"""
    _, _, tbl = keypair
    pool = tpool.CryptoPool(str(tmp_path), slab_elems=SLAB)
    dig = tpool.key_digest(tbl.table)
    gen = torch.Generator().manual_seed(3)
    calls = TD.PRECOMPUTE_CALLS
    assert TREP.refill_to(pool, gen, tbl.table, 2 * SLAB - 1) == 2
    assert TD.PRECOMPUTE_CALLS == calls + 2
    assert TREP.refill_to(pool, gen, tbl.table, 2 * SLAB) == 0
    assert TREP.refill_to(pool, gen, tbl.table, 9 * SLAB, max_slabs=1) == 1
    assert pool.stats()["slabs_live"] == 3
    (z0, r0), (z1, r1) = (pool.consume_dro(dig, SLAB) for _ in range(2))
    assert not np.array_equal(r0, r1)
    zero_ct, r = TD.to_device(z0, r0, "cpu")
    again = TD.precompute_rerandomization(tbl.table, SLAB, r=r)[0]
    assert torch.equal(again, zero_ct)
