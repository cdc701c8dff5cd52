"""The port's proof plane, bucket tiling and mesh collectives against the
reference's, on the CPU.

`parallel/proof_plane.py`: `shard_slices` and `tiles.proof_tile_shards`
equal to the reference's over a grid of (n, k, min_items); the DPs'
tiled encryption byte-equal to one dispatch; the policy
(the visible CUDA devices, a forced count); `dispatch_shards`' order,
staging and span keys. `parallel/collective.py`'s mesh half: the butterfly
(k a power of two) and the ring (otherwise) all-reduces of points equal
to the sequential sum after `normalize` on every shard, for k = 1..8;
`allreduce_scalar_mul` equal to the host product mod n.
`range_proof._safe_batch_verify`'s routing:
to the sharded verifier with the plane on, a non-fault exception sent to
the single-device verifier (counted when that one judges the batch), a
fault propagated. The placement under a faked second device: shard 0 on
the caller's device, results gathered to it, tiles kept on it.

Marked slow (plain ladders and pairings on the CPU, seconds each): the
key switch and obfuscation over a mesh decrypted; tiled
and sharded creation at u = 2, l = 2, 4 values, 2 CNs byte-equal to
monolithic creation and accepted by the reference's verifier (under the
module-scoped `enable_x64` stand-in of tests/test_torch_survey.py); the
RLC total by shards and over a mesh byte-equal to the single-device one
under a shared weight draw; the dry-run step against the flagship survey.
"""
import contextlib
import sys

import numpy as np
import pytest
import torch

from drynx_tpu.encoding import tiles as JT
from drynx_tpu.parallel import proof_plane as JPP
from drynx_tpu_torch.crypto import curve as C
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.crypto import field as F
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.crypto.field import FN, FP
from drynx_tpu_torch.encoding import tiles as TT
from drynx_tpu_torch.parallel import collective as col
from drynx_tpu_torch.parallel import proof_plane as plane
from drynx_tpu_torch.proofs import range_proof as TRP
from drynx_tpu_torch.utils import cuda_build


@pytest.fixture(autouse=True)
def _plane_policy():
    plane.set_shards(None)
    yield
    plane.set_shards(None)


# ---------------------------------------------------------------------------
# Policy, slices and tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 5, 13, 64, 100, 4097, 50000])
def test_shard_slices_and_tile_shards_equal_the_references(n):
    for k in (1, 2, 3, 4, 7, 8, 13, 16):
        for min_items in (1, 2, 5, 1000):
            got = plane.shard_slices(n, k, min_items)
            assert got == JPP.shard_slices(n, k, min_items)
            assert [b - a for a, b in got] == sorted(
                (b - a for a, b in got), reverse=True)
            assert sum(b - a for a, b in got) == n
    for tile in (0, 1, 3, 4096, 8192):
        assert (TT.proof_tile_shards(n, tile)
                == JT.proof_tile_shards(n, tile))
    assert TT.proof_tile_shards(50000, 4096) == 13
    assert TT.plan_tiles(10000, TT.auto_tile(10000)).n_tiles == 3


def test_tiled_encryption_equals_one_dispatch(monkeypatch):
    """service.encrypt_tiled above the threshold (lowered to 2, tile 2):
    three tiles of a 5-wide value axis, byte-equal to one dispatch."""
    from drynx_tpu_torch.service import service as TSV

    monkeypatch.setattr(TT, "TILE_THRESHOLD", 2)
    monkeypatch.setenv(TT.ENV_TILE, "2")
    assert TT.plan_tiles(5, TT.auto_tile(5)).tiles == ((0, 2), (2, 4),
                                                       (4, 5))
    _, pub = TE.keygen(np.random.default_rng(3))
    tbl = TE.pub_table(pub).table
    stats = torch.tensor([[3, -1, 0, 7, 2], [0, 5, -4, 1, 9]])
    rs = TE.random_scalars((2, 5), torch.Generator().manual_seed(2))
    got = TSV.encrypt_tiled(TE.BASE_TABLE.table, tbl, stats, rs)
    want = TE.encrypt_ints_with_tables(TE.BASE_TABLE.table, tbl, stats, rs)
    assert torch.equal(got, want)


def test_the_plane_is_the_visible_cuda_devices_unless_forced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plane.device_count() == 0
    assert plane.n_shards() == 1 and not plane.enabled()
    plane.set_shards(4)
    assert plane.n_shards() == 4 and plane.enabled()
    plane.set_shards(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert plane.n_shards() == 3 and plane.enabled()
    assert [plane.shard_device(i).index for i in range(5)] == [0, 1, 2, 0, 1]
    assert col.make_mesh() == tuple(torch.device("cuda", i)
                                    for i in range(3))
    assert col.make_mesh(4, device="cpu") == (torch.device("cpu"),) * 4


def test_shards_follow_the_callers_device(monkeypatch):
    """Two visible devices (faked): shard 0 runs on the caller's device
    and the results come back to it; tiles alone never leave it."""
    monkeypatch.setattr(plane, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert [plane.shard_device(i) for i in range(3)] == cuda + cuda[:1]
    assert [plane.shard_device(i, cuda[1]) for i in range(3)] == [
        cuda[1], cuda[0], cuda[1]]
    assert plane.shard_device(1, "cpu") == torch.device("cpu")
    # dispatch_shards gathers to the device shard 0's result lies on
    moved = []
    monkeypatch.setattr(plane, "_to",
                        lambda x, dev: moved.append(dev) or x)
    plane.dispatch_shards("Lead", lambda i, x: x, [(torch.ones(1),)] * 2)
    assert moved == [torch.device("cpu")] * 2

    # the commit stage: placed under the caller's device only when spread
    placed = []
    monkeypatch.setattr(plane, "put_shard",
                        lambda tree, i, lead=None: placed.append(
                            (i, lead)) or tree)
    monkeypatch.setattr(TRP, "_commit_kernel",
                        lambda d, s, t, m, v, *a: (d, m, v, v))
    d = torch.arange(5)
    v = torch.arange(10).reshape(2, 5)
    for spread in (False, True):
        placed.clear()
        D, m_tot, V_pts, a = TRP._commit_kernel_sharded(
            d, d, d, d, v, d, d, d, 2, 1, 3, spread=spread)
        assert torch.equal(D, d) and torch.equal(V_pts, v)
        assert placed == ([(i, d.device) for i in range(3)] if spread
                          else [])

    # create_range_proofs spreads iff the plane's count (or n_shards) > 1;
    # tiles decide the dispatch count alone otherwise
    monkeypatch.setattr(plane, "device_count", lambda: 1)
    seen = []

    def stop(*a, spread):
        seen.append((a[-1], spread))
        raise StopIteration

    monkeypatch.setattr(TRP, "_commit_kernel_sharded", stop)
    monkeypatch.setattr(TRP, "sig_gt_pow_tables", lambda sigs, dev: None)

    class _Sig:
        A = torch.zeros(1)

    z = torch.zeros((4, 16), dtype=torch.int32)
    draws = [z[:, None]] * 3 + [z[None, :, None]]
    for kw in ({"tile": 2}, {"tile": 0, "n_shards": 3}, {"tile": 0}):
        with pytest.raises(StopIteration):
            TRP.create_range_proofs(np.arange(4), z, z, [_Sig()], 2, 2,
                                    None, draws=draws, **kw)
    plane.set_shards(2)
    with pytest.raises(StopIteration):
        TRP.create_range_proofs(np.arange(4), z, z, [_Sig()], 2, 2, None,
                                draws=draws, tile=0)
    assert seen == [(2, False), (3, True), (1, False), (2, True)]


def test_dispatch_shards_order_staging_and_spans():
    plane.SHARD_TIMERS.clear()
    calls = []

    def stage(i, a, b):
        calls.append(("stage", i))
        return (torch.arange(a, b),)

    def fn(i, x):
        calls.append(("fn", i))
        return x * 2

    out = plane.dispatch_shards("Ph", fn, [(0, 2), (2, 5), (5, 6)],
                                prefetch=stage)
    assert calls == [("stage", 0), ("fn", 0), ("stage", 1), ("fn", 1),
                     ("stage", 2), ("fn", 2)]
    assert torch.equal(torch.cat(out), torch.arange(6) * 2)
    keys = set(plane.timers_snapshot())
    assert keys == ({f"Ph.shard{i}" for i in range(3)}
                    | {f"Ph.dispatch.shard{i}" for i in range(3)}
                    | {"Ph.enqueue#device_compute", "Ph.upload#host_glue",
                       "Ph.block#device_compute"})
    # without a prefetch stage fn takes the raw args
    assert plane.dispatch_shards("Q", lambda i, v: v + i, [(1,), (1,)]) == [
        1, 2]


# ---------------------------------------------------------------------------
# Mesh collectives
# ---------------------------------------------------------------------------

def _affine(pts):
    """normalize, then out of Montgomery form: canonical integers."""
    x, y, z = C.normalize(pts)
    return (F.to_int(F.from_mont(x, FP)).tolist(),
            F.to_int(F.from_mont(y, FP)).tolist(), z.tolist())


def _points(k, n=3):
    rng = np.random.default_rng(k)
    return [torch.stack([C.from_ref(refimpl.g1_mul(
        refimpl.G1, int(rng.integers(1, 1 << 40)))) for _ in range(n)])
        for _ in range(k)]


@pytest.mark.parametrize("k", range(1, 9))
def test_allreduce_group_add_equals_the_sequential_sum(k):
    xs = _points(k)
    # a point at infinity and a doubling among the summands
    xs[0][1] = C.infinity((), "cpu")
    if k > 1:
        xs[1][2] = xs[0][2]
    want = xs[0]
    for x in xs[1:]:
        want = C.add(want, x)
    got = col.allreduce_group_add(xs)
    assert len(got) == k
    # every shard's total, normalized in one call
    assert _affine(torch.stack(got)) == _affine(torch.stack([want] * k))


def test_allreduce_order_is_the_references():
    """The butterfly pairs shard i with i ^ 2^r, the ring takes shard
    i - 1's running value: recorded on symbols, not points."""
    cat = lambda a, b: f"({a}+{b})"
    assert col._allreduce(list("abcd"), cat) == [
        "((a+b)+(c+d))", "((b+a)+(d+c))", "((c+d)+(a+b))", "((d+c)+(b+a))"]
    assert col._allreduce(list("abc"), cat) == [
        "((a+c)+b)", "((b+a)+c)", "((c+b)+a)"]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_allreduce_scalar_mul_equals_the_host_product(k):
    rng = np.random.default_rng(k)
    vals = [[int.from_bytes(rng.bytes(40), "little") % params.N
             for _ in range(4)] for _ in range(k)]
    vals[0][3] = 0
    got = col.allreduce_scalar_mul([F.from_int(v) for v in vals])
    want = [int(np.prod([v[j] for v in vals], dtype=object) % params.N)
            for j in range(4)]
    for g in got:
        assert F.to_int(g).tolist() == want


@pytest.mark.slow
def test_obfuscate_and_keyswitch_collectives_on_a_mesh():
    rng = np.random.default_rng(3)
    x, pub = TE.keygen(rng)
    q, qpub = TE.keygen(rng)
    tbl = TE.pub_table(pub).table
    g = torch.Generator().manual_seed(1)
    vals = torch.tensor([0, 5, 0, 2], dtype=torch.int64)
    cts = TE.encrypt_ints_with_tables(TE.BASE_TABLE.table, tbl, vals,
                                      TE.random_scalars((4,), g))
    s = [TE.random_scalars((4,), g) for _ in range(3)]
    obf = col.obfuscate_collective([cts] * 3, s)
    for o in obf:
        zero = TE.decrypt_check_zero(o, TE.secret_to_limbs(x))
        assert zero.tolist() == [True, False, True, False]
    # the key switch by one server among three shards (the others
    # contribute the identity) decrypts under the querier's key
    zeros = torch.zeros(16, dtype=torch.int32)
    rs = [TE.random_scalars((4,), g), torch.zeros(4, 16, dtype=torch.int32),
          torch.zeros(4, 16, dtype=torch.int32)]
    sw = col.keyswitch_collective([cts] * 3,
                                  [TE.secret_to_limbs(x), zeros, zeros], rs,
                                  TE.pub_table(qpub).table)
    table = TE.DecryptionTable(limit=8)
    for ct in sw:
        dec, found = table.lookup(TE.decrypt_point(ct, TE.secret_to_limbs(q)))
        assert found.all() and dec.tolist() == [0, 5, 0, 2]


# ---------------------------------------------------------------------------
# The joint check's routing
# ---------------------------------------------------------------------------

class _Tbl:
    device = torch.device("cpu")


def test_safe_batch_verify_routes_to_the_plane(monkeypatch):
    from drynx_tpu_torch.parallel import proof_mesh as pm

    seen = []
    monkeypatch.setattr(pm, "rlc_verify_sharded",
                        lambda *a, **k: seen.append("sharded") or True)
    monkeypatch.setattr(TRP, "verify_range_proofs_batch",
                        lambda *a, **k: seen.append("single") or True)
    assert TRP._safe_batch_verify(None, [], _Tbl())
    plane.set_shards(4)
    assert TRP._safe_batch_verify(None, [], _Tbl())
    assert seen == ["single", "sharded"]


def test_sharded_failure_is_counted_and_checked_on_one_device(monkeypatch):
    from drynx_tpu_torch.parallel import proof_mesh as pm

    plane.set_shards(2)

    def boom(*a, **k):
        raise ValueError("plane bug")

    monkeypatch.setattr(pm, "rlc_verify_sharded", boom)
    monkeypatch.setattr(TRP, "verify_range_proofs_batch", lambda *a, **k: True)
    before = TRP.SHARDED_FALLBACKS
    assert TRP._safe_batch_verify(None, [], _Tbl())
    assert TRP.SHARDED_FALLBACKS == before + 1
    # a fault of the program or the card is no verdict: it propagates
    # from the sharded verifier, uncounted
    monkeypatch.setattr(pm, "rlc_verify_sharded", lambda *a, **k: (
        _ for _ in ()).throw(cuda_build.KernelError("launch failed")))
    with pytest.raises(cuda_build.KernelError):
        TRP._safe_batch_verify(None, [], _Tbl())
    assert TRP.SHARDED_FALLBACKS == before + 1
    # a payload that makes both verifiers raise fails for itself, and is
    # no fault of the sharded path: not counted
    monkeypatch.setattr(pm, "rlc_verify_sharded", boom)
    monkeypatch.setattr(TRP, "verify_range_proofs_batch", boom)
    assert TRP._safe_batch_verify(None, [], _Tbl()) is False
    assert TRP.SHARDED_FALLBACKS == before + 1
    # the single device's verdict stands, a rejection too, counted
    monkeypatch.setattr(TRP, "verify_range_proofs_batch",
                        lambda *a, **k: False)
    assert TRP._safe_batch_verify(None, [], _Tbl()) is False
    assert TRP.SHARDED_FALLBACKS == before + 2


# ---------------------------------------------------------------------------
# Slow: creation and the RLC total on real proofs
# ---------------------------------------------------------------------------

NS, U, L = 2, 2, 2


@contextlib.contextmanager
def _x64(flag=True):
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def reference():
    """The reference's range_proof module with the `jax.enable_x64`
    stand-in of tests/test_torch_survey.py, restored at teardown."""
    import jax

    import drynx_tpu.crypto as jcrypto

    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.proofs import range_proof
        yield range_proof
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


@pytest.fixture(scope="module")
def tiny():
    """Four values under u = 2, l = 2 against two CNs' signatures, with
    one set of draws, created monolithically."""
    from drynx_tpu_torch.service import service as TSV

    torch.set_num_threads(1)
    sigs = TSV.make_range_sigs(U, NS, seed=11, device="cpu")
    _, pub = TE.keygen(np.random.default_rng(3))
    tbl = TE.pub_table(pub).table
    g = torch.Generator().manual_seed(5)
    vals = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    rs = TE.random_scalars((4,), g)
    cts = TE.encrypt_ints_with_tables(TE.BASE_TABLE.table, tbl, vals, rs)
    draws = [TE.random_scalars(s, g)
             for s in ((4, L), (4, L), (4, L), (NS, 4, L))]
    mono = TRP.create_range_proofs(vals, rs, cts, sigs, U, L, tbl,
                                   draws=draws, tile=0)
    return dict(sigs=sigs, pub=pub, tbl=tbl, vals=vals, rs=rs, cts=cts,
                draws=draws, mono=mono)


@pytest.mark.slow
def test_tiled_and_sharded_creation_equal_monolithic(tiny, reference):
    t = tiny
    args = (t["vals"], t["rs"], t["cts"], t["sigs"], U, L, t["tbl"])
    plane.SHARD_TIMERS.clear()
    tiled = TRP.create_range_proofs(*args, draws=t["draws"], tile=3)
    assert {k for k in plane.timers_snapshot()
            if k.startswith("CreateShard.shard")} == {
        "CreateShard.shard0", "CreateShard.shard1"}
    sharded = TRP.create_range_proofs(*args, draws=t["draws"], n_shards=3)
    want = t["mono"].to_bytes()
    assert tiled.to_bytes() == want and sharded.to_bytes() == want
    lst = TRP.RangeProofList(4, [(np.arange(4), sharded)]).to_bytes()
    ok = reference.verify_range_proof_payloads_joint(
        [lst], [(U, L)] * 4, {U: [s.public for s in t["sigs"]]},
        np.asarray(t["tbl"]).astype(np.uint32))
    assert ok == [True]


@pytest.mark.slow
def test_sharded_rlc_totals_equal_the_single_device_total(tiny):
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.parallel import proof_mesh as pm

    t = tiny
    pubs = [s.public for s in t["sigs"]]
    pb = t["mono"]
    pre_ok, r_int, gtb_s = TRP.rlc_prelude(pb, pubs, t["tbl"],
                                           rng=np.random.default_rng(1))
    assert pre_ok
    single = TRP.rlc_total_single(pb, pubs, r_int, gtb_s)
    shards = pm.rlc_total_shards(pb, pubs, r_int, gtb_s, n_shards=3)
    spmd = pm.rlc_total_sharded(col.make_mesh(3, device="cpu"), pb, pubs,
                                r_int, gtb_s)
    assert torch.equal(shards, single) and torch.equal(spmd, single)
    assert bool(F12.eq(single, F12.one((), "cpu")))
    assert pm.rlc_verify_sharded(pb, pubs, t["tbl"], n_shards=2)
    # a changed Zv: rejected by the sharded verifier as by one device
    bad = TRP.RangeProofBatch.from_bytes(pb.to_bytes(), "cpu")
    bad.zv[1, 2, 0, 0] ^= 1
    assert not pm.rlc_verify_sharded(bad, pubs, t["tbl"], n_shards=2)
    assert not TRP.verify_range_proofs_batch(bad, pubs, t["tbl"])


@pytest.mark.slow
def test_dryrun_step_equals_the_flagship_survey():
    from drynx_tpu_torch import dryrun, flagship

    X, y, p = flagship.pima_shaped_problem(num_dps=5, n_records=8, d=2,
                                           max_iterations=5)
    setup = flagship.SurveySetup.create(n_servers=3, dlog_limit=400,
                                        device="cpu")
    stats, enc_rs, ks_rs = flagship.make_inputs(X, y, p, 5, 3,
                                                device="cpu")
    w0, dec0, found0 = flagship.build_pipeline(setup, p)(stats, enc_rs,
                                                          ks_rs)
    # 5 shards take the ring
    w, dec, found = dryrun.dryrun_step(setup, p, stats, enc_rs, ks_rs,
                                       mesh=col.make_mesh(5, device="cpu"))
    assert found.all() and torch.equal(dec, stats.sum(0).to(dec.dtype))
    assert torch.equal(dec, dec0)
    assert float((w - w0).abs().max()) <= 1e-3


def test_scalar_helpers_are_canonical():
    """allreduce_scalar_mul's Montgomery round trip leaves plain limbs."""
    a = F.from_int([7, params.N - 1])
    (p,) = col.allreduce_scalar_mul([a])
    assert F.to_int(p).tolist() == [7, params.N - 1]
    assert F.to_int(F.from_mont(F.to_mont(a, FN), FN)).tolist() == [
        7, params.N - 1]
