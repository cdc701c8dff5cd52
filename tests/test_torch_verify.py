"""Range-proof verification of the PyTorch port against the JAX reference, on
the CPU, and its five new kernels on the card.

The plain versions of the verification kernels (Fp12 inverse, cyclotomic
square, the slot multiplications, the windowed power and the Miller loop)
against the reference's jnp functions; the pairing after the final
exponentiation against the reference's `batching.pair`; and the verifying
nodes' joint check of payloads that the reference created, fed the same
bytes on both sides: both packages accept them, both reject the same
tampered payload, and under one seeded weight draw the port's RLC total
equals the reference's byte for byte. The two forgery regressions of the
reference's tests/test_range_proof.py are rebuilt with the port's own
functions. Every comparison is exact. The wrappers' calls of the joint and
the per-value checks are counted against chip_smoke.py's launch constants,
and a fault of a kernel or the card is shown to propagate out of the
verifier while an error a payload can cause stays contained.

The reference is reached through the module-scoped `reference` fixture of
tests/test_torch_range_proof.py (the `jax.enable_x64` stand-in); its GT
operations on the CPU go through its host oracle, not a jitted pairing.
The new kernels are held against their plain versions on the card by the
`gpu` tests of tests/test_torch_port.py, which imports no JAX.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import fp12 as JF12
from drynx_tpu.crypto import params, refimpl
from drynx_tpu_torch.crypto import cuda_pairing as CP
from drynx_tpu_torch.crypto import field as TF
from drynx_tpu_torch.crypto import fp2 as TF2
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import gt as TGT
from drynx_tpu_torch.crypto import pairing as TP
from drynx_tpu_torch.crypto import refimpl as trefimpl
from drynx_tpu_torch.proofs import range_proof as TRP
from drynx_tpu_torch.utils import cuda_build
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import g2 as TG2
from drynx_tpu_torch.proofs import encoding as TENC
from test_torch_range_proof import (NS, RANGES, SIG_SEED, STATS, U, L, _rand,
                                    _t)
from test_torch_range_proof import reference  # noqa: F401  (a fixture)

P, N = params.P, params.N
GTB = refimpl.pair(refimpl.G1, refimpl.G2)


@pytest.fixture(scope="module", autouse=True)
def _lean_torch():
    """The plain versions are thousands of small tensor ops, so their time
    is torch's per-op overhead: beside JAX's CPU threads in this process,
    torch's thread pool only contends (the module runs 2-3x slower with
    it), and inference mode, which no test here leaves, drops the autograd
    bookkeeping (a quarter of a verification's time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _members(ks):
    """GPhi12 members gtB^k as (len(ks), 6, 2, 16) limbs."""
    return TF12.from_ref_batch([refimpl.fp12_pow(GTB, k) for k in ks])


def _fp12_vals(rng, n):
    return [tuple(tuple(_rand(rng, 2, P)) for _ in range(6)) for _ in range(n)]


def _np(x):
    return np.asarray(x).astype(np.int32)


# ---------------------------------------------------------------------------
# Plain kernel versions against the reference
# ---------------------------------------------------------------------------

def test_f12_inv_plain_matches_reference():
    """Arbitrary values, a GPhi12 member and 0 (which maps to 0)."""
    rng = np.random.default_rng(21)
    a = torch.cat([TF12.from_ref_batch(_fp12_vals(rng, 3)), _members([5]),
                   torch.zeros(1, 6, 2, 16, dtype=torch.int32)])
    want = _np(JF12.inv(jnp.asarray(a.numpy().astype(np.uint32))))
    assert np.array_equal(CP.f12_inv_flat(a).numpy(), want)
    assert np.array_equal(TF12.inv(a).numpy(), want)
    assert not want[-1].any()


def test_f12_slotmul_plain_matches_reference(reference):
    from drynx_tpu.crypto import pairing as JP

    rng = np.random.default_rng(22)
    a = TF12.from_ref_batch(_fp12_vals(rng, 3))
    ja = jnp.asarray(a.numpy().astype(np.uint32))
    for which, want in (("frob1", JP._frob1(ja)), ("frob2", JP._frob2(ja)),
                        ("frob3", JP._frob3(ja)),
                        ("conj6", JF12.conj6(ja))):
        assert np.array_equal(CP.f12_slotmul_flat(a, which).numpy(),
                              _np(want)), which
    assert np.array_equal(TP._frob1(a).numpy(), _np(JP._frob1(ja)))
    with pytest.raises(ValueError, match="slot map"):
        CP.f12_slotmul_flat(a, "frob4")


def test_f12_csqr_plain_matches_reference_on_gphi12():
    """On GPhi12 members the cyclotomic square is the square; elsewhere it
    is not (and the kernel need only equal its plain version there)."""
    a = _members([1, 7, N - 1])
    want = _np(JF12.sqr(jnp.asarray(a.numpy().astype(np.uint32))))
    assert np.array_equal(CP.f12_csqr_flat(a).numpy(), want)
    assert np.array_equal(TF12.csqr(a).numpy(), want)
    x = TF12.from_ref_batch(_fp12_vals(np.random.default_rng(23), 1))
    assert not torch.equal(CP.f12_csqr_flat(x), TF12.sqr(x))


# (n_bits, cyclotomic): 63 and 128 bits are the verifier's powers, 256 the
# generic one; exponents below 2^n_bits, drawn at random so that windows
# straddle limbs (window 5 reads bits 15-17, window 10 bits 30-32)
WPOW_CASES = [(63, True), (128, True), (256, True), (63, False), (256, False)]


def test_f12_wpow_plain_matches_reference_pow_var():
    """Every case in one call of the reference's pow_var (n_bits = 256 on
    exponents below 2^n_bits is its n_bits-bit power): GPhi12 members for
    the cyclotomic cases, arbitrary values for the others. The port's
    fp12.pow_var is the reference's algorithm."""
    rng = np.random.default_rng(24)
    fs, ks, gots = [], [], []
    for i, (n_bits, cyc) in enumerate(WPOW_CASES):
        f = (_members([3 + i, 11 + i]) if cyc
             else TF12.from_ref_batch(_fp12_vals(rng, 2)))
        k = [int.from_bytes(rng.bytes(32), "little") % (1 << n_bits),
             (1 << n_bits) - 1]
        kt = TF.from_int(k)
        gots.append(CP.f12_wpow_flat(f, kt, n_bits=n_bits, cyc=cyc))
        fs.append(f)
        ks.append(kt)
    f, k = torch.cat(fs), torch.cat(ks)
    want = JF12.pow_var(jnp.asarray(f.numpy().astype(np.uint32)),
                        jnp.asarray(k.numpy().astype(np.uint32)))
    assert np.array_equal(torch.cat(gots).numpy(), _np(want))
    assert np.array_equal(TF12.pow_var(f, k).numpy(), _np(want))
    assert CP.window3_digits(TF.from_int([0b111 << 15 | 0b101 << 30]),
                             11)[0, [5, 10]].tolist() == [0b111, 0b101]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f, k = _members([2]), TF.from_int([3])
    for n_bits in (0, 300):
        with pytest.raises(ValueError, match="n_bits"):
            CP.f12_wpow_flat(f, k, n_bits)
    with pytest.raises(ValueError, match="shape"):
        CP.miller_flat(k, k, k, k)


# ---------------------------------------------------------------------------
# The pairing
# ---------------------------------------------------------------------------

def test_pairing_after_final_exp_matches_reference(reference):
    """final_exp_flat(miller_plain(.)) and the port's readable pairing equal
    the reference's batching.pair bytes. Before the final exponentiation
    the kernel's Miller value differs from the reference's host Miller
    value (affine lines, other scalings). The readable form's add lines
    are the kernel's times -1; every doubling step squares the signs taken
    before it, and after the last one (the last bit of 6u + 2 is 0) only
    the two Frobenius lines follow, so its raw value is the kernel's."""
    from drynx_tpu.crypto import batching as JB

    g1 = [refimpl.g1_mul(refimpl.G1, k) for k in (3, 1000003)]
    g2 = [refimpl.g2_mul(refimpl.G2, k) for k in (7, 5550001)]
    mont = lambda v: TF.to_mont(TF.from_int(v))
    px = torch.stack([mont(p[0]) for p in g1])
    py = torch.stack([mont(p[1]) for p in g1])
    qx = torch.stack([TF2.from_ref(q[0]) for q in g2])
    qy = torch.stack([TF2.from_ref(q[1]) for q in g2])
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    want = _np(JB.pair(u32(px), u32(py), u32(qx), u32(qy)))
    m = CP.miller_flat(px, py, qx, qy)
    assert np.array_equal(CP.final_exp_flat(m).numpy(), want)
    assert np.array_equal(CP.pair_flat(px, py, qx, qy).numpy(), want)
    assert not np.array_equal(
        m.numpy(), _np(JB.miller(u32(px), u32(py), u32(qx), u32(qy))))
    m_ref = TP.miller_loop((px, py), (qx, qy))
    assert CP.ATE_BITS[-1] == 0 and torch.equal(m, m_ref)
    assert np.array_equal(TP.final_exp(m_ref).numpy(), want)
    assert [TF12.to_ref(x) for x in CP.final_exp_flat(m)] == [
        refimpl.pair(p, q) for p, q in zip(g1, g2)]


def test_gt_gates_accept_members_and_reject_the_cofactor_subgroup():
    a = _members([2, 9])
    eps = TF12.from_ref(trefimpl.gphi12_cofactor_element(13))[None]
    assert TGT.gt_membership_ok(a) and TGT.gt_order_ok(a)
    bad = TGT.gt_mul(a, eps)
    assert TGT.gt_membership_ok(bad) and not TGT.gt_order_ok(bad)
    x = TF12.from_ref_batch(_fp12_vals(np.random.default_rng(25), 1))
    assert not TGT.gt_membership_ok(x)
    prod = TGT.gt_reduce_prod(_members(range(1, 10)))     # padded to 64
    assert TF12.to_ref(prod) == refimpl.fp12_pow(GTB, 45)


# ---------------------------------------------------------------------------
# The verifying nodes' joint check, on payloads the reference created
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def payloads(reference):
    """The proofs-on collection of tests/test_torch_range_proof.py (2 DPs x
    3 values, 2 servers, u=4, l=2), created by the reference alone; with
    its draws, for the forgery."""
    JRP = reference
    rng = np.random.default_rng(SIG_SEED)
    jsigs = [JRP.init_range_sig(U, rng) for _ in range(NS)]
    _, ca_pub = JE.keygen(rng)
    ca_tbl = JE.pub_table(ca_pub).table
    k_enc, k_rp = jax.random.split(jax.random.PRNGKey(21))
    enc_rs = JE.random_scalars(k_enc, STATS.shape)
    shifted = STATS + U ** L // 2
    cts = JE.encrypt_ints_with_tables(JE.BASE_TABLE.table, ca_tbl,
                                      jnp.asarray(shifted), enc_rs)
    lists = JRP.create_range_proof_lists_batched(
        k_rp, shifted, enc_rs, cts, RANGES, {U: jsigs}, ca_tbl)
    n_proved = STATS.shape[0] * 2
    ks = jax.random.split(jax.random.split(k_rp)[1], 4)
    draws = [_t(JE.random_scalars(ks[i], shape)) for i, shape in enumerate(
        [(n_proved, L)] * 3 + [(NS, n_proved, L)])]
    proved = [0, 2]
    return dict(JRP=JRP, bytes=[lst.to_bytes() for lst in lists],
                pubs=[s.public for s in jsigs], ca_tbl=ca_tbl,
                ca_t=_t(ca_tbl), draws=draws,
                secrets=shifted[:, proved].reshape(-1),
                rs=_t(enc_rs)[:, proved].reshape(-1, 16))


def _zv_byte(buf: bytes) -> int:
    """Offset of the last (least significant) byte of the first Zv scalar
    in a one-batch payload."""
    n_idx = int(np.frombuffer(buf[16:24], dtype="<i8")[0])
    head = 32 + 8 * n_idx
    _u, l, V, _ns = np.frombuffer(buf[head:head + 32], dtype="<i8")
    return head + 32 + int(V) * (128 + 32 + 32 + 64) + int(V * l) * 32 + 31


def _tampered(buf: bytes) -> bytes:
    b = bytearray(buf)
    b[_zv_byte(buf)] ^= 1
    return bytes(b)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_wrapper_calls(monkeypatch) -> dict:
    """Count the calls of every kernel wrapper, by kernel: on the CPU the
    counts that the wrappers keep in `LAUNCHES` on the card."""
    from drynx_tpu_torch.crypto import cuda_ops

    counts = {}
    for mod in (cuda_ops, CP):
        for name in mod.LAUNCHES:
            def counted(*a, _fn=getattr(mod, f"{name}_flat"), _name=name,
                        **k):
                counts[_name] += 1
                return _fn(*a, **k)
            counts[name] = 0
            monkeypatch.setattr(mod, f"{name}_flat", counted)
    return counts


def test_port_accepts_reference_payloads_and_isolates_a_malformed_one(
        payloads, monkeypatch):
    """The launches are chip_smoke.py's joint-check constant, but for the
    folds: 16 digit proofs pad to 8^2 (two passes each), 13,500 to 8^5."""
    p = payloads
    counts = _count_wrapper_calls(monkeypatch)
    ok = TRP.verify_range_proof_payloads_joint(
        p["bytes"] + [p["bytes"][0][:100]], RANGES, {U: p["pubs"]},
        p["ca_t"])
    assert ok == [True, True, False]
    assert counts == dict(_chip_smoke().EXPECTED_LAUNCHES_VERIFY,
                          f12_mulreduce8=2 + 2 * 2)


def test_both_packages_reject_the_same_tampered_payload(payloads):
    p = payloads
    datas = [p["bytes"][0], _tampered(p["bytes"][1])]
    want = p["JRP"].verify_range_proof_payloads_joint(
        datas, RANGES, {U: p["pubs"]}, p["ca_tbl"])
    got = TRP.verify_range_proof_payloads_joint(
        datas, RANGES, {U: p["pubs"]}, p["ca_t"])
    assert got == want == [True, False]


def test_rlc_total_equals_reference_under_a_shared_draw(payloads):
    """On the tampered batch (so the total is not one) the port's preamble
    draws the reference's weights and gtB power, and its GT total is the
    reference's, byte for byte."""
    p = payloads
    buf = _tampered(p["bytes"][1])
    jpb = p["JRP"].RangeProofList.from_bytes(buf).batches[0][1]
    tpb = TRP.RangeProofList.from_bytes(buf, "cpu").batches[0][1]
    j_ok, j_r, j_s = p["JRP"].rlc_prelude(jpb, p["pubs"], p["ca_tbl"],
                                          rng=np.random.default_rng(5))
    t_ok, t_r, t_s = TRP.rlc_prelude(tpb, p["pubs"], p["ca_t"],
                                     rng=np.random.default_rng(5))
    assert j_ok and t_ok and np.array_equal(j_r, t_r)
    assert np.array_equal(t_s.numpy(), _np(j_s))
    want = _np(p["JRP"].rlc_total_single(jpb, p["pubs"], j_r, j_s))
    got = TRP.rlc_total_single(tpb, p["pubs"], t_r, t_s)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, _np(JF12.one()))


def test_per_value_check_rejects_only_the_tampered_value(payloads,
                                                         monkeypatch):
    """Its launches are chip_smoke.py's per-value constant."""
    p = payloads
    pb = TRP.RangeProofList.from_bytes(_tampered(p["bytes"][1]),
                                       "cpu").batches[0][1]
    counts = _count_wrapper_calls(monkeypatch)
    assert TRP.verify_range_proofs(pb, p["pubs"], p["ca_t"]).tolist() == [
        False, True]
    assert counts == _chip_smoke().EXPECTED_LAUNCHES_PER_VALUE


# ---------------------------------------------------------------------------
# Forgery regressions (tests/test_range_proof.py:205 and :240)
# ---------------------------------------------------------------------------

def _joint_batch(payloads):
    lists = [TRP.RangeProofList.from_bytes(b, "cpu")
             for b in payloads["bytes"]]
    return TRP._concat_batches([lst.batches[0][1] for lst in lists])


def test_rlc_small_order_forgery_rejected(payloads):
    """a := -a makes every RLC factor -1, an order-2 element; a is bound
    into the challenge, so the recomputed challenge rejects it whatever the
    weights."""
    p = payloads
    pb = _joint_batch(p)
    bad = dataclasses.replace(pb, a=TF.neg(pb.a), wire=None)
    for seed in range(2):
        assert not TRP.verify_range_proofs_batch(
            bad, p["pubs"], p["ca_t"], rng=np.random.default_rng(seed)), seed


class _FixedRng:
    """Weight 0 of server 0, value 0 is r0, every other weight 1."""

    def __init__(self, r0):
        self.r0 = r0

    def integers(self, lo, hi, size=None, dtype=None):
        r = np.full(size, 1, dtype=dtype)
        r[0, 0, 0] = self.r0
        return r


def test_rlc_cofactor_forgery_rejected(payloads, monkeypatch):
    """A commit-first forger multiplies a[0, 0, 0] by a 13th root of unity
    of GPhi12's cofactor subgroup before the challenge is hashed, then
    answers honestly. The binding, the D equation and the GPhi12 gate pass;
    without the order gate a weight divisible by 13 accepts; with it,
    every draw rejects."""
    p = payloads
    pb = _joint_batch(p)
    eps = TF12.from_ref(trefimpl.gphi12_cofactor_element(13))
    a = pb.a.clone()
    a[0, 0, 0] = TF12.mul(a[0, 0, 0], eps)
    wire = dict(pb.wire, a=TENC.gt_bytes(a))
    sum_y = None
    for y in p["pubs"]:
        sum_y = refimpl.g1_add(sum_y, y)
    c = TRP.challenge_from_wire(wire, TRP._g1_bytes_host(sum_y), U, L)
    digits = torch.from_numpy(TRP.to_base(p["secrets"], U, L)).long()
    s, t, m, v = p["draws"]
    m_tot = m[:, 0]
    for j in range(1, L):
        m_tot = TF.add(m_tot, m[:, j], TF.FN)
    zphi, zr, zv = TRP._response_kernel(digits, c, p["rs"], s, t, m_tot, v)
    forged = dataclasses.replace(pb, challenge=c, zr=zr, zphi=zphi, zv=zv,
                                 a=a, wire=wire)
    assert TRP._challenge_ok(forged, p["pubs"]).all()
    assert TRP._d_equation_ok(forged, p["ca_t"]).all()
    assert TGT.gt_membership_ok(forged.a) and not TGT.gt_order_ok(forged.a)
    with monkeypatch.context() as mp:
        mp.setattr(TGT, "gt_order_ok", lambda _a: True)
        assert TRP.verify_range_proofs_batch(forged, p["pubs"], p["ca_t"],
                                             rng=_FixedRng(13))
    assert not TRP.verify_range_proofs_batch(forged, p["pubs"], p["ca_t"],
                                             rng=_FixedRng(13))


# ---------------------------------------------------------------------------
# Kernel failures are faults, not verdicts
# ---------------------------------------------------------------------------

def test_kernel_error_propagates_and_other_errors_stay_contained(
        payloads, monkeypatch):
    p = payloads
    from drynx_tpu_torch.crypto import cuda_ops

    def fail(error):
        def raise_(*_a, **_k):
            raise error
        return raise_

    # a failed build or launch, a kernel that faulted while it ran (torch
    # reports it at a later call), the card's memory running out
    for fault in (cuda_build.KernelError("launch refused"),
                  RuntimeError("CUDA error: an illegal memory access was "
                               "encountered"),
                  torch.cuda.OutOfMemoryError("CUDA out of memory")):
        monkeypatch.setattr(cuda_ops, "scalar_mul_flat", fail(fault))
        with pytest.raises(type(fault), match=str(fault)):
            TRP.verify_range_proof_payloads_joint(p["bytes"], RANGES,
                                                  {U: p["pubs"]}, p["ca_t"])
    for crafted in (ValueError("crafted payload"),
                    RuntimeError("shapes cannot be multiplied")):
        monkeypatch.setattr(cuda_ops, "scalar_mul_flat", fail(crafted))
        assert TRP.verify_range_proof_payloads_joint(
            p["bytes"], RANGES, {U: p["pubs"]}, p["ca_t"]) == [False, False]
    monkeypatch.setattr(TRP.RangeProofList, "from_bytes",
                        fail(cuda_build.KernelError("no nvcc")))
    with pytest.raises(cuda_build.KernelError, match="no nvcc"):
        TRP.verify_range_proof_payloads_joint(p["bytes"], RANGES,
                                              {U: p["pubs"]}, p["ca_t"])


def test_build_and_launch_failures_raise_kernel_error(monkeypatch, tmp_path):
    with pytest.raises(cuda_build.KernelError, match="cudaError 9"):
        cuda_build.check(9, "f12_wpow")
    cuda_build.check(0, "f12_wpow")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _n: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(cuda_build.KernelError, match="nvcc not found"):
        cuda_build.nvcc_path()
    assert issubclass(cuda_build.KernelError, RuntimeError)


def test_decoding_round_trips_the_port_encoding(payloads):
    """from_bytes then to_bytes gives the payload back, infinity included
    (the wire's all-zero points)."""
    for buf in payloads["bytes"]:
        assert TRP.RangeProofList.from_bytes(buf, "cpu").to_bytes() == buf
    g1 = np.zeros((2, 64), np.uint8)
    g1[1] = TRP._g1_bytes_host(refimpl.G1)
    pts = TRP._g1_from_bytes(g1, "cpu")
    assert TC.to_ref(pts) == [None, refimpl.G1]
    g2 = np.zeros((1, 128), np.uint8)
    assert TG2.to_ref(TRP._g2_from_bytes(g2, "cpu")) == [None]
