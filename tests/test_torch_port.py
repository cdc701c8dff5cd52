"""Package rules of the PyTorch port, and its kernels on the card.

The first tests run anywhere: the port imports neither JAX nor the JAX
package, its entry points run on the card unless the caller names the CPU,
and on CPU tensors the wrappers take the plain versions without counting a
launch. The tests marked `gpu` need a CUDA device and skip elsewhere (the
decision is taken in a fixture); they hold every kernel against its plain
version and the survey on the card against the survey on the CPU. This file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -o addopts= tests/test_torch_port.py -m gpu
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (REDUCE_RS, SLOTMUL_NS, WPOW_BITS,
                        crafted_csqr_cases, crafted_f2_inv_cases,
                        crafted_fixed_base_cases, crafted_g2_ladder_cases,
                        crafted_inv_cases, crafted_ladder_cases,
                        crafted_reduce_cases, crafted_slotmul_cases,
                        crafted_wpow_cases, fp_inv_edge_inputs)
from drynx_tpu_torch import flagship
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as C
from drynx_tpu_torch.crypto import elgamal as eg
from drynx_tpu_torch.crypto import field as F
from drynx_tpu_torch.crypto import fp2 as F2
from drynx_tpu_torch.crypto import fp12 as F12
from drynx_tpu_torch.crypto import g2 as G2
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.proofs import range_proof as rp
from drynx_tpu_torch.proofs import requests as rq
from drynx_tpu_torch.service import api
from drynx_tpu_torch.service import service as svc
from drynx_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "drynx_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+drynx_tpu\s*$|"
    r"import\s+drynx_tpu\.|from\s+drynx_tpu\.|from\s+drynx_tpu\s+import)",
    re.MULTILINE)


def test_port_sources_import_neither_jax_nor_the_reference():
    for path in PORT_FILES:
        assert not FORBIDDEN.search(path.read_text()), path


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(
        "drynx_tpu_torch." + str(p.relative_to(ROOT / "drynx_tpu_torch"))
        .replace("/", ".")[:-3].replace(".__init__", "")
        for p in (ROOT / "drynx_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'drynx_tpu' or m.startswith('drynx_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("call", [
    lambda: flagship.SurveySetup.create(n_servers=1, dlog_limit=2),
    lambda: flagship.SurveySetup.from_numpy(
        np.zeros((1, 16)), np.zeros((64, 16, 3, 16)), 1,
        np.zeros((64, 16, 3, 16)), np.zeros(4), np.zeros((4, 16)),
        np.zeros(4), np.zeros(4)),
    lambda: flagship.make_inputs(np.zeros((4, 2)), np.zeros(4, np.int64),
                                 flagship.pima_shaped_problem(1, 4, 2, 1)[2],
                                 num_dps=1),
    lambda: flagship.entry(),
    lambda: svc.make_range_sigs(u=4, n_servers=1),
    lambda: svc.LocalCluster(n_cns=1, n_dps=1, n_vns=0, dlog_limit=2),
    lambda: api.DrynxClient(n_cns=1, n_dps=1, n_vns=0, dlog_limit=2),
], ids=["create", "from_numpy", "make_inputs", "entry", "range_sigs",
        "cluster", "client"])
def test_entry_points_need_cuda_unless_the_cpu_is_named(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.fixture(scope="module")
def small_range_sigs():
    """One digit-signature set of base 2 with its GT tables, on the CPU."""
    sigs = [rp.init_range_sig(2, np.random.default_rng(3))]
    rp.sig_gt_pow_tables(sigs, "cpu")
    return sigs


@pytest.mark.parametrize("name", ["sig_gt_table", "sig_gt_pow_tables",
                                  "batch_from_bytes", "list_from_bytes"])
def test_range_proof_tables_and_decoders_need_cuda_unless_the_cpu_is_named(
        monkeypatch, small_range_sigs, name):
    """Without a device they take the card; named, the CPU."""
    batch = np.asarray([2, 1, 0, 0], "<i8").tobytes()    # u, l, V, ns
    payload = rp.RangeProofList(n_values=0, batches=[
        (np.arange(0), rp.RangeProofBatch.from_bytes(batch, "cpu"))
    ]).to_bytes()
    call = {"sig_gt_table": lambda *d: rp.sig_gt_table(small_range_sigs, *d),
            "sig_gt_pow_tables": lambda *d: rp.sig_gt_pow_tables(
                small_range_sigs, *d),
            "batch_from_bytes": lambda *d: rp.RangeProofBatch.from_bytes(
                batch, *d).to_bytes(),
            "list_from_bytes": lambda *d: rp.RangeProofList.from_bytes(
                payload, *d).to_bytes()}[name]
    want = call("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    got = call("cpu")
    assert (torch.equal(got, want) if isinstance(got, torch.Tensor)
            else got == want)
    if name.endswith("bytes"):
        assert got == (batch if name == "batch_from_bytes" else payload)


def _gt(k):
    """gtB^k on the host: (6, 2, 16) limbs."""
    return F12.from_ref(refimpl.fp12_pow(refimpl.pair(refimpl.G1, refimpl.G2),
                                         k))


@pytest.mark.parametrize("kernel", ["point_add", "f2_inv", "g2_scalar_mul",
                                    "f12_mul", "f12_mulreduce8", "f12_inv",
                                    "f12_wpow", "f12_pow"])
def test_cpu_tensors_take_the_plain_versions_without_counting(kernel):
    before = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    if kernel == "point_add":
        g = C.from_ref(refimpl.G1)[None]
        two_g = cuda_ops.point_add_flat(g, g)
        assert C.to_ref(two_g) == [refimpl.g1_add(refimpl.G1, refimpl.G1)]
    elif kernel == "f2_inv":
        x = F2.from_ref((5, 7))
        assert F2.to_ref(F2.mul(cuda_pairing.f2_inv_flat(x[None])[0], x)) \
            == (1, 0)
    elif kernel == "g2_scalar_mul":
        q = G2.from_ref(refimpl.G2)[None]
        out = cuda_pairing.g2_scalar_mul_flat(q, F.from_int([3]))
        assert G2.to_ref(out) == [refimpl.g2_mul(refimpl.G2, 3)]
    elif kernel == "f12_mul":
        out = cuda_pairing.f12_mul_flat(_gt(2)[None], _gt(3)[None])
        assert torch.equal(out[0], _gt(5))
    elif kernel == "f12_inv":
        out = cuda_pairing.f12_inv_flat(_gt(2)[None])
        assert torch.equal(out[0], _gt(params.N - 2))
    elif kernel == "f12_wpow":
        out = cuda_pairing.f12_wpow_flat(_gt(3)[None], F.from_int([100]),
                                         n_bits=63, cyc=True)
        assert torch.equal(out[0], _gt(300))
    elif kernel == "f12_pow":
        f, k = _gt(3)[None], F.from_int([0xABCDEF123456])
        out = cuda_pairing.f12_pow_flat(f, k, n_bits=48)
        assert torch.equal(out, F12.pow_var(f, k, 48))
        assert torch.equal(out[0], _gt(3 * 0xABCDEF123456))
    else:
        g = torch.stack([_gt(k) for k in range(1, 9)])[None]
        assert torch.equal(cuda_pairing.f12_mulreduce8_flat(g)[0], _gt(36))
    assert {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES} == before


def test_launch_counts_lose_no_update_across_threads():
    """Proof threads count launches beside the main thread: with a very
    short switch interval, 8 threads x 2,000 adds give exactly 16,000, and
    the launches' row counts as many."""
    import threading

    counts = {"k": 0}
    cuda_build.reset_launch_rows()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda r=r: [
            cuda_build.count(counts, "k", r) for _ in range(2000)])
            for r in (1, 90, 1, 13500, 1, 90, 1, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert counts["k"] == 16000
    assert cuda_build.LAUNCH_ROWS["k"] == {1: 10000, 90: 4000, 13500: 2000}
    cuda_build.reset_launch_rows()
    assert not cuda_build.LAUNCH_ROWS


def test_kernel_build_targets_hopper_and_names_every_source():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-Xptxas -v" in flags
    for name in cuda_build.ENTRY_POINTS:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build.library_path(name).parent == cuda_build.BUILD_DIR
    sources = {p.stem for p in cuda_build.CSRC.glob("*.cu")}
    assert sources == set(cuda_build.ENTRY_POINTS)
    assert {"g2_ops", "gt_ops", "miller"} <= sources
    assert set(cuda_build.ENTRY_POINTS["g2_ops"]) == {"g2_scalar_mul",
                                                      "f2_inv"}
    assert set(cuda_build.ENTRY_POINTS["gt_ops"]) == {
        "f12_mul", "f12_mulreduce8", "f12_inv", "f12_csqr", "f12_slotmul",
        "f12_wpow", "f12_pow"}
    assert set(cuda_build.ENTRY_POINTS["miller"]) == {"miller"}


def test_device_header_constants_match_params():
    """R mod p (one_word) in the tower header and 6u + 2 in csrc/miller.cu
    are the package's constants."""
    tower = (cuda_build.CSRC / "bn256_tower.cuh").read_text()
    body = tower[tower.index("one_word(int i)"):tower.index("fp_one()")]
    words = [int(w, 16) for w in re.findall(r"return (0x[0-9a-f]+)u;", body)]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == \
        params.R % params.P
    miller = (cuda_build.CSRC / "miller.cu").read_text()
    lo = int(re.search(r"kAteLo = (0x[0-9a-f]+)ull;", miller).group(1), 16)
    hi = int(re.search(r"kAteHi = (\d+)u;", miller).group(1))
    top = int(re.search(r"kAteTop = (\d+);", miller).group(1))
    ate = 6 * params.U + 2
    assert (hi << 64) + lo == ate and top + 2 == ate.bit_length()


def test_miller_frobenius_factors_match_refimpl():
    """kFrob in csrc/miller.cu: refimpl's twist factors of the Frobenius
    maps, Montgomery Fp2 as 8 x 32-bit words per coordinate."""
    src = (cuda_build.CSRC / "miller.cu").read_text()
    body = src[src.index("kFrob[3][2][NW] = {"):
               src.index("frob_factor(int k)")]
    vals = re.findall(r"0x([0-9a-f]{8})u|\b(0)u\b", body)
    words = [int(a, 16) if a else 0 for a, _ in vals]
    assert len(words) == 3 * 2 * 8
    want = [F2.from_ref(c) for c in (refimpl._G12, refimpl._G13,
                                     refimpl._G22)]
    for k, fp2 in enumerate(want):
        for c in range(2):
            limbs = fp2[c].tolist()
            assert words[16 * k + 8 * c:16 * k + 8 * c + 8] == [
                limbs[2 * i] | (limbs[2 * i + 1] << 16) for i in range(8)]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(n, device):
    rng = np.random.default_rng(7)
    ks = [int.from_bytes(rng.bytes(32), "little") % params.N for _ in range(n)]
    pts = C.from_ref_batch([refimpl.g1_mul(refimpl.G1, k + 1) for k in ks])
    return pts.to(device), F.from_int(ks).to(device)


# 16 a + 15 with 16 a = 15 (mod n): the ladder's last add is Q' + Q' with
# Q' = 15 Q, so it takes the complete add's doubling branch
K_LAST_ADD_DOUBLES = 16 * (15 * pow(16, -1, params.N) % params.N) + 15


def _g2_operands(n, device):
    """n twist points (the last at infinity) and their scalars: 0, n - 1,
    K_LAST_ADD_DOUBLES, then random ones."""
    rng = np.random.default_rng(8)
    ks = [0, params.N - 1, K_LAST_ADD_DOUBLES] + [
        int.from_bytes(rng.bytes(32), "little") % params.N
        for _ in range(n - 3)]
    pts = [refimpl.g2_mul(refimpl.G2, 5 + i) for i in range(n - 1)] + [None]
    return (torch.stack([G2.from_ref(p) for p in pts]).to(device),
            F.from_int(ks).to(device))


def _gt_operands(n, device):
    """n distinct GT elements gtB^(i + 2), built by host products."""
    base = refimpl.pair(refimpl.G1, refimpl.G2)
    out, cur = [], refimpl.fp12_mul(base, base)
    for _ in range(n):
        out.append(F12.from_ref(cur))
        cur = refimpl.fp12_mul(cur, base)
    return torch.stack(out).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fixed_base_mul", "scalar_mul",
                                    "point_reduce", "point_add", "fp_inv",
                                    "f2_inv", "g2_scalar_mul", "f12_mul",
                                    "f12_mulreduce8"])
def test_kernel_equals_plain_version_on_the_card(cuda, kernel):
    pts, ks = _operands(130, cuda)
    g2p, g2k = _g2_operands(130, cuda)
    gts = _gt_operands(160, cuda)
    base = eg.BASE_TABLE.table.to(cuda)
    q = pts.flip(0).clone()
    q[0], q[1], q[2] = pts[0], C.neg(pts[1:2])[0], C.infinity((), cuda)
    calls = {
        "fixed_base_mul": (lambda: cuda_ops.fixed_base_mul_flat(base, ks, 16),
                           lambda: cuda_ops.fixed_base_mul_plain(base, ks, 16)),
        "scalar_mul": (lambda: cuda_ops.scalar_mul_flat(pts, ks, 8),
                       lambda: cuda_ops.scalar_mul_plain(pts, ks, 8)),
        "point_reduce": (
            lambda: cuda_ops.point_reduce_flat(pts.reshape(2, 65, 3, 16)),
            lambda: cuda_ops.point_reduce_plain(pts.reshape(2, 65, 3, 16))),
        "point_add": (lambda: cuda_ops.point_add_flat(pts, q),
                      lambda: cuda_ops.point_add_plain(pts, q)),
        "fp_inv": (lambda: cuda_pairing.fp_inv_flat(pts[:, 2].contiguous()),
                   lambda: cuda_pairing.fp_inv_plain(pts[:, 2])),
        "f2_inv": (lambda: cuda_pairing.f2_inv_flat(g2p[:, 0].contiguous()),
                   lambda: cuda_pairing.f2_inv_plain(g2p[:, 0])),
        "g2_scalar_mul": (lambda: cuda_pairing.g2_scalar_mul_flat(g2p, g2k),
                          lambda: cuda_pairing.g2_scalar_mul_plain(g2p, g2k)),
        "f12_mul": (lambda: cuda_pairing.f12_mul_flat(gts[:130], gts[30:]),
                    lambda: cuda_pairing.f12_mul_plain(gts[:130], gts[30:])),
        "f12_mulreduce8": (
            lambda: cuda_pairing.f12_mulreduce8_flat(
                gts.reshape(20, 8, 6, 2, 16)),
            lambda: cuda_pairing.f12_mulreduce8_plain(
                gts.reshape(20, 8, 6, 2, 16))),
    }
    kern, plain = calls[kernel]
    counts = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    got = kern()
    torch.cuda.synchronize()
    assert {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}[kernel] == \
        counts[kernel] + 1
    assert torch.equal(got, plain())


def _verify_operands(device):
    """GT values (GPhi12 members and two that are not), 256-bit exponents,
    and 40 (P, Q) pairs in affine Montgomery limbs."""
    rng = np.random.default_rng(26)
    odd = [tuple(tuple(int.from_bytes(rng.bytes(40), "little") % params.P
                       for _ in range(2)) for _ in range(6)) for _ in range(2)]
    a = torch.cat([_gt_operands(128, device),
                   F12.from_ref_batch(odd).to(device)])
    k = F.from_int([int.from_bytes(rng.bytes(32), "little")
                    for _ in range(len(a))]).to(device)
    g1 = [refimpl.g1_mul(refimpl.G1, 5 + i) for i in range(40)]
    g2 = [refimpl.g2_mul(refimpl.G2, 9 + i) for i in range(40)]
    mont = lambda v: F.to_mont(F.from_int(v))
    pq = (torch.stack([mont(p[0]) for p in g1]),
          torch.stack([mont(p[1]) for p in g1]),
          torch.stack([F2.from_ref(q[0]) for q in g2]),
          torch.stack([F2.from_ref(q[1]) for q in g2]))
    return a, k, tuple(t.to(device) for t in pq)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["miller", "f12_inv", "f12_csqr",
                                    "f12_slotmul", "f12_wpow", "f12_pow"])
def test_verify_kernel_equals_plain_version_on_the_card(cuda, kernel):
    a, k, pq = _verify_operands(cuda)
    cp = cuda_pairing
    calls = {
        "miller": [(lambda: cp.miller_flat(*pq),
                    lambda: cp.miller_plain(*pq))],
        "f12_inv": [(lambda: cp.f12_inv_flat(a), lambda: cp.f12_inv_plain(a))],
        "f12_csqr": [(lambda: cp.f12_csqr_flat(a),
                      lambda: cp.f12_csqr_plain(a))],
        "f12_slotmul": [(lambda w=w: cp.f12_slotmul_flat(a, w),
                         lambda w=w: cp.f12_slotmul_plain(a, w))
                        for w in cp.SLOT_MAPS],
        "f12_wpow": [(lambda n=n, c=c: cp.f12_wpow_flat(a, k, n, cyc=c),
                      lambda n=n, c=c: cp.f12_wpow_plain(a, k, n, c))
                     for n, c in ((63, True), (128, True), (256, True),
                                  (63, False), (256, False))],
        "f12_pow": [(lambda n=n: cp.f12_pow_flat(a, k, n),
                     lambda n=n: F12.pow_var(a, k, n)) for n in (48, 256)],
    }
    for kern, plain in calls[kernel]:
        before = cp.LAUNCHES[kernel]
        got = kern()
        torch.cuda.synchronize()
        assert cp.LAUNCHES[kernel] == before + 1
        assert torch.equal(got, plain())


def _fixed_base_scalars(n, n_windows, device):
    rng = np.random.default_rng(n + n_windows)
    lim = min(params.N, 16 ** n_windows)
    ks = [int.from_bytes(rng.bytes(32), "little") % lim for _ in range(n)]
    return F.from_int(ks).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n_windows", [1, 16, 17, 64])
@pytest.mark.parametrize("n", [1, 90, 270, 900])
def test_fixed_base_team_kernel_equals_plain_version(cuda, n, n_windows):
    """The team kernel at the ladder's window counts and the main path's
    row counts (a team of cuda_ops.FIXED_BASE_TEAM lanes per row)."""
    base = eg.BASE_TABLE.table.to(cuda)
    k = _fixed_base_scalars(n, n_windows, cuda)
    got = cuda_ops.fixed_base_mul_flat(base, k, n_windows)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.fixed_base_mul_plain(base, k, n_windows))


@pytest.mark.gpu
def test_fixed_base_team_kernel_on_crafted_tables(cuda):
    for name, table, k in crafted_fixed_base_cases(C, F, refimpl, cuda):
        got = cuda_ops.fixed_base_mul_flat(table, k)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_ops.fixed_base_mul_plain(table, k)), name


def _miller_operands(n, device):
    """n affine pairs (k G1, m G2), made on the card by the ladders."""
    rng = np.random.default_rng(n)
    rand = lambda: F.from_int([int.from_bytes(rng.bytes(32), "little")
                               % params.N for _ in range(n)]).to(device)
    px, py, _ = C.normalize(cuda_ops.fixed_base_mul_flat(
        eg.BASE_TABLE.table.to(device), rand()))
    gen = G2.from_ref(refimpl.G2).to(device).expand(n, 3, 2, 16).contiguous()
    qx, qy, _ = G2.normalize(cuda_pairing.g2_scalar_mul_flat(gen, rand()))
    return px, py, qx, qy


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 13500])
def test_miller_team_kernel_equals_plain_version(cuda, n):
    """The team kernel (six lanes per pairing, 20 pairings per block) at
    one pairing, a ragged block count and the verifier's 13,500."""
    pq = _miller_operands(n, cuda)
    got = cuda_pairing.miller_flat(*pq)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.miller_plain(*pq))


@pytest.mark.gpu
@pytest.mark.parametrize("n_windows", [1, 2, 16, 64])
def test_ladder_team_kernel_on_crafted_cases(cuda, n_windows):
    """The variable-base team kernel on the crafted scalars (every branch
    of the complete add at W = 64) and the point at infinity."""
    pts, k = crafted_ladder_cases(C, F, refimpl, cuda)
    got = cuda_ops.scalar_mul_flat(pts, k, n_windows)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.scalar_mul_plain(pts, k, n_windows))


@pytest.mark.gpu
@pytest.mark.parametrize("n, n_windows", [
    (1, 64), (5, 64), (21, 64), (90, 64), (270, 64), (900, 64), (1080, 64),
    (2700, 64), (13500, 16)])
def test_ladder_team_kernel_at_main_path_shapes(cuda, n, n_windows):
    """The main path's shapes (decryption, key switch and its proof, the D
    equation, the key-switch check, c y, the RLC weighting at 16 windows)
    and partly filled last blocks."""
    pts, _ = _operands(130, cuda)
    p = pts.repeat((n + 129) // 130, 1, 1)[:n].contiguous()
    k = _fixed_base_scalars(n, n_windows, cuda)
    got = cuda_ops.scalar_mul_flat(p, k, n_windows)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.scalar_mul_plain(p, k, n_windows))


@pytest.mark.gpu
def test_g2_ladder_team_kernel_on_crafted_cases(cuda):
    """The G2 team kernel on the crafted scalars (every branch of the
    complete add) and the point at infinity."""
    p, k = crafted_g2_ladder_cases(G2, F, refimpl, cuda)
    got = cuda_pairing.g2_scalar_mul_flat(p, k)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.g2_scalar_mul_plain(p, k))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 21, 13500])
def test_g2_ladder_team_kernel_at_main_path_shapes(cuda, n):
    """V = v A[digit] on the collection's 13,500 digit proofs (full
    256-bit scalars) and partly filled last blocks."""
    g2p, _ = _g2_operands(130, cuda)
    p = g2p.repeat((n + 129) // 130, 1, 1, 1)[:n].contiguous()
    k = _fixed_base_scalars(n, 64, cuda)
    got = cuda_pairing.g2_scalar_mul_flat(p, k)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.g2_scalar_mul_plain(p, k))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [108000, 36000, 13500, 4500, 4096, 512, 64,
                               21, 8, 5, 1])
def test_mulreduce8_team_kernel_at_main_path_shapes(cuda, n):
    """The collection's fixed-base GT power passes (108,000 to 4,500 rows),
    the joint check's folds and gtB^S passes (4,096 to 1) and partly filled
    last blocks."""
    gts = _gt_operands(160, cuda)
    g = gts[(torch.arange(8 * n, device=cuda) * 37 + 11) % len(gts)]
    g = g.reshape(n, 8, 6, 2, 16)
    got = cuda_pairing.f12_mulreduce8_flat(g)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_mulreduce8_plain(g))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 21, 13500])
def test_f12_mul_team_kernel_at_main_path_shapes(cuda, n):
    """The final exponentiation's and the joint check's products (N = 1),
    the collection's a = gt1 gt2 (13,500 rows) and partly filled last
    blocks."""
    gts = _gt_operands(160, cuda)
    a = gts.repeat((n + 159) // 160, 1, 1, 1)[:n].contiguous()
    b = a.flip(0).contiguous()
    got = cuda_pairing.f12_mul_flat(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_mul_plain(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 21, 90, 128, 129, 13500])
def test_fp_inv_kernel_at_main_path_shapes(cuda, n):
    """The safegcd inverse (one row a thread, 32 a block) with a partly
    filled last block (1, 5, 21, 129), whole blocks (128), the
    decryption's 90 rows and the joint check's 13,500, on residues from a
    seed."""
    rng = np.random.default_rng(n)
    x = F.from_int([int.from_bytes(rng.bytes(40), "little") % params.P
                    for _ in range(n)]).to(cuda)
    got = cuda_pairing.fp_inv_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.fp_inv_plain(x))


@pytest.mark.gpu
def test_fp_inv_kernel_on_edge_inputs(cuda):
    """0 (which x^(p-2) maps to 0), 1, p - 1, R mod p and every power of
    two."""
    x = fp_inv_edge_inputs(F, params, cuda)
    got = cuda_pairing.fp_inv_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.fp_inv_plain(x))
    assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", WPOW_BITS)
def test_wpow_team_kernel_on_crafted_cases(cuda, n_bits):
    """The windowed-power team kernel on GPhi12 members and a non-member,
    with and without cyc, on exponents whose windows straddle limbs."""
    f, k = crafted_wpow_cases(F, F12, params, refimpl, cuda)
    for cyc in (True, False):
        got = cuda_pairing.f12_wpow_flat(f, k, n_bits, cyc=cyc)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f12_wpow_plain(f, k, n_bits,
                                                            cyc)), cyc


@pytest.mark.gpu
@pytest.mark.parametrize("n, n_bits", [(1, 63), (5, 63), (21, 63),
                                       (13500, 63), (13500, 128)])
def test_wpow_team_kernel_at_main_path_shapes(cuda, n, n_bits):
    """The final exponentiation's power by u (N = 1), a^r and the order
    gate (N = 13,500) and partly filled last blocks, on GPhi12 members."""
    gts = _gt_operands(160, cuda)
    f = gts.repeat((n + 159) // 160, 1, 1, 1)[:n].contiguous()
    k = _fixed_base_scalars(n, (n_bits + 3) // 4, cuda)
    got = cuda_pairing.f12_wpow_flat(f, k, n_bits, cyc=True)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_wpow_plain(f, k, n_bits, True))


@pytest.mark.gpu
@pytest.mark.parametrize("r", REDUCE_RS)
def test_reduce_team_kernel_on_crafted_cases(cuda, r):
    """The reduce's team kernel on the crafted chains (every branch of the
    complete add), seven columns: not a multiple of a block's."""
    pts = crafted_reduce_cases(C, params, refimpl, r, cuda)
    got = cuda_ops.point_reduce_flat(pts)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.point_reduce_plain(pts))


@pytest.mark.gpu
@pytest.mark.parametrize("r, n", [(1, 90), (1, 5), (3, 90), (3, 13),
                                  (10, 180), (10, 21)])
def test_reduce_team_kernel_at_main_path_shapes(cuda, r, n):
    """The canonical aggregate and the VN's check (R = 10 over 180
    columns), the key switch's sums (R = 3 over 90), a reduce of one row,
    and partly filled last blocks, on Jacobian multiples of B."""
    base = eg.BASE_TABLE.table.to(cuda)
    pts = cuda_ops.fixed_base_mul_flat(
        base, _fixed_base_scalars(r * n, 64, cuda)).reshape(r, n, 3, 16)
    got = cuda_ops.point_reduce_flat(pts)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.point_reduce_plain(pts))


@pytest.mark.gpu
@pytest.mark.parametrize("which", cuda_pairing.SLOT_MAPS)
def test_slotmul_kernel_on_crafted_rows(cuda, which):
    """One thread a slot on rows of zero slots, limbs at p - 1, -1 and
    mixed slots, at N in SLOTMUL_NS."""
    a = crafted_slotmul_cases(params, cuda)
    for n in SLOTMUL_NS:
        got = cuda_pairing.f12_slotmul_flat(a[:n], which)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f12_slotmul_plain(a[:n],
                                                               which)), n


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 13500])
def test_slotmul_kernel_at_main_path_shapes(cuda, n):
    """The final exponentiation's maps (N = 1), the joint check's gates
    (N = 13,500) and a partly filled block, every map, on GPhi12
    members."""
    gts = _gt_operands(160, cuda)
    a = gts.repeat((n + 159) // 160, 1, 1, 1)[:n].contiguous()
    for which in cuda_pairing.SLOT_MAPS:
        got = cuda_pairing.f12_slotmul_flat(a, which)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f12_slotmul_plain(a, which)), \
            which


@pytest.mark.gpu
def test_add_team_kernel_on_crafted_pairs(cuda):
    """The add's team kernel on the reduce's R = 2 pairs (every branch of
    the complete add), seven rows: not a multiple of a block's."""
    p, q = crafted_reduce_cases(C, params, refimpl, 2, cuda)
    got = cuda_ops.point_add_flat(p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.point_add_plain(p, q))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 90, 270, 810, 900, 13500])
def test_add_team_kernel_at_main_path_shapes(cuda, n):
    """The cluster survey's adds (90 ... 13,500 rows) and a partly filled
    block, on Jacobian multiples of B, with P + P, P + (-P) and infinity
    among the rows."""
    base = eg.BASE_TABLE.table.to(cuda)
    p = cuda_ops.fixed_base_mul_flat(base, _fixed_base_scalars(n, 64, cuda))
    q = p.flip(0).clone()
    q[0], q[1], q[2] = p[0], C.neg(p[1:2])[0], C.infinity((), cuda)
    got = cuda_ops.point_add_flat(p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_ops.point_add_plain(p, q))


@pytest.mark.gpu
def test_f12_inv_team_kernel_on_crafted_rows(cuda):
    """The inverse's team kernel on 0, 1, a Miller output, a seeded value,
    b = 0 and a = 0, each alone (one team) and all six in one launch."""
    a = crafted_inv_cases(F12, refimpl, cuda)
    for k in range(len(a)):
        got = cuda_pairing.f12_inv_flat(a[k:k + 1])
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f12_inv_plain(a[k:k + 1])), k
    got = cuda_pairing.f12_inv_flat(a)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_inv_plain(a))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 13500])
def test_f12_inv_team_kernel_at_main_path_shapes(cuda, n):
    """The final exponentiation's N = 1, the per-value check's 13,500 rows
    and a partly filled block, on the crafted rows and GPhi12 members."""
    a = torch.cat([crafted_inv_cases(F12, refimpl, cuda),
                   _gt_operands(160, cuda)])
    a = a.repeat((n + len(a) - 1) // len(a), 1, 1, 1)[:n].contiguous()
    got = cuda_pairing.f12_inv_flat(a)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_inv_plain(a))


@pytest.mark.gpu
def test_f2_inv_kernel_on_crafted_rows(cuda):
    """The Fp2 inverse on 0, 1, (a, 0), (0, b), -1 - i, the stored limbs
    (p - 1, p - 1) and seeded values, each alone and all nine in one
    launch."""
    x = crafted_f2_inv_cases(F2, params, cuda)
    for k in range(len(x)):
        got = cuda_pairing.f2_inv_flat(x[k:k + 1])
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f2_inv_plain(x[k:k + 1])), k
    got = cuda_pairing.f2_inv_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f2_inv_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 33, 13500])
def test_f2_inv_kernel_at_main_path_shapes(cuda, n):
    """The normalizations' 13,500 rows, a partly filled block and one row,
    on the G2 ladder's Z coordinates with the crafted rows among them."""
    g2p, g2k = _g2_operands(40, cuda)
    z = cuda_pairing.g2_scalar_mul_flat(g2p, g2k)[:, 2]
    x = torch.cat([crafted_f2_inv_cases(F2, params, cuda), z])
    x = x.repeat((n + len(x) - 1) // len(x), 1, 1)[:n].contiguous()
    got = cuda_pairing.f2_inv_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f2_inv_plain(x))


@pytest.mark.gpu
def test_csqr_team_kernel_on_crafted_rows(cuda):
    """The cyclotomic square's team kernel on 0, 1, the six unit slots, a
    GPhi12 member and values outside GPhi12, each alone (one team) and all
    eleven in one launch."""
    a = crafted_csqr_cases(F12, refimpl, cuda)
    for k in range(len(a)):
        got = cuda_pairing.f12_csqr_flat(a[k:k + 1])
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_pairing.f12_csqr_plain(a[k:k + 1])), k
    got = cuda_pairing.f12_csqr_flat(a)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_csqr_plain(a))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 13500])
def test_csqr_team_kernel_at_main_path_shapes(cuda, n):
    """The final exponentiation's N = 1, the per-value check's 13,500 rows
    and a partly filled block, on GPhi12 members and the crafted rows."""
    a = torch.cat([_gt_operands(160, cuda),
                   crafted_csqr_cases(F12, refimpl, cuda)])
    a = a.repeat((n + len(a) - 1) // len(a), 1, 1, 1)[:n].contiguous()
    got = cuda_pairing.f12_csqr_flat(a)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_pairing.f12_csqr_plain(a))


@pytest.mark.gpu
def test_survey_on_the_card_equals_the_survey_on_the_cpu(cuda):
    X, y, p = flagship.pima_shaped_problem(num_dps=2, n_records=16, d=2,
                                           max_iterations=10)
    out = {}
    for dev in ("cpu", cuda):
        setup = flagship.SurveySetup.create(n_servers=2, dlog_limit=200,
                                            device=dev)
        stats, enc_rs, ks_rs = flagship.make_inputs(X, y, p, 2, 2, device=dev)
        out[str(dev)] = [t.cpu() for t in
                         flagship.build_pipeline(setup, p)(stats, enc_rs,
                                                           ks_rs)]
    (w_c, dec_c, found_c), (w_g, dec_g, found_g) = out.values()
    assert bool(found_g.all()) and torch.equal(dec_g, dec_c)
    torch.testing.assert_close(w_g, w_c, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_proofs_on_survey_on_the_card_commits_a_clean_block(cuda):
    """The small proofs-on survey of tests/test_torch_cluster.py on the
    card: proof threads, kernels, a clean audit block."""
    cluster = svc.LocalCluster(n_cns=2, n_dps=2, n_vns=2, seed=3,
                               dlog_limit=300, device=cuda)
    rng = np.random.default_rng(3)
    data = [rng.integers(0, 16, size=6) for _ in range(2)]
    for dp, x in zip(cluster.dps.values(), data):
        dp.data = x
    sq = cluster.generate_survey_query("mean", query_min=0, query_max=15,
                                       proofs=1, ranges=[(16, 3)] * 2)
    before = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    res = cluster.run_survey(sq, seed=3)
    after = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    allv = np.concatenate(data)
    assert res.decrypted.found.all()
    assert res.decrypted.values.tolist() == [int(allv.sum()), len(allv)]
    bitmap = res.block.data.bitmap
    assert len(bitmap) == 12 and set(bitmap.values()) == {rq.BM_TRUE}
    assert after["miller"] > before["miller"]
    assert after["g2_scalar_mul"] > before["g2_scalar_mul"]
    cluster.close()
