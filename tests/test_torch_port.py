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

from drynx_tpu_torch import flagship
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as C
from drynx_tpu_torch.crypto import elgamal as eg
from drynx_tpu_torch.crypto import field as F
from drynx_tpu_torch.crypto import fp2 as F2
from drynx_tpu_torch.crypto import fp12 as F12
from drynx_tpu_torch.crypto import g2 as G2
from drynx_tpu_torch.crypto import params, refimpl
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
    short switch interval, 8 threads x 2,000 adds give exactly 16,000."""
    import threading

    counts = {"k": 0}
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cuda_build.count(counts, "k") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert counts["k"] == 16000


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
