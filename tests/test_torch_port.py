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
from drynx_tpu_torch.crypto import params, refimpl
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
], ids=["create", "from_numpy", "make_inputs", "entry"])
def test_entry_points_need_cuda_unless_the_cpu_is_named(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    g = C.from_ref(refimpl.G1)[None]
    two_g = cuda_ops.point_add_flat(g, g)
    assert C.to_ref(two_g) == [refimpl.g1_add(refimpl.G1, refimpl.G1)]
    assert {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES} == before


def test_kernel_build_targets_hopper_and_names_every_source():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-Xptxas -v" in flags
    for name in cuda_build.ENTRY_POINTS:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build.library_path(name).parent == cuda_build.BUILD_DIR
    sources = {p.stem for p in cuda_build.CSRC.glob("*.cu")}
    assert sources == set(cuda_build.ENTRY_POINTS)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fixed_base_mul", "scalar_mul",
                                    "point_reduce", "point_add", "fp_inv"])
def test_kernel_equals_plain_version_on_the_card(cuda, kernel):
    pts, ks = _operands(130, cuda)
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
    }
    kern, plain = calls[kernel]
    counts = {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}
    got = kern()
    torch.cuda.synchronize()
    assert {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}[kernel] == \
        counts[kernel] + 1
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
