"""The plain versions of the reduce (B3) and the slot maps (B11) against
the reference, on the crafted cases their kernels are held on.

csrc/g1_ops.cu's reduce gives each column a team of lanes that adds the
rows in order, 0 to R - 1, with team_ladder.cuh's complete add;
csrc/gt_ops.cu's slot map gives each Fp2 slot a thread of its own. Both
compute their plain versions' formulas on canonical residues, so the card
holds them against `point_reduce_plain` and `f12_slotmul_plain` byte for
byte (tests/test_torch_port.py, chip_smoke.py phase 2), on the cases made
by chip_smoke.crafted_reduce_cases and crafted_slotmul_cases. Here those
plain versions meet the JAX reference on the same cases: the reduce its
sequential complete add (`drynx_tpu.crypto.curve.add`), as points and limb
for limb wherever the sum is finite, and the host oracle, through every
branch of the complete add; the slot maps the reference's Frobenius maps
and conj6, byte for byte. The reference is reached through the `reference`
fixture of tests/test_torch_range_proof.py (the `jax.enable_x64`
stand-in).
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CLUSTER_ROWS, REDUCE_RS, SLOTMUL_NS,
                        crafted_reduce_cases, crafted_slotmul_cases)
from drynx_tpu.crypto import curve as JC
from drynx_tpu.crypto import fp12 as JF12
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.utils import cuda_build
from test_torch_inverse import _variants
from test_torch_range_proof import reference  # noqa: F401  (a fixture)


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.parametrize("r", REDUCE_RS)
def test_point_reduce_plain_matches_sequential_reference_add(reference, r):
    """The crafted chains: the reference's complete add over the rows in
    order gives the same points as the plain version and the host oracle,
    and the same limbs wherever the sum is finite."""
    pts = crafted_reduce_cases(TC, params, refimpl, r, "cpu")
    want = _u32(pts[0])
    for j in range(1, r):
        want = JC.add(want, _u32(pts[j]))
    want = torch.from_numpy(np.asarray(want).astype(np.int32))
    with torch.inference_mode():
        got = cuda_ops.point_reduce_flat(pts)
    rows = [TC.to_ref(pts[j]) for j in range(r)]
    oracle = [functools.reduce(refimpl.g1_add, col, None)
              for col in zip(*rows)]
    assert TC.to_ref(got) == TC.to_ref(want) == oracle
    fin = ~TC.is_infinity(want)
    assert torch.equal(got[fin], want[fin])
    assert oracle[6] is None and None not in (oracle[0], oracle[3])
    if r >= 2:
        assert oracle[5] is None and None not in oracle[1:3]


def test_crafted_reduce_cases_take_every_branch_of_the_complete_add(
        monkeypatch):
    """Each column's chain takes the branch its case names, at the add
    where it names it: row 0 at infinity (the first add's left operand),
    row r // 2 at infinity (its right operand), a double at the last add,
    P + (-P) at the first add and at the last, infinity at every add."""
    padd = cuda_ops.padd
    steps = []

    def spy(p, q):
        p, q = p.to(torch.int32), q.to(torch.int32)
        p_inf, q_inf = TC.is_infinity(p), TC.is_infinity(q)
        both = ~p_inf & ~q_inf
        steps.append({"p_inf": p_inf, "q_inf": q_inf,
                      "double": both & TC.eq(p, q),
                      "p = -q": both & TC.eq(p, TC.neg(q))})
        return padd(p.to(torch.int64), q.to(torch.int64))

    monkeypatch.setattr(cuda_ops, "padd", spy)
    for r in (2, 3, 10):
        steps.clear()
        with torch.inference_mode():
            cuda_ops.point_reduce_flat(crafted_reduce_cases(
                TC, params, refimpl, r, "cpu"))
        assert len(steps) == r - 1
        first, last, mid = steps[0], steps[-1], steps[r // 2 - 1]
        assert first["p_inf"][1] and not first["q_inf"][1]
        assert mid["q_inf"][2]
        assert last["double"][3]
        assert first["p = -q"][4] and last["p = -q"][5]
        assert all(s["p_inf"][6] and s["q_inf"][6] for s in steps)
        assert not any(s["double"][0] or s["p = -q"][0] or s["p_inf"][0]
                       or s["q_inf"][0] for s in steps)


def test_reduce_launch_is_recorded_with_its_r(monkeypatch):
    """On a CUDA tensor the wrapper counts one launch and records its shape
    as (R, N): the kernel's route up to the launch, with the launch itself
    and the device stood in for."""
    monkeypatch.setattr(cuda_build, "check_operands",
                        lambda *named: torch.device("cuda"))
    monkeypatch.setattr(cuda_ops, "_empty_points", lambda n, device:
                        torch.empty((n, 3, 16), dtype=torch.int32))
    launched = []
    monkeypatch.setattr(cuda_build, "launch",
                        lambda *args: launched.append(args[1]))
    monkeypatch.setitem(cuda_ops.LAUNCHES, "point_reduce", 0)
    monkeypatch.setattr(cuda_build, "LAUNCH_ROWS",
                        type(cuda_build.LAUNCH_ROWS)(
                            cuda_build.LAUNCH_ROWS.default_factory))
    pts = crafted_reduce_cases(TC, params, refimpl, 3, "cpu")
    cuda_ops.point_reduce_flat(pts)
    cuda_ops.point_reduce_flat(pts)
    assert launched == ["g1_point_reduce"] * 2
    assert cuda_ops.LAUNCHES["point_reduce"] == 2
    assert cuda_build.LAUNCH_ROWS["point_reduce"] == {(3, 7): 2}


def test_crafted_slotmul_rows_hold_the_edge_values():
    """Row 0 every slot 0, row 1 every limb p - 1, row 2 every slot the
    Montgomery -1, rows 3 and 4 those three beside seeded values, within
    one Fp2 slot too."""
    a = crafted_slotmul_cases(params, "cpu")
    top = torch.tensor(params.to_limbs(params.P - 1), dtype=torch.int32)
    minus1 = torch.tensor(params.to_limbs((params.P - 1) * params.R
                                          % params.P), dtype=torch.int32)
    assert a.shape == (7, 6, 2, 16)
    assert not a[0].any()
    assert (a[1] == top).all() and (a[2] == minus1).all()
    for row in a[3:5]:
        kinds = {"zero" if not x.any() else "top" if torch.equal(x, top)
                 else "minus1" if torch.equal(x, minus1) else "seeded"
                 for x in row.reshape(12, 16)}
        assert kinds == {"zero", "top", "minus1", "seeded"}
    limbs = a.long()
    assert bool((limbs >= 0).all()) and bool((limbs < 1 << 16).all())


@pytest.mark.parametrize("n", SLOTMUL_NS)
@pytest.mark.parametrize("which", cuda_pairing.SLOT_MAPS)
def test_f12_slotmul_plain_matches_reference_on_crafted_rows(reference,
                                                             which, n):
    from drynx_tpu.crypto import pairing as JP

    a = crafted_slotmul_cases(params, "cpu")[:n]
    ref = {"frob1": JP._frob1, "frob2": JP._frob2, "frob3": JP._frob3,
           "conj6": JF12.conj6}[which]
    want = np.asarray(ref(_u32(a))).astype(np.int32)
    with torch.inference_mode():
        got = cuda_pairing.f12_slotmul_flat(a, which)
    assert np.array_equal(got.numpy(), want)


def _kernel_body(src, kernel):
    body = src[src.index(f"    {kernel}("):]
    return body[:body.index("\n}\n")]


def test_reduce_and_slot_map_kernels_are_the_designs():
    """The reduce adds the rows in order 1 .. R - 1 onto row 0 with the
    team's complete add, 4 or 8 lanes a column; the slot map runs one
    thread a slot; the variants script times both at the cluster survey's
    shapes."""
    g1 = (cuda_build.CSRC / "g1_ops.cu").read_text()
    team = int(re.search(r"constexpr int kReduceTeam = (\d+);",
                         g1).group(1))
    assert team in (4, 8)
    body = _kernel_body(g1, "point_reduce_kernel")
    assert "team_column_sum(ReduceRows{pts, n}, r, out, n);" in body
    body = g1[g1.index("void team_column_sum("):]
    body = body[:body.index("\n}\n")]
    assert "for (int j = 1; j < r; ++j)" in body
    assert "acc = team_add(tm, acc, q);" in body
    assert "if (slot == 0) store_g1(" in body
    gt = (cuda_build.CSRC / "gt_ops.cu").read_text()
    assert "constexpr int kSlotmulSlots = 1;" in gt
    body = _kernel_body(gt, "f12_slotmul_kernel")
    assert "f2mul(conj ? f2conj(x) : x," in body
    tv = _variants()
    assert tv.REDUCE_SHAPES == tuple(sorted(CLUSTER_ROWS["point_reduce"]))
    assert tv.SLOT_SHAPES == tuple(sorted(CLUSTER_ROWS["f12_slotmul"]))
    assert {kind for _, kind, _, _ in tv.VARIANTS} >= {"reduce", "slotmul"}
