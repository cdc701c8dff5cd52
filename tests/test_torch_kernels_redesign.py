"""The plain versions of the two team kernels against the reference.

csrc/g1_ops.cu's fixed-base ladder gives each row a team of
cuda_ops.FIXED_BASE_TEAM lanes: each lane sums its run of consecutive
windows, then the run sums meet in a binary tree of complete adds. Its plain
version sums in the same order, which changes the Jacobian representative
of the result but not the point: here it equals the reference's sequential
jnp ladder and the host oracle as points, for window counts that cut the
runs in every way, and on crafted tables that send the tree's complete adds
through their double, P = -Q and infinity branches. csrc/miller.cu's Miller
loop adds only at the set bits of 6u + 2, as its plain version does: the
plain version followed by the final exponentiation equals the host pairing.
The kernels are held against these plain versions on the card
(tests/test_torch_port.py, chip_smoke.py phase 2).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import crafted_fixed_base_cases
from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import field as JF
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import fp2 as TF2
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import field as TF
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.utils import cuda_build

N = params.N


def test_fixed_base_team_constant_is_the_kernels():
    src = (cuda_build.CSRC / "g1_ops.cu").read_text()
    team = int(re.search(r"constexpr int kFixedBaseTeam = (\d+);",
                         src).group(1))
    assert team == cuda_ops.FIXED_BASE_TEAM
    assert 64 % team == 0 and team & (team - 1) == 0


@pytest.mark.parametrize("n_windows", [1, 3, 16, 17, 63, 64])
def test_tree_ordered_fixed_base_matches_reference(n_windows):
    """Scalars 0, 1, 15, 2^63, 2^64 - 1, all 0xF digits and random ones;
    the ladder reads the low n_windows digits, so the oracle takes k mod
    16^W."""
    rng = np.random.default_rng(n_windows)
    ks = [0, 1, 15, 1 << 63, (1 << 64) - 1, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") % N for _ in range(3)]
    k = JF.from_int(ks)
    table = np.asarray(JE.BASE_TABLE.table)
    want = JE._fixed_base_mul_jnp(jnp.asarray(table), jnp.asarray(k),
                                  n_windows)
    got = cuda_ops.fixed_base_mul_flat(torch.from_numpy(table.astype(
        np.int32)), torch.from_numpy(np.asarray(k).astype(np.int32)),
        n_windows)
    oracle = [refimpl.g1_mul(refimpl.G1, x % 16 ** n_windows % N)
              for x in ks]
    assert TC.to_ref(got) == TC.to_ref(torch.from_numpy(
        np.asarray(want).astype(np.int32))) == oracle


def _branches(p, q):
    """Which of padd's branches (p, q) take somewhere in the batch."""
    p, q = torch.broadcast_tensors(p, q)
    p_inf, q_inf = TC.is_infinity(p), TC.is_infinity(q)
    both = ~p_inf & ~q_inf
    return {"double": bool((both & TC.eq(p, q)).any()),
            "p = -q": bool((both & TC.eq(p, TC.neg(q))).any()),
            "infinity": bool((p_inf | q_inf).any())}


def test_crafted_tables_take_every_branch_of_the_tree(monkeypatch):
    """The tree's adds (those over fewer than FIXED_BASE_TEAM partials)
    meet a double, a point and its negation, and infinity; every result
    equals the host sum of the selected entries."""
    seen = {"double": False, "p = -q": False, "infinity": False}
    padd = cuda_ops.padd

    def spy(p, q):
        if p.shape[1] < cuda_ops.FIXED_BASE_TEAM:        # a tree level
            for name, hit in _branches(p, q).items():
                seen[name] |= hit
        return padd(p, q)

    monkeypatch.setattr(cuda_ops, "padd", spy)
    for name, table, k in crafted_fixed_base_cases(TC, TF, refimpl, "cpu"):
        got = cuda_ops.fixed_base_mul_flat(table, k)
        entries = [TC.to_ref(table[w]) for w in range(64)]
        want = []
        for kk in TF.to_int(k):
            acc = None
            for w in range(64):
                acc = refimpl.g1_add(acc, entries[w][(int(kk) >> 4 * w) & 15])
            want.append(acc)
        assert TC.to_ref(got) == want, name
        u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
        ref = JE._fixed_base_mul_jnp(u32(table), u32(k))
        assert TC.to_ref(torch.from_numpy(
            np.asarray(ref).astype(np.int32))) == want, name
    assert seen == {"double": True, "p = -q": True, "infinity": True}


def test_miller_plain_with_final_exp_is_the_host_pairing():
    """Three pairs, one of them (-G1, G2): the Miller value after the final
    exponentiation is the host pairing, so the loop's adds at the set bits
    of 6u + 2 (and only there) are the function's."""
    g1 = [refimpl.g1_mul(refimpl.G1, k) for k in (2, N - 1, 987654321)]
    g2 = [refimpl.g2_mul(refimpl.G2, k) for k in (3, 1, 123456789)]
    mont = lambda v: TF.to_mont(TF.from_int(v))
    px = torch.stack([mont(p[0]) for p in g1])
    py = torch.stack([mont(p[1]) for p in g1])
    qx = torch.stack([TF2.from_ref(q[0]) for q in g2])
    qy = torch.stack([TF2.from_ref(q[1]) for q in g2])
    with torch.inference_mode():
        got = cuda_pairing.final_exp_flat(cuda_pairing.miller_plain(
            px, py, qx, qy))
    assert sum(cuda_pairing.ATE_BITS) == 23 and len(cuda_pairing.ATE_BITS) \
        == 65
    assert [TF12.to_ref(x) for x in got] == [refimpl.pair(p, q)
                                             for p, q in zip(g1, g2)]
