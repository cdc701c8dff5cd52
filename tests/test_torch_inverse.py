"""The Fp inverse's safegcd and the product teams' constants, on the CPU.

csrc/fp_inv.cuh inverts by Bernstein and Yang's constant-time divsteps in
libsecp256k1's 32-bit layout: 9 signed 30-bit limbs, 20 batches of 30
divsteps on the low 32 bits of f and g, each batch's transition matrix
applied to (f, g) and, modulo p, to (d, e), then d normalised into [0, p)
and multiplied by R^3 (one Montgomery product). `_safegcd` below models
that code word for word: 32-bit wrapping where the kernel wraps, the same
masks, the same 64-bit carries (checked to stay within int64). It is held
byte for byte against pow(y, p - 2, p), against the port's plain version
(`cuda_pairing.fp_inv_plain`, which the wrapper runs on CPU tensors) and
against the reference's Pallas `fp_inv_flat` in interpret mode, on edge
inputs (0 among them) and 1,000 residues from a numpy seed. The kernel is
held against the plain version on the card (tests/test_torch_port.py,
chip_smoke.py phase 2). The constants the kernel holds, and the team
constants of csrc/gt_ops.cu's product kernels that
scripts/torch_team_variants.py edits, are read from the sources.

The reference's pallas_pairing does not import under this jax (see
tests/test_torch_range_proof.py), so the `reference` fixture installs the
same `jax.enable_x64` stand-in for its test and forgets the Pallas modules
at teardown.
"""
import contextlib
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import drynx_tpu.crypto as jcrypto
from chip_smoke import (CLUSTER_ROWS, EXPECTED_LAUNCHES_CLUSTER,
                        fp_inv_edge_inputs)
from drynx_tpu_torch.crypto import cuda_pairing
from drynx_tpu_torch.crypto import field as F
from drynx_tpu_torch.crypto import params
from drynx_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parent.parent
P, R = params.P, params.R
M30, M32 = (1 << 30) - 1, (1 << 32) - 1
BATCHES, STEPS = 20, 30
# the kernel's constants, from Python
P30 = [(P >> (30 * i)) & M30 for i in range(8)] + [P >> 240]
PINV30 = pow(P, -1, 1 << 30)
R3 = pow(R, 3, P)


def _s32(x):
    """x as the int32 of its low 32 bits."""
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _i64(x):
    assert -(1 << 63) <= x < 1 << 63
    return x


def _divsteps(zeta, f, g):
    """inv_divsteps: 30 divsteps on the low 32 bits of f and g."""
    u, v, q, r = 1, 0, 0, 1
    f, g = f & M32, g & M32
    for _ in range(STEPS):
        assert f & 1
        m1 = (zeta >> 31) & M32
        m2 = -(g & 1) & M32
        x, y, z = (((a ^ m1) - m1) & M32 for a in (f, u, v))
        g, q, r = ((a + (b & m2)) & M32 for a, b in ((g, x), (q, y), (r, z)))
        m1 &= m2
        zeta = _s32(((zeta & M32) ^ m1) - 1)
        f, u, v = ((a + (b & m1)) & M32 for a, b in ((f, g), (u, q), (v, r)))
        g >>= 1
        u, v = (u << 1) & M32, (v << 1) & M32
    return zeta, tuple(_s32(a) for a in (u, v, q, r))


def _apply(t, a, b, modular):
    """inv_update_de (modular) or inv_update_fg: (t [a, b] (+ p [ma,
    mb])) / 2^30, limb by limb."""
    u, v, q, r = t
    ca = _i64(u * a[0] + v * b[0])
    cb = _i64(q * a[0] + r * b[0])
    ma = mb = 0
    if modular:
        sa, sb = a[8] >> 31, b[8] >> 31
        ma, mb = (u & sa) + (v & sb), (q & sa) + (r & sb)
        ma -= (PINV30 * (ca & M32) + (ma & M32)) & M30
        mb -= (PINV30 * (cb & M32) + (mb & M32)) & M30
        ca, cb = _i64(ca + P30[0] * ma), _i64(cb + P30[0] * mb)
    assert ca & M30 == 0 and cb & M30 == 0
    ca, cb = ca >> 30, cb >> 30
    na, nb = [0] * 9, [0] * 9
    for i in range(1, 9):
        ca = _i64(ca + u * a[i] + v * b[i] + P30[i] * ma)
        cb = _i64(cb + q * a[i] + r * b[i] + P30[i] * mb)
        na[i - 1], nb[i - 1] = ca & M30, cb & M30
        ca, cb = ca >> 30, cb >> 30
    assert _s32(ca) == ca and _s32(cb) == cb
    na[8], nb[8] = ca, cb
    return na, nb


def _normalize(d, sign):
    """inv_normalize: d in (-2p, p), negated if sign < 0, into [0, p)."""
    add, neg = d[8] >> 31, sign >> 31
    d = [((x + (p & add)) ^ neg) - neg for x, p in zip(d, P30)]
    for step in range(2):
        if step:
            add = d[8] >> 31
            d = [x + (p & add) for x, p in zip(d, P30)]
        for i in range(8):
            d[i + 1] += d[i] >> 30
            d[i] &= M30
    return d


def _safegcd(y):
    """fp_inv_safegcd on a canonical residue y: the kernel's output as an
    integer, x^-1 R for y = x R."""
    d, e = [0] * 9, [1] + [0] * 8
    f = list(P30)
    g = [(y >> (30 * i)) & M30 for i in range(8)] + [y >> 240]
    zeta = -1
    for _ in range(BATCHES):
        zeta, t = _divsteps(zeta, f[0], g[0])
        d, e = _apply(t, d, e, True)
        f, g = _apply(t, f, g, False)
    assert not any(g) and (y == 0 or f in ([1] + [0] * 8,
                                           [M30] * 8 + [-1]))
    d = _normalize(d, f[8])
    assert all(0 <= x <= M30 for x in d)
    dv = sum(x << (30 * i) for i, x in enumerate(d))
    assert dv < P
    return dv * R3 * pow(R, -1, P) % P        # mont_mul(d, R^3)


def _inputs():
    """The edge inputs (0, 1, p - 1, R mod p, powers of two), then 1,000
    residues from a numpy seed: (1,260, 16) limbs and their ints."""
    rng = np.random.default_rng(31)
    rand = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(1000)]
    x = torch.cat([fp_inv_edge_inputs(F, params, "cpu"), F.from_int(rand)])
    ints = [params.from_limbs(row) for row in x.tolist()]
    return x.to(torch.int32), ints


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def reference():
    """The reference's pallas_pairing, importable on this jax while this
    module's tests run."""
    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.crypto import pallas_pairing
        yield pallas_pairing
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


@pytest.fixture(scope="module")
def inverses():
    x, ints = _inputs()
    return x, ints, [_safegcd(y) for y in ints]


def test_edge_inputs_are_the_named_values():
    x, ints = _inputs()
    assert ints[:4] == [0, 1, P - 1, R % P]
    assert ints[4:260] == [1 << k for k in range(256)]
    assert len(ints) == 1260 and all(0 <= y < P for y in ints)


def test_safegcd_model_equals_the_fermat_power(inverses):
    """x^(p-2) in Montgomery form: y = x R maps to x^-1 R = y^(p-2) R^2;
    0 maps to 0."""
    _, ints, got = inverses
    assert got == [pow(y, P - 2, P) * R * R % P for y in ints]
    assert got[0] == 0 and got[3] == R % P


def test_safegcd_model_equals_the_plain_version(inverses):
    x, _, got = inverses
    want = cuda_pairing.fp_inv_flat(x)         # the plain version here
    assert want.dtype == torch.int32
    assert torch.equal(want, F.from_int(got).to(torch.int32))


def test_safegcd_model_equals_the_reference_kernel(reference, inverses):
    """The reference's Pallas fp_inv_flat, interpreted on the CPU."""
    x, _, got = inverses
    want = reference._fp_inv_flat(x.numpy().astype(np.uint32), True)
    assert np.array_equal(np.asarray(want).astype(np.int32),
                          F.from_int(got).to(torch.int32).numpy())


def _switch(body, fn):
    """The case values of `fn`'s switch in a source, in order."""
    block = body[body.index(f"{fn}(int i)"):]
    block = block[:block.index("}\n}")]
    return [int(v, 16) for v in re.findall(r"return (0x[0-9a-f]+)u?;", block)]


def test_safegcd_constants_are_the_sources():
    """p in signed 30-bit limbs, p^-1 mod 2^30, R^3 mod p as 8 words, and
    20 batches of 30 divsteps (600 >= 590, the bound for moduli below
    2^256 with the half-delta start) in csrc/fp_inv.cuh; fp_inv.cu
    launches that inverse."""
    src = (cuda_build.CSRC / "fp_inv.cuh").read_text()
    assert _switch(src, "p30") == P30
    assert sum(w << (30 * i) for i, w in enumerate(P30)) == P
    r3 = _switch(src, "r3_word")
    assert sum(w << (32 * i) for i, w in enumerate(r3)) == R3
    pinv = int(re.search(r"kPInv30 = (0x[0-9a-f]+)u;", src).group(1), 16)
    assert pinv == PINV30 and P * pinv % (1 << 30) == 1
    assert int(re.search(r"kInvBatches = (\d+);", src).group(1)) == BATCHES
    assert int(re.search(r"kInvSteps = (\d+);", src).group(1)) == STEPS
    assert BATCHES * STEPS >= 590 and P < 1 << 256
    kernel = (cuda_build.CSRC / "fp_inv.cu").read_text()
    assert '#include "fp_inv.cuh"' in kernel
    assert "fp_inv_safegcd(load_fp(" in kernel


def _variants():
    spec = importlib.util.spec_from_file_location(
        "torch_team_variants", ROOT / "scripts" / "torch_team_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_product_team_constants_are_the_kernels():
    """csrc/gt_ops.cu's Fp12 product and 8-way product share one team
    setup: kProdTeam lanes a row (a lane owns whole Fp2 slots), one-warp
    blocks and the same lane setup, slot loads and team product (the
    8-way product's registers capped, the Fp12 product's not); the
    variants script edits the lines that hold the team size, the register
    caps and the Fp inverse's block size, each found once."""
    src = (cuda_build.CSRC / "gt_ops.cu").read_text()
    team = int(re.search(r"constexpr int kProdTeam = (\d+);",
                         src).group(1))
    assert 6 % team == 0 and 32 // team >= 1
    for kernel, bounds in (("f12_mul_kernel", "32"),
                           ("f12_mulreduce8_kernel", "32, kProdWarpsPerSM")):
        body = src[src.index(f"    {kernel}("):]
        head = src[:src.index(f"    {kernel}(")].rsplit("\n", 2)[-2]
        body = body[:body.index("\n}\n")]
        assert head == f"__global__ void __launch_bounds__({bounds})"
        assert "prod_lane(n, xch, i, tm)" in body
        assert "team_f12mul(tm, r," in body
        assert "load_slots(" in body and "store_slots(" in body
    tv = _variants()
    assert tv.PROD_TEAM == f"constexpr int kProdTeam = {team};"
    for _, _, source, edit in tv.VARIANTS:
        if edit is not None:
            text = (cuda_build.CSRC / f"{source}.cu").read_text()
            assert text.count(edit[0]) == 1, (source, edit[0])
    assert tv.INV_SHAPES == tuple(sorted(CLUSTER_ROWS["fp_inv"]))


def test_cluster_row_counts_sum_to_the_launch_constants():
    """Phase 2 times B3, B4, B7, B10, B11 and B14 at the cluster survey's
    row counts (B3's as (R, N)), which phase 7 checks against the launches
    it records."""
    for name, rows in CLUSTER_ROWS.items():
        assert sum(rows.values()) == EXPECTED_LAUNCHES_CLUSTER[name]
        shapes = [n if name == "point_reduce" else (n,) for n in rows]
        assert all(len(sh) == (2 if name == "point_reduce" else 1)
                   for sh in shapes)
        assert all(isinstance(d, int) and d > 0 for sh in shapes
                   for d in sh)
    assert set(CLUSTER_ROWS) == {"point_reduce", "fp_inv", "f2_inv",
                                 "f12_mul", "f12_csqr", "f12_slotmul"}
