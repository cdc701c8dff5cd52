"""The RLC batch check's pairing work over the proof plane's shards.

The port's counterpart of drynx_tpu/parallel/proof_mesh.py. The joint
range check (`range_proof.verify_range_proofs_batch`) accepts a batch iff

  finalexp( prod_ij M(r_ij (c y_i - Zphi_j B), V_ij) )
    * prod_ij conj6(a_ij)^r_ij * gtB^(sum_ij r_ij Zv_ij)  ==  1

and its Miller loops and GT powers are one flat batch. Each shard runs
them over a slice of the flattened (ns * V * l) digit proofs and reduces
its slice; the partial products combine, then the one shared final
exponentiation and the gtB power fold in as on one device. Fp12 products
are exact with canonical residues, so any grouping of the partials gives
the same bytes as `range_proof.rlc_total_single`.

Two ways to combine the partials, both from one process:
  * `rlc_total_shards` (the verifier's): `proof_plane.dispatch_shards`,
    then one product of the stacked partials;
  * `rlc_total_sharded`: every shard's partials, then the GT all-reduce of
    parallel/collective.py over the mesh's shards (the reference's "spmd"
    strategy, without shard_map: each shard holds the total at the end).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..crypto import cuda_pairing as CP
from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import fp12 as F12
from ..crypto import g2 as G2
from ..crypto import gt as GT
from ..crypto.gt import GT_SHAPE, gt_mul
from . import collective as col
from . import proof_plane as plane


def _g1_prep(proof, sigs_pub, r_int):
    """The full-batch G1 and G2 preparation both strategies share:
    r (c y_i - Zphi_j B) and the V points, affine, with conj6(a) and the
    weights r as scalars, each flattened to the N = ns * V * l digit
    proofs."""
    from ..proofs import range_proof as rp

    # the weights are drawn on the host: one upload, not a round trip
    r = eg.int_to_scalar(torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
        r_int).to(proof.zv.device))
    # the weights are 62-bit, so their ladder runs 16 windows, not 64
    px, py, _ = C.normalize(C.scalar_mul_short(rp._g1_args(proof, sigs_pub),
                                               r, 64))
    qx, qy, _ = G2.normalize(proof.v_pts)
    conj_a = F12.conj6(proof.a)
    n = int(np.prod(px.shape[:3]))
    return tuple(x.reshape((n,) + tuple(x.shape[3:]))
                 for x in (px, py, qx, qy, conj_a, r))


def _partials(px, py, qx, qy, ca, rr):
    """One shard's Miller product and a^r product, (6, 2, 16) each."""
    m = GT.miller(px, py, qx, qy)
    ar = GT.gt_pow64(ca, rr)
    return (GT.gt_reduce_prod(m.reshape((-1,) + GT_SHAPE)),
            GT.gt_reduce_prod(ar.reshape((-1,) + GT_SHAPE)))


def _finish(m_tot, a_tot, gtb_pow_s):
    """final_exp of the Miller product alone, then the a-product and the
    gtB power folded in by products (as rlc_total_single does)."""
    fe = CP.final_exp_flat(m_tot[None])
    return gt_mul(gt_mul(fe, a_tot[None]), gtb_pow_s.to(fe.device)[None])[0]


def rlc_total_shards(proof, sigs_pub, r_int, gtb_pow_s,
                     n_shards: Optional[int] = None):
    """The RLC check's (6, 2, 16) GT total by per-shard dispatch, each
    shard's Miller loops and a^r over its slice of the digit proofs (shard
    i on the plane's `shard_device(i, proof.zv.device)`), combined by one
    product on the proof's device. Byte-identical to
    `range_proof.rlc_total_single`."""
    prep = _g1_prep(proof, sigs_pub, r_int)

    def stage(i, a, b):
        return plane.put_shard(tuple(x[a:b] for x in prep), i,
                               prep[0].device)

    def total(i, *args):
        return _partials(*args)

    k = plane.n_shards() if n_shards is None else n_shards
    parts = plane.dispatch_shards(
        "VerifyShard", total, plane.shard_slices(int(prep[0].shape[0]), k),
        prefetch=stage)
    m_tot = GT.gt_reduce_prod(torch.stack([p[0] for p in parts]))
    a_tot = GT.gt_reduce_prod(torch.stack([p[1] for p in parts]))
    return _finish(m_tot, a_tot, gtb_pow_s)


def rlc_total_sharded(mesh, proof, sigs_pub, r_int, gtb_pow_s):
    """The RLC check's (6, 2, 16) GT total over `mesh`'s shards (a tuple of
    devices, `collective.make_mesh`): each shard's partial Miller and a^r
    products on its device, then the GT all-reduce
    (`collective._allreduce` with the Fp12 product) over the shards, then
    the final exponentiation of shard 0's Miller total. Byte-identical to
    `rlc_total_shards` and `range_proof.rlc_total_single`."""
    prep = _g1_prep(proof, sigs_pub, r_int)
    slices = plane.shard_slices(int(prep[0].shape[0]), len(mesh))
    parts = [_partials(*(x[a:b].to(mesh[i]) for x in prep))
             for i, (a, b) in enumerate(slices)]
    m_all = col._allreduce([p[0] for p in parts], gt_mul)
    a_all = col._allreduce([p[1] for p in parts], gt_mul)
    return _finish(m_all[0], a_all[0].to(m_all[0].device), gtb_pow_s)


# returns the host's verdict by design
def rlc_verify_sharded(proof, sigs_pub, ca_pub_table,  # drynx: noqa[host-sync-in-hot-path]
                       rng: Optional[np.random.Generator] = None, *,
                       n_shards: Optional[int] = None) -> bool:
    """One verdict for a RangeProofBatch with its pairing work sharded
    (`rlc_total_shards` at `n_shards`, None: the plane's count): the joint
    range path whenever the proof plane is enabled
    (`range_proof._safe_batch_verify` routes here). The acceptance
    preamble is the single-device verifier's (`range_proof.rlc_prelude`:
    the D equation, the challenge recomputed from the bytes, the GPhi12
    and order gates, the weights), and the total is byte-identical to the
    single-device one, so the verdicts are the same."""
    from ..proofs import range_proof as rp

    pre_ok, r_int, gtb_pow_s = rp.rlc_prelude(proof, sigs_pub, ca_pub_table,
                                              rng=rng)
    if not pre_ok:
        return False
    total = rlc_total_shards(proof, sigs_pub, r_int, gtb_pow_s,
                             n_shards=n_shards)
    return bool(F12.eq(total, F12.one((), total.device)))


__all__ = ["rlc_total_sharded", "rlc_total_shards", "rlc_verify_sharded"]
