"""Key-switch ZK proof: a server proves its contribution
(U, W) = (r·B, r·Q − x·K) is correct w.r.t. its public key Y = x·B.

The port's counterpart of drynx_tpu/proofs/keyswitch.py (unlynx
KeySwitchListProofCreation/Verification, reference
lib/proof/structs_proofs.go:420-492), with the same transcript, challenges
and wire bytes. One proof batch covers every (server, ciphertext) pair:
tensors are (ns, V, ...), and creation and verification are a few batched
launches of the G1 kernels.

Sigma protocol per (server i, value j), with K the original ciphertext's
randomness component and Q the target (querier) public key:
  commit    A1 = wr·B, A2 = wr·Q − wx·K, A3 = wx·B     (wr, wx fresh)
  challenge c = H(K ‖ U ‖ W ‖ Y ‖ Q ‖ A1 ‖ A2 ‖ A3)
  response  zr = wr + c·r,  zx = wx + c·x
  verify    zr·B == A1 + c·U
            zr·Q − zx·K == A2 + c·W
            zx·B == A3 + c·Y
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto.field import FN
from ..crypto.params import NUM_LIMBS
from . import encoding as enc
from .safe_pickle import TensorState


@dataclasses.dataclass
class KeySwitchProofBatch(TensorState):
    """(ns, V) key-switch contribution proofs."""

    orig_k: torch.Tensor   # (V, 3, 16) original ciphertext K components
    u_pts: torch.Tensor    # (ns, V, 3, 16) contributions rB
    w_pts: torch.Tensor    # (ns, V, 3, 16) contributions rQ − xK
    ys: torch.Tensor       # (ns, 3, 16) server publics
    q_pt: torch.Tensor     # (3, 16) target public key
    a1: torch.Tensor       # (ns, V, 3, 16)
    a2: torch.Tensor       # (ns, V, 3, 16)
    a3: torch.Tensor       # (ns, V, 3, 16)
    challenge: torch.Tensor  # (ns, V, 16)
    zr: torch.Tensor       # (ns, V, 16)
    zx: torch.Tensor       # (ns, V, 16)
    # As in the reference there is no wire-byte cache: the batch travels as
    # a pickle, where a cached encoding would be attacker-controlled, so
    # everything that needs the canonical bytes re-derives them from the
    # tensors through _wire_dict.

    def to_bytes(self) -> bytes:
        ns, V = int(self.u_pts.shape[0]), int(self.u_pts.shape[1])
        head = np.asarray([ns, V], dtype="<i8").tobytes()
        w = _wire_dict(self)
        parts = [w["k"], w["u"], w["w"], w["ys"], w["q"], w["a1"], w["a2"],
                 w["a3"],
                 enc.scalar_bytes(self.challenge), enc.scalar_bytes(self.zr),
                 enc.scalar_bytes(self.zx)]
        return head + b"".join(np.ascontiguousarray(p).tobytes()
                               for p in parts)


_WIRE_FIELDS = (("k", "orig_k"), ("u", "u_pts"), ("w", "w_pts"),
                ("ys", "ys"), ("q", "q_pt"), ("a1", "a1"), ("a2", "a2"),
                ("a3", "a3"))


def _wire_dict(pb: KeySwitchProofBatch) -> dict:
    """THE one definition of the canonical transcript encoding — creation,
    to_bytes and verification all call this so the Fiat-Shamir hash can
    never desynchronize between them. Every point goes through one
    normalization (one launch of the inversion kernel)."""
    pts = [getattr(pb, f) for _, f in _WIRE_FIELDS]
    b = enc.g1_bytes(torch.cat([p.reshape(-1, 3, NUM_LIMBS) for p in pts]))
    out, at = {}, 0
    for (key, _), p in zip(_WIRE_FIELDS, pts):
        n = p[..., 0, 0].numel()
        out[key] = b[at:at + n].reshape(p.shape[:-2] + (64,))
        at += n
    return out


def _challenge_from_wire(w: dict, ns: int, V: int) -> torch.Tensor:
    kb = np.broadcast_to(w["k"], (ns, V, 64))
    yb = np.broadcast_to(w["ys"][:, None, :], (ns, V, 64))
    qb = np.broadcast_to(w["q"], (ns, V, 64))
    return enc.hash_to_scalar(kb, w["u"], w["w"], yb, qb, w["a1"], w["a2"],
                              w["a3"], batch_shape=(ns, V))


def _mul_plain(a, b):
    """a * b mod n for plain scalar limbs (broadcast)."""
    return F.mont_mul(F.to_mont(a, FN), b, FN)


def _commit_kernel(orig_k, q_tbl, wr, wx, srv_x):
    """A1, A2, A3 and the server publics Y = x·B: one fixed-base launch for
    wr·B, wx·B and x·B, one for wr·Q, one ladder for wx·K, one add."""
    ns, V = wr.shape[:2]
    base = eg.BASE_TABLE.table.to(wr.device)
    fb = eg.fixed_base_mul(base, torch.cat([wr.reshape(-1, NUM_LIMBS),
                                            wx.reshape(-1, NUM_LIMBS),
                                            srv_x]))
    a1 = fb[:ns * V].reshape(ns, V, 3, NUM_LIMBS)
    a3 = fb[ns * V:2 * ns * V].reshape(ns, V, 3, NUM_LIMBS)
    ys = fb[2 * ns * V:]
    a2 = C.add(eg.fixed_base_mul(q_tbl, wr),
               C.neg(C.scalar_mul(orig_k[None], wx)))
    return a1, a2, a3, ys


def create_keyswitch_proofs(orig_k, srv_x, ks_rs, q_pt, q_tbl, u_pts, w_pts,
                            generator: Optional[torch.Generator] = None,
                            draws=None) -> KeySwitchProofBatch:
    """orig_k: (V, 3, 16); srv_x: (ns, 16) secrets; ks_rs: (ns, V, 16) the
    key-switch randomness; q_pt/q_tbl: target pub point + fixed-base table;
    u_pts/w_pts: (ns, V, 3, 16) the contributions actually produced by the
    key switch. The commitment randomness (wr, wx), each (ns, V, 16), is
    drawn from `generator` in that order, or given as `draws`."""
    dev = orig_k.device
    ns, V = ks_rs.shape[0], ks_rs.shape[1]
    if draws is None:
        if generator is None:
            raise ValueError("create_keyswitch_proofs needs a generator or "
                             "draws")
        draws = [eg.random_scalars((ns, V), generator, dev) for _ in range(2)]
    wr, wx = (d.to(dev) for d in draws)
    srv_x = srv_x.to(dev)
    a1, a2, a3, ys = _commit_kernel(orig_k, q_tbl, wr, wx, srv_x)
    pb = KeySwitchProofBatch(
        orig_k=orig_k, u_pts=u_pts, w_pts=w_pts, ys=ys, q_pt=q_pt.to(dev),
        a1=a1, a2=a2, a3=a3, challenge=None, zr=None, zx=None)
    c = _challenge_from_wire(_wire_dict(pb), ns, V).to(dev)
    pb.challenge = c
    pb.zr = F.add(wr, _mul_plain(c, ks_rs.to(dev)), FN)
    pb.zx = F.add(wx, _mul_plain(c, srv_x[:, None, :]), FN)
    return pb


def _verify_kernel(pb: KeySwitchProofBatch, q_tbl) -> torch.Tensor:
    """The three equations, bool (ns, V): one fixed-base launch for zr·B
    and zx·B, one for zr·Q, one ladder for c·U, zx·K, c·W and c·Y, and two
    adds."""
    ns, V = pb.u_pts.shape[:2]
    n = ns * V
    base = eg.BASE_TABLE.table.to(q_tbl.device)
    fb = eg.fixed_base_mul(base, torch.cat([pb.zr.reshape(-1, NUM_LIMBS),
                                            pb.zx.reshape(-1, NUM_LIMBS)]))
    zr_b, zx_b = fb[:n], fb[n:]
    zr_q = eg.fixed_base_mul(q_tbl, pb.zr.reshape(-1, NUM_LIMBS))
    grid = (ns, V, 3, NUM_LIMBS)
    sm = C.scalar_mul(
        torch.cat([pb.u_pts, pb.orig_k.expand(grid), pb.w_pts,
                   pb.ys[:, None].expand(grid)]),
        torch.cat([pb.challenge, pb.zx, pb.challenge, pb.challenge]))
    c_u, zx_k, c_w, c_y = (t.reshape(-1, 3, NUM_LIMBS)
                           for t in sm.split(ns))
    rhs = C.add(torch.cat([pb.a1, pb.a2, pb.a3]).reshape(-1, 3, NUM_LIMBS),
                torch.cat([c_u, c_w, c_y]))
    lhs2 = C.add(zr_q, C.neg(zx_k))
    ok1 = C.eq(zr_b, rhs[:n])
    ok2 = C.eq(lhs2, rhs[n:2 * n])
    ok3 = C.eq(zx_b, rhs[2 * n:])
    return (ok1 & ok2 & ok3).reshape(ns, V)


def verify_keyswitch_proofs(proof: KeySwitchProofBatch, q_tbl) -> np.ndarray:
    """Returns bool (ns, V) on the device of q_tbl; recomputes the
    challenge from the tensors' canonical bytes (there is no wire cache on
    this batch to trust)."""
    proof = proof.to(q_tbl.device)
    ok = _verify_kernel(proof, q_tbl).cpu().numpy()
    ns, V = int(proof.u_pts.shape[0]), int(proof.u_pts.shape[1])
    want = _challenge_from_wire(_wire_dict(proof), ns, V)
    same = (proof.challenge.cpu().to(torch.int64)
            == want.to(torch.int64)).all(-1).numpy()
    return ok & same


def verify_keyswitch_list(proof: KeySwitchProofBatch, q_tbl,
                          threshold: float) -> bool:
    """Threshold-sampled verification over the value axis (reference samples
    whole proofs at structs_proofs.go:471)."""
    V = int(proof.u_pts.shape[1])
    nbr = math.ceil(threshold * V)
    if nbr == 0:
        return True
    sub = KeySwitchProofBatch(
        orig_k=proof.orig_k[:nbr], u_pts=proof.u_pts[:, :nbr],
        w_pts=proof.w_pts[:, :nbr], ys=proof.ys, q_pt=proof.q_pt,
        a1=proof.a1[:, :nbr], a2=proof.a2[:, :nbr], a3=proof.a3[:, :nbr],
        challenge=proof.challenge[:, :nbr], zr=proof.zr[:, :nbr],
        zx=proof.zx[:, :nbr])
    return bool(np.all(verify_keyswitch_proofs(sub, q_tbl)))


__all__ = ["KeySwitchProofBatch", "create_keyswitch_proofs",
           "verify_keyswitch_proofs", "verify_keyswitch_list"]
