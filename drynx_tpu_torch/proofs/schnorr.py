"""Schnorr signatures on bn256 G1 with sha3-512 Fiat-Shamir.

The port's counterpart of drynx_tpu/proofs/schnorr.py, with the same
signatures: every proof-request payload is Schnorr-signed by its sender and
a verifying node checks the signature before the payload (kyber
sign/schnorr, reference lib/proof/structs_proofs.go:117,498-505). Signing
and the verification of one signature run on the host, in the pure-Python
curve arithmetic of `refimpl` (one G1 multiplication to sign, two to
verify). `verify_batch` checks many signatures at once on the device
(the fixed-base ladder for s·B, the variable-base ladder and the batched
add for R + c·P); as in the reference, no caller on the survey path uses
it: the verifying nodes call `verify`.

Scheme: R = k·B, c = H(R ‖ pub ‖ msg) mod n, s = k + c·x;
verify: s·B == R + c·P.
"""
from __future__ import annotations

import dataclasses
import hashlib
import secrets

import numpy as np

from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto import params, refimpl
from ..utils.device import resolve


@dataclasses.dataclass(frozen=True)
class Signature:
    r_bytes: bytes  # canonical G1 point (64 B)
    s_bytes: bytes  # canonical scalar (32 B)

    def to_bytes(self) -> bytes:
        return self.r_bytes + self.s_bytes

    @classmethod
    def from_bytes(cls, b: bytes) -> "Signature":
        return cls(bytes(b[:64]), bytes(b[64:96]))


def _point_bytes_host(pt) -> bytes:
    """Host affine int pair (or None) -> canonical 64 bytes."""
    if pt is None:
        return b"\x00" * 64
    x, y = pt
    return int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")


def _challenge(r_bytes: bytes, pub_bytes: bytes, msg: bytes) -> int:
    h = hashlib.sha3_512()
    h.update(r_bytes)
    h.update(pub_bytes)
    h.update(msg)
    return int.from_bytes(h.digest(), "big") % params.N


# secret -> affine public point, so a long-lived sender pays its host
# G1 multiplication once
_PUB_CACHE: dict[int, tuple] = {}


def _pub_for(secret: int):
    pub = _PUB_CACHE.get(secret)
    if pub is None:
        pub = _PUB_CACHE[secret] = refimpl.g1_mul(refimpl.G1, secret)
    return pub


def sign(secret: int, msg: bytes, k: int | None = None) -> Signature:
    """Schnorr-sign msg with secret scalar, on the host."""
    if k is None:
        k = secrets.randbelow(params.N - 1) + 1
    R = refimpl.g1_mul(refimpl.G1, k)
    # the public key is public by construction (dlog hides the scalar)
    pub = _pub_for(secret)  # drynx: declassify[secret]
    r_bytes = _point_bytes_host(R)
    c = _challenge(r_bytes, _point_bytes_host(pub), msg)
    # the Schnorr response is public by construction: c is bound to the
    # commitment, so s reveals neither k nor the secret scalar
    s = (k + c * secret) % params.N  # drynx: declassify[secret]
    return Signature(r_bytes, s.to_bytes(32, "big"))


def _r_point(sig: Signature):
    rx = int.from_bytes(sig.r_bytes[:32], "big")
    ry = int.from_bytes(sig.r_bytes[32:], "big")
    return None if (rx == 0 and ry == 0) else (rx, ry)


def verify(pub, msg: bytes, sig: Signature) -> bool:
    """Host-side verification. pub: affine int pair."""
    s = int.from_bytes(sig.s_bytes, "big")
    c = _challenge(sig.r_bytes, _point_bytes_host(pub), msg)
    lhs = refimpl.g1_mul(refimpl.G1, s)
    rhs = refimpl.g1_add(_r_point(sig), refimpl.g1_mul(pub, c))
    return lhs == rhs


def verify_batch(pubs, msgs: list[bytes], sigs: list[Signature],
                 device=None) -> np.ndarray:
    """Batched device verification of many signatures (the reference's VN
    bulk path, drynx_tpu/proofs/schnorr.py:98-120) on `device` (the card
    unless the CPU is named). pubs: list of affine int pairs. Returns bool
    (n,)."""
    n = len(sigs)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    dev = resolve(device)
    cs = [_challenge(sg.r_bytes, _point_bytes_host(p), m)
          for p, m, sg in zip(pubs, msgs, sigs)]
    ss = [int.from_bytes(sg.s_bytes, "big") for sg in sigs]
    lhs = eg.fixed_base_mul(eg.BASE_TABLE.table.to(dev),
                            F.from_int(ss).to(dev))
    rhs = C.add(C.from_ref_batch([_r_point(sg) for sg in sigs]).to(dev),
                C.scalar_mul(C.from_ref_batch(list(pubs)).to(dev),
                             F.from_int(cs).to(dev)))
    return C.eq(lhs, rhs).cpu().numpy()


__all__ = ["Signature", "sign", "verify", "verify_batch"]
