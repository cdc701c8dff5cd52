"""Persistent cross-survey crypto-artifact store (the "crypto pool").

The port's counterpart of drynx_tpu/pool/store.py, with the same on-disk
layout, ledger events and `.npz` member names, so a pool written by one
package is consumed by the other. `key_digest` hashes a fixed-base table
in the reference's uint32 (64, 16, 3, 16) layout whatever tensor holds it,
so one key gives one digest in both packages. `DRYNX_POOL_MMAP` is the
reference's own switch between mapped and eager reads of pool files (not
a kernel switch) and is kept for parity.

The reference amortizes its two heavyweight per-survey setups across
surveys AND processes: DRO shuffle precomputation is gob-persisted per
server (services/service.go:34,316-317 pre_compute_multiplications.gob +
unlynx PrecomputationWritingForShuffling), and the per-signature tables
are built once per signature set. This module is the repo's equivalent,
with two tenants:

  * **DRO precompute slabs** — fixed-width batches of fresh
    zero-encryptions ``(zero_ct (E,2,3,16), r (E,16))`` usable as the
    ``precomp`` argument of ``parallel.dro.shuffle_rerandomize``. Keyed
    by a digest of the collective-key fixed-base table (a slab is only
    valid under the key it was encrypted to) and the slab width.
  * **Sig tables** — ``sig_gt_table`` / ``sig_gt_pow_tables`` arrays
    keyed by the same A-table digests the in-process LRUs use
    (proofs/range_proof.py), so a fresh process skips the pairing batch
    and the ~10 s host pow-table build.

Single consumption is load-bearing CORRECTNESS, not bookkeeping: reusing
a DRO re-randomization mask across two surveys lets a proof observer
subtract the masks and recover both secret permutations — the privacy
the shuffle exists to provide. The claim protocol therefore tombstones a
slab BEFORE its ciphertexts are released:

  1. ``os.rename(slab.npz -> slab.npz.claimed)`` — atomic: exactly one
     claimant (thread OR process) can win; a loser raises
     ``DoubleConsumption``.
  2. append a ``consume`` event to the fsync'd ledger journal — the
     tombstone survives a crash from here on.
  3. only now read the arrays; then unlink the ``.claimed`` file.

Crash windows: a death between 1 and 3 leaves a ``.claimed`` file whose
randomness was never served — reopen deletes it (event ``recover``).
A death mid-write leaves a ``*.tmp`` partial — deposits write tmp +
fsync + ``os.replace``, so a live ``slab_*.npz`` is always complete and
reopen just sweeps the partials. A deposit that crashed after the
``os.replace`` but before its ledger line is simply a live slab with no
deposit event — servable; only ``consume`` events are load-bearing.

numpy-only on purpose: the store must be importable (and auditable) with
no accelerator runtime; the crypto lives in ``pool.replenish`` /
``parallel.dro``. Arrays come back as host numpy; the consumer moves a
slab to its device once per consume.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import secrets
import struct
import zipfile

import numpy as np

from ..resilience.policy import named_lock

# The runtime recorders (analysis/dettrace.py, analysis/prototrace.py):
# every journal line and every write, slab and journal lifecycle event
_DET_TRACE = os.environ.get("DRYNX_DET_TRACE", "0") == "1"
_PROTO_TRACE = os.environ.get("DRYNX_PROTO_TRACE", "0") == "1"


def mmap_enabled() -> bool:
    """``DRYNX_POOL_MMAP=off`` switches back to eager slab / sig-table
    reads (full host copies out of np.load), as in the reference."""
    return os.environ.get("DRYNX_POOL_MMAP",
                          "").strip().lower() not in ("off", "0", "no")


def _npz_members(path: str):
    """{name: (data_offset, dtype, shape, fortran)} for every member of
    an UNCOMPRESSED npz (np.savez default), or None when any member
    can't be mapped (compressed, foreign layout, unexpected header)."""
    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for zi in z.infolist():
            if zi.compress_type != zipfile.ZIP_STORED:
                return None
            f.seek(zi.header_offset)
            hdr = f.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                return None
            # the LOCAL header's name/extra lengths (they can differ
            # from the central directory's)
            fn_len, extra_len = struct.unpack("<HH", hdr[26:30])
            f.seek(zi.header_offset + 30 + fn_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dt = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dt = np.lib.format.read_array_header_2_0(f)
            else:
                return None
            name = zi.filename
            if name.endswith(".npy"):
                name = name[:-4]
            out[name] = (f.tell(), dt, shape, fortran)
    return out


def _load_npz_mapped(path: str):
    """Read-only np.memmap per member of an npz, straight over the zip
    at each member's computed data offset — no host materialization;
    device_put can feed directly from the mapping. None on any surprise
    (the caller falls back to the eager np.load copy). A Linux mapping
    survives the file's unlink, so the claim protocol's read-then-unlink
    ordering is unchanged."""
    try:
        members = _npz_members(path)
        if members is None:
            return None
        return {name: np.memmap(path, dtype=dt, mode="r", offset=off,
                                shape=shape,
                                order="F" if fortran else "C")
                for name, (off, dt, shape, fortran) in members.items()}
    except Exception:
        return None


class PoolError(Exception):
    """Base class for pool failures."""


class DoubleConsumption(PoolError):
    """A slab was claimed twice (second claimant, any thread/process).

    This is the error the single-consumption ledger exists to raise:
    the caller must treat it as 'use different randomness', never as
    'retry the same slab'."""


class InsufficientBalance(PoolError):
    """The pool cannot cover the requested element count."""


def key_digest(table) -> str:
    """Content digest of a collective-key fixed-base table (64, 16, 3, 16),
    over its bytes in the reference's uint32 layout (a torch tensor on any
    device, or an array, of 16-bit limbs).

    DRO slabs are zero-encryptions UNDER A SPECIFIC KEY — serving a slab
    encrypted to a different collective key would silently break the
    re-randomization (the ciphertexts would no longer decrypt to the
    survey's plaintexts). Content-addressing by the key table makes the
    mixup structurally impossible."""
    # a digest of the key table is a host value: one readback by design
    if hasattr(table, "detach"):
        table = table.detach().cpu().numpy()  # drynx: noqa[host-sync-in-hot-path]
    a = np.ascontiguousarray(np.asarray(table).astype(np.uint32))  # drynx: noqa[host-sync-in-hot-path]
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_npz(path: str, **arrays) -> None:
    """tmp + fsync + os.replace: a reader never observes a partial file
    under the final name; a crash leaves only a ``*.tmp`` to sweep.

    The tmp name is unique per writer: content-addressed artifacts (fb /
    sig tables) are warmed concurrently by server threads since the
    fan-out went parallel, and two writers sharing one tmp path race —
    the loser's os.replace finds the tmp already moved (observed as
    FileNotFoundError under the DP dispatch fan-out). Distinct tmps make
    concurrent same-digest writes last-writer-wins over identical bytes."""
    tmp = f"{path}.{secrets.token_hex(8)}.tmp"
    inst = None
    if _PROTO_TRACE:
        from ..analysis import prototrace
        inst = prototrace.new_instance("atomic")
        prototrace.record(inst, "open")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        if inst:
            prototrace.record(inst, "write")
        f.flush()
        os.fsync(f.fileno())
        if inst:
            prototrace.record(inst, "fsync")
    if inst:
        prototrace.record(inst, "close")
    os.replace(tmp, path)
    if inst:
        prototrace.record(inst, "rename")
    _fsync_dir(os.path.dirname(path))


class CryptoPool:
    """One on-disk pool rooted at ``root``.

    Layout::

        root/ledger.jsonl                    append-only event journal
        root/dro/<digest>/<E>/slab_<id>.npz  live slab (E elements)
        root/dro/.../slab_<id>.npz.claimed   tombstoned, not yet unlinked
        root/sig/<kind>_<digest>.npz         content-addressed sig tables

    ``slab_elems`` is the width replenishment deposits at (consumers
    accept any width present). Thread-safe; multi-process safe for the
    consumption path (the rename claim is the arbiter — the in-memory
    consumed-set is an accelerator for the restart case, not the lock).
    """

    def __init__(self, root: str, slab_elems: int = 4096):
        self.root = os.path.abspath(root)
        self.slab_elems = int(slab_elems)
        self._lock = named_lock("ledger_lock", reentrant=True)
        self._consumed: set[str] = set()
        # process-local activity counters (lifetime state is the ledger)
        self.counters = {"deposited": 0, "consumed": 0, "recovered": 0,
                         "elements_consumed": 0}
        os.makedirs(os.path.join(self.root, "dro"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "sig"), exist_ok=True)
        self._ledger_path = os.path.join(self.root, "ledger.jsonl")
        self._replay_ledger()
        self._recover()

    # -- ledger ------------------------------------------------------------

    def _replay_ledger(self) -> None:
        if not os.path.exists(self._ledger_path):
            return
        with open(self._ledger_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    # torn final line from a crash mid-append: the claim
                    # rename happened first, so the .claimed sweep below
                    # still tombstones the slab — drop the torn tail
                    continue
                if ev.get("ev") in ("consume", "recover"):
                    self._consumed.add(ev["slab"])

    def _ledger_append(self, ev: dict) -> None:
        line = json.dumps(ev, sort_keys=True)
        if _DET_TRACE:
            # laundered: sort_keys canonicalizes the record bytes
            from ..analysis import dettrace
            dettrace.record("pool.journal", line, line.encode(),
                            laundered=True)
        with self._lock:
            with open(self._ledger_path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            if _PROTO_TRACE:
                from ..analysis import prototrace
                inst = prototrace.new_instance("journal")
                prototrace.record(inst, "append")
                prototrace.record(inst, "fsync")

    # -- crash recovery ----------------------------------------------------

    def _recover(self) -> None:
        """Sweep crash residue: partial ``*.tmp`` writes are discarded
        (never visible under a live name); orphaned ``*.claimed`` slabs
        were tombstoned but never served — their randomness must not
        re-enter the pool, so they are journaled as ``recover`` and
        deleted."""
        pat = os.path.join(self.root, "dro", "**")
        for p in sorted(glob.glob(pat, recursive=True)):
            if p.endswith(".tmp"):
                os.unlink(p)
            elif p.endswith(".claimed"):
                sid = _slab_id(p[:-len(".claimed")])
                self._ledger_append({"ev": "recover", "slab": sid})
                self._consumed.add(sid)
                self.counters["recovered"] += 1
                os.unlink(p)

    # -- DRO slab tenant ---------------------------------------------------

    def _slab_dir(self, digest: str, elems: int) -> str:
        return os.path.join(self.root, "dro", digest, str(int(elems)))

    def _live_slabs(self, digest: str) -> list[str]:
        pat = os.path.join(self.root, "dro", digest, "*", "slab_*.npz")
        return sorted(glob.glob(pat))

    def deposit_dro(self, digest: str, zero_ct, r) -> str:
        """Persist one precompute slab; returns its slab id.

        Write-then-journal: the atomic replace makes the slab servable,
        the deposit event is informational (see module docstring)."""
        zero_ct = _host_u32(zero_ct)
        r = _host_u32(r)
        if zero_ct.shape[0] != r.shape[0]:
            raise PoolError(f"slab shape mismatch: {zero_ct.shape} vs "
                            f"{r.shape}")
        elems = int(zero_ct.shape[0])
        # drynx: deterministic[random slab ids name fungible randomness]
        sid = secrets.token_hex(8)
        d = self._slab_dir(digest, elems)
        os.makedirs(d, exist_ok=True)
        _atomic_write_npz(os.path.join(d, f"slab_{sid}.npz"),
                          zero_ct=zero_ct, r=r)
        self._ledger_append({"ev": "deposit", "slab": sid,
                             "digest": digest, "elems": elems})
        with self._lock:
            self.counters["deposited"] += 1
        return sid

    def dro_balance(self, digest: str) -> int:
        """Live (unclaimed) elements available under ``digest``."""
        return sum(_slab_elems(p) for p in self._live_slabs(digest))

    def _consume_path(self, path: str, digest: str):
        """The claim protocol (see module docstring): rename tombstone ->
        fsync'd ledger event -> only then read -> unlink."""
        sid = _slab_id(path)
        with self._lock:
            if sid in self._consumed:
                raise DoubleConsumption(
                    f"slab {sid} already consumed (ledger)")
        claimed = f"{path}.claimed"
        try:
            os.rename(path, claimed)
        except FileNotFoundError:
            # the slab existed when enumerated; only a concurrent claim
            # removes a live slab file
            raise DoubleConsumption(
                f"slab {sid} claimed concurrently") from None
        inst = None
        if _PROTO_TRACE:
            from ..analysis import prototrace
            inst = prototrace.new_instance("slab")
            prototrace.record(inst, "claim")
        self._ledger_append({"ev": "consume", "slab": sid,
                             "digest": digest,
                             "elems": _slab_elems(path)})
        if inst:
            prototrace.record(inst, "journal")
        with self._lock:
            self._consumed.add(sid)
            self.counters["consumed"] += 1
            self.counters["elements_consumed"] += _slab_elems(path)
        mapped = _load_npz_mapped(claimed) if mmap_enabled() else None
        if mapped is not None and "zero_ct" in mapped and "r" in mapped:
            # zero-copy serve: the mappings stay valid past the unlink
            # (the inode lives while mapped) and feed device_put without
            # ever materializing a full host copy
            out = (mapped["zero_ct"], mapped["r"])
        else:
            with np.load(claimed) as d:
                out = (d["zero_ct"].copy(), d["r"].copy())
        if inst:
            prototrace.record(inst, "read")
        os.unlink(claimed)
        if inst:
            prototrace.record(inst, "unlink")
        return out

    def consume_slab(self, digest: str, slab_id: str):
        """Consume one specific slab by id (test/diagnostic surface).

        Raises DoubleConsumption if it was ever consumed — in this
        process, by a concurrent thread, or by a previous process (the
        ledger replay covers the restart case)."""
        with self._lock:
            if slab_id in self._consumed:
                raise DoubleConsumption(
                    f"slab {slab_id} already consumed (ledger)")
        for p in self._live_slabs(digest):
            if _slab_id(p) == slab_id:
                return self._consume_path(p, digest)
        raise DoubleConsumption(
            f"slab {slab_id} not live under {digest} (claimed or unknown)")

    def try_consume_dro(self, digest: str, need: int):
        """Claim >= ``need`` elements and return ``(zero_ct, r)`` trimmed
        to exactly ``need``; None when the balance cannot cover it.

        Slabs are consumed whole: the unclaimed tail of the last slab is
        DISCARDED with its tombstone (never re-enters the pool) — the
        safe direction; wasting randomness is cheap, reusing it is a
        privacy break."""
        if need <= 0:
            return None
        if self.dro_balance(digest) < need:
            return None
        zs, rs, got = [], [], 0
        for p in self._live_slabs(digest):
            try:
                z, r = self._consume_path(p, digest)
            except DoubleConsumption:
                continue        # lost a race on this slab; try the next
            zs.append(z)
            rs.append(r)
            got += z.shape[0]
            if got >= need:
                break
        if got < need:
            # the balance shrank under us: everything claimed above is
            # already tombstoned and stays discarded
            raise InsufficientBalance(
                f"pool drained concurrently: got {got} < need {need}")
        if len(zs) == 1:
            # one slab covered the need: serve views of the (possibly
            # mapped) arrays instead of concatenating a fresh copy
            return zs[0][:need], rs[0][:need]
        z = np.concatenate(zs, axis=0)[:need]
        r = np.concatenate(rs, axis=0)[:need]
        return z, r

    def consume_dro(self, digest: str, need: int):
        out = self.try_consume_dro(digest, need)
        if out is None:
            raise InsufficientBalance(
                f"balance {self.dro_balance(digest)} < need {need}")
        return out

    # -- sig-table tenant --------------------------------------------------

    def _sig_path(self, kind: str, digest: str) -> str:
        assert "/" not in kind and "/" not in digest, (kind, digest)
        return os.path.join(self.root, "sig", f"{kind}_{digest}.npz")

    def save_sig(self, kind: str, digest: str, **arrays) -> None:
        """Content-addressed, idempotent: overwriting with the same
        digest rewrites identical bytes."""
        _atomic_write_npz(self._sig_path(kind, digest), **arrays)

    def load_sig(self, kind: str, digest: str):
        """Lazy per-key view of the sig-table npz — None when absent.

        Every caller uses exactly one key (range_proof's gt/pow tables,
        elgamal's fb table), so the old eager {k: copy for all keys}
        materialized arrays nobody read. Arrays load (mapped when
        DRYNX_POOL_MMAP is on) on first access and cache per key."""
        p = self._sig_path(kind, digest)
        if not os.path.exists(p):
            return None
        return SigTables(p)

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        pat = os.path.join(self.root, "dro", "*", "*", "slab_*.npz")
        live = glob.glob(pat)
        return {
            "slabs_live": len(live),
            "elements_live": sum(_slab_elems(p) for p in live),
            "slab_elems": self.slab_elems,
            **self.counters,
        }


class SigTables:
    """Lazy mapping over one sig-table npz: each array is read on first
    access only (np.memmap when DRYNX_POOL_MMAP is on, else an eager
    per-member np.load read) and cached. Supports the dict surface the
    sig-table callers use: ``d[key]``, ``in``, ``keys()``, iteration."""

    def __init__(self, path: str):
        self._path = path
        self._cache: dict = {}
        self._names = None

    def keys(self):
        if self._names is None:
            with zipfile.ZipFile(self._path) as z:
                self._names = [n[:-4] if n.endswith(".npy") else n
                               for n in z.namelist()]
        return list(self._names)

    def __contains__(self, k) -> bool:
        return k in self.keys()

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __getitem__(self, k):
        if k in self._cache:
            return self._cache[k]
        a = None
        if mmap_enabled():
            mapped = _load_npz_mapped(self._path)
            if mapped is not None:
                a = mapped[k]
        if a is None:
            with np.load(self._path) as d:
                a = d[k].copy()
        self._cache[k] = a
        return a


def _host_u32(a) -> np.ndarray:
    """Limb arrays as the reference stores them: host uint32."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.uint32)


def _slab_id(path: str) -> str:
    stem = os.path.basename(path)
    assert stem.startswith("slab_") and stem.endswith(".npz"), path
    return stem[len("slab_"):-len(".npz")]


def _slab_elems(path: str) -> int:
    # width is the parent directory name (root/dro/<digest>/<E>/slab_*.npz)
    return int(os.path.basename(os.path.dirname(path)))


__all__ = ["CryptoPool", "PoolError", "DoubleConsumption",
           "InsufficientBalance", "key_digest", "SigTables",
           "mmap_enabled"]
