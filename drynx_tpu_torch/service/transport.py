"""The control plane's transport: length-prefixed frames between nodes.

The port's counterpart of drynx_tpu/service/transport.py. Two wire
formats share one outer framing ([u32 length][body]):

  v1 (JSON)    the body is a UTF-8 JSON document; bytes values travel as
               base64 strings.
  v2 (binary)  the body is [u32 header_len][header JSON][u32 nsegs]
               [u32 seg_len x nsegs][seg bytes...]; every bytes value of
               the message tree is a raw segment, referenced from the
               header as {"__seg__": i}, and an integer tensor payload is
               narrowed to the smallest dtype that holds its values.

A frame is byte-identical to the reference's for the same message, in
both formats, so a port node and a reference node talk to each other.

v2 decode is device-direct: a narrowed segment stays lazy
(:class:`LazySeg`). ``unpack_array_device`` uploads a narrowed segment at
or above ``DEVICE_DECODE_MIN_BYTES`` as it came off the wire and widens
it on the node's device with a torch cast; anything smaller widens on the
host first. Host consumers (``unb64``, ``unpack_array``) widen on demand
to the exact bytes the sender packed. The decode's and the upload's
seconds go to ``WIRE_TIMERS`` (``PhaseTimers.add_split``, as host glue);
the reference records them in its proof plane's shard timers.

The format is negotiated per connection: a client opens in v1, sends a
``wire_hello`` (handled inside the server's accept loop, invisible to the
fault plan and to handlers) and switches to the agreed version. A server
that errors the hello leaves the connection on v1. ``Conn(wire=1)``,
``ConnPool(wire=1)`` and ``NodeServer(wire=1)`` pin a side to v1.
:class:`LinkModel` charges the frame's real length either way.

Failure contract: every transport failure raises a subclass of
:class:`TransportError`, which also inherits the builtin exception an
older caller catches (``ConnectionError``, ``TimeoutError``,
``RuntimeError``). A :class:`Conn` whose exchange failed mid-frame is
broken: closed, and every later call raises at once; recovery is a new
connection, decided by the caller's RetryPolicy. :class:`ConnPool` never
pools a broken or closed connection and discards a pooled socket with
pending bytes on checkout.

Fault injection: with a :class:`~drynx_tpu_torch.resilience.faults.
FaultPlan` installed, the client hooks (connect, request) and the server
hooks (node, reply) consult it; ``local_call`` replays the same hooks for
an in-process call, and ``fan_out`` runs one call per roster entry on a
bounded pool.
"""
from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Optional

import numpy as np
import torch

from ..resilience import faults
from ..resilience import policy as rp
from ..utils.device import resolve
from ..utils.timers import PhaseTimers

# DRYNX_PROTO_TRACE: record every Conn lifecycle event (checkout, use,
# break, put/discard/close) into the runtime protocol recorder
# (analysis/prototrace.py), whose automaton is the
# conn-checkout-discipline rule's.
_PROTO_TRACE = os.environ.get("DRYNX_PROTO_TRACE", "0") == "1"


def _proto_record(conn: "Conn", event: str) -> None:
    inst = getattr(conn, "_proto_inst", None)
    if inst:
        from ..analysis import prototrace
        prototrace.record(inst, event)


# ---------------------------------------------------------------------------
# Typed failure hierarchy
# ---------------------------------------------------------------------------

class TransportError(Exception):
    """Base of every control-plane transport failure."""


class ConnectError(TransportError, ConnectionError):
    """The connect to a roster entry failed (refused / unreachable)."""


class ConnectionClosed(TransportError, ConnectionError):
    """The peer closed (or reset) the connection mid-exchange."""


class CallTimeout(TransportError, TimeoutError):
    """The call timed out mid-frame; the connection is now broken."""


class FrameTooLarge(TransportError):
    """A frame header announced more bytes than the configured cap."""


class CorruptFrame(TransportError):
    """A frame's body did not decode under the connection's wire format."""


class RemoteError(TransportError, RuntimeError):
    """The peer's handler raised; its error reply carries the repr."""


# ---------------------------------------------------------------------------
# Link emulation and byte accounting
# ---------------------------------------------------------------------------

class LinkModel:
    """Per-message link emulation and byte accounting (the reference
    simulation's per-link model, simul/runfiles/drynx.toml:6-7: a delay
    and a bandwidth). ``charge(n)`` sleeps delay + n * 8 / bandwidth, after
    the counters are updated under a lock, so concurrent sends overlap
    their link time as independent links would.

    ``rx_by_node`` is the receive-side ledger of the tree overlay: a frame
    is charged once at its sender and counted once more, without a sleep,
    against the node that received it (``count_rx``). Bytes at the root,
    the number the tree exists to shrink, are ``rx_by_node[root]``; the
    key is left out of ``stats()`` while it is empty."""

    def __init__(self, delay_ms: float = 0.0, bandwidth_mbps: float = 0.0):
        self.delay_s = float(delay_ms) / 1e3
        self.byte_s = (8.0 / (float(bandwidth_mbps) * 1e6)
                       if bandwidth_mbps else 0.0)
        self._lock = rp.named_lock("linkmodel_lock")
        self.bytes_total = 0
        self.msgs_total = 0
        self.by_peer: dict[str, int] = {}
        self.rx_by_node: dict[str, int] = {}

    @property
    def active(self) -> bool:
        return self.delay_s > 0 or self.byte_s > 0

    def charge(self, n_bytes: int, peer: str = "") -> None:
        with self._lock:
            self.bytes_total += n_bytes
            self.msgs_total += 1
            if peer:
                self.by_peer[peer] = self.by_peer.get(peer, 0) + n_bytes
        t = self.delay_s + n_bytes * self.byte_s
        if t > 0:
            time.sleep(t)

    def count_rx(self, n_bytes: int, node: str) -> None:
        """Attribute received bytes to the node that consumed them (no
        sleep: the frame paid its link time at the sender)."""
        if not node:
            return
        with self._lock:
            self.rx_by_node[node] = self.rx_by_node.get(node, 0) + n_bytes

    def stats(self) -> dict:
        with self._lock:
            out = {"bytes_total": self.bytes_total,
                   "msgs_total": self.msgs_total,
                   "by_peer": dict(self.by_peer)}
            if self.rx_by_node:
                out["rx_by_node"] = dict(self.rx_by_node)
            return out

    def reset_stats(self) -> None:
        with self._lock:
            self.bytes_total = 0
            self.msgs_total = 0
            self.by_peer = {}
            self.rx_by_node = {}


_LINK: Optional[LinkModel] = None


def link_model() -> LinkModel:
    """The process's link model (a free, counting-only one by default)."""
    global _LINK
    if _LINK is None:
        _LINK = LinkModel()
    return _LINK


def set_link_model(m: Optional[LinkModel]) -> None:
    global _LINK
    _LINK = m


# The node a thread acts for, for the receive-side ledger and the fault
# plan's partitions: unset means the querier ("client"). A relay's
# outbound calls run on handler and worker threads, so NodeServer pins the
# serving node on its connection threads and fan_out / proof threads
# re-pin it on theirs (pool threads inherit nothing).
_CURRENT_NODE = threading.local()


def set_current_node(name: str) -> None:
    _CURRENT_NODE.name = name


def current_node() -> str:
    return getattr(_CURRENT_NODE, "name", "")


# A corrupt or hostile 4-byte header must not drive an unbounded
# allocation: 64 MiB clears the largest legitimate payload by far.
MAX_FRAME_BYTES = 1 << 26


def set_max_frame_bytes(n: int) -> None:
    global MAX_FRAME_BYTES
    MAX_FRAME_BYTES = int(n)


# ---------------------------------------------------------------------------
# Message fields
# ---------------------------------------------------------------------------

def b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def unb64(s) -> bytes:
    """A bytes field under either wire: v1 delivers base64 strings, v2 raw
    bytes (possibly a lazy narrowed segment)."""
    if isinstance(s, LazySeg):
        return s.to_bytes()
    if isinstance(s, (bytes, bytearray, memoryview)):
        return bytes(s)
    return base64.b64decode(s.encode())


def pack_array(a) -> dict:
    """Array (numpy, or a torch tensor, moved to the host) -> message
    field; ``data`` is raw bytes, base64'd by the v1 encoder and shipped
    as a segment by v2."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def unpack_array(d: dict) -> np.ndarray:
    return np.frombuffer(unb64(d["data"]),
                         dtype=np.dtype(d["dtype"])).reshape(d["shape"])


# ---------------------------------------------------------------------------
# Device-direct decode
# ---------------------------------------------------------------------------

class LazySeg:
    """A narrowed v2 segment whose widen has not happened yet. Host
    consumers widen on demand (``to_bytes``, the bytes the sender packed);
    ``unpack_array_device`` uploads the narrow view and widens on the
    device."""

    __slots__ = ("raw", "wire_dt", "orig_dt", "_wide")

    def __init__(self, raw: bytes, wire_dt: str, orig_dt: str):
        self.raw = raw
        self.wire_dt = wire_dt
        self.orig_dt = orig_dt
        self._wide: Optional[bytes] = None

    def narrow_view(self) -> np.ndarray:
        """Zero-copy 1-D view of the wire bytes at the wire dtype."""
        return np.frombuffer(self.raw, dtype=np.dtype(self.wire_dt))

    def to_bytes(self) -> bytes:
        """The host-widened bytes."""
        if self._wide is None:
            self._wide = self.narrow_view() \
                .astype(np.dtype(self.orig_dt)).tobytes()
        return self._wide

    def __len__(self) -> int:
        return len(self.raw) // np.dtype(self.wire_dt).itemsize \
            * np.dtype(self.orig_dt).itemsize

    def __eq__(self, other) -> bool:
        # equal to the widened bytes, so a decoded tree compares equal to
        # the original payload
        if isinstance(other, (bytes, bytearray)):
            return self.to_bytes() == bytes(other)
        if isinstance(other, LazySeg):
            return self.to_bytes() == other.to_bytes()
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __repr__(self) -> str:
        return (f"LazySeg({len(self.raw)}B {self.wire_dt}"
                f"->{self.orig_dt})")


# limb convention: the crypto layers carry 16-bit limbs in uint32 slots
# (and small int64 host values), so most tensor payloads narrow 2-8x
# losslessly on the wire
_NARROW = {"u": [np.uint8, np.uint16, np.uint32],
           "i": [np.int8, np.int16, np.int32]}


def widen_pairs() -> list:
    """Every (narrow, wide) integer dtype pair the v2 encoder can ship."""
    out = []
    for kind, cands in _NARROW.items():
        for size in (2, 4, 8):
            wide = np.dtype(f"{kind}{size}")
            for cand in cands:
                cdt = np.dtype(cand)
                if cdt.itemsize < wide.itemsize:
                    out.append((cdt.name, wide.name))
    return out


# Wire bytes below which a narrowed segment widens on the host: the
# device widen costs an upload and a cast launch, worth it only once the
# segment is large enough (the reference's floor).
DEVICE_DECODE_MIN_BYTES = 1 << 16

# The transport's host-glue spans ("WireDecode", "WireUpload"), by
# PhaseTimers.add_split; split_summary() reads them.
WIRE_TIMERS = PhaseTimers()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a (possibly read-only) host array, without a copy
    (torch warns about the read-only buffer; it is only read)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def unpack_array_device(d: dict, device=None) -> torch.Tensor:
    """Tensor field -> a tensor of the packed dtype and shape on `device`
    (the card unless the CPU is named).

    A narrowed segment of at least DEVICE_DECODE_MIN_BYTES wire bytes
    uploads its narrow view and widens there by a torch cast; anything
    else uploads the host widen. The values equal
    ``torch.from_numpy(unpack_array(d))`` bit for bit either way."""
    dev = resolve(device)
    data = d["data"]
    t0 = time.perf_counter()
    if (isinstance(data, LazySeg)
            and len(data.raw) >= DEVICE_DECODE_MIN_BYTES):
        narrow = _host_tensor(data.narrow_view()).to(dev)
        out = narrow.to(getattr(torch, data.orig_dt)).reshape(d["shape"])
    else:
        out = _host_tensor(unpack_array(d)).to(dev)
    if out.device.type == "cpu":
        out = out.clone()     # never alias the frame's read-only bytes
    WIRE_TIMERS.add_split("WireUpload", "host_glue", time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# Wire formats
# ---------------------------------------------------------------------------

WIRE_DEFAULT = 2


def _json_default(o):
    """v1: bytes fields become base64 strings."""
    if isinstance(o, LazySeg):
        return b64(o.to_bytes())
    if isinstance(o, (bytes, bytearray, memoryview)):
        return b64(bytes(o))
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def jsonable(obj):
    """Deep copy of a message tree in pure JSON types (bytes -> base64
    strings), for callers that persist or hash messages off the wire."""
    return json.loads(json.dumps(obj, default=_json_default))


_SEG_KEY = "__seg__"
_NARROW_KEY = "w"


def _narrow_seg(dtype: str, data: bytes):
    """(wire bytes, wire dtype) of a packed-array payload in the smallest
    integer dtype that holds every value exactly; (data, None) where
    narrowing does not apply. The decoder widens back to `dtype`."""
    try:
        dt = np.dtype(dtype)
        if dt.kind not in _NARROW or dt.itemsize <= 1 or not data:
            return data, None
        a = np.frombuffer(data, dtype=dt)
        lo, hi = int(a.min()), int(a.max())
        for cand in _NARROW[dt.kind]:
            cdt = np.dtype(cand)
            if cdt.itemsize >= dt.itemsize:
                break
            info = np.iinfo(cdt)
            if info.min <= lo and hi <= info.max:
                return a.astype(cdt).tobytes(), cdt.name
        return data, None
    except (ValueError, TypeError):
        return data, None


def _encode_v2(obj: dict) -> bytes:
    """Body of a v2 frame: [u32 header_len][header JSON][u32 nsegs]
    [u32 seg_len x nsegs][seg bytes...]."""
    segs: list[bytes] = []

    def ref(data: bytes, narrowed=None):
        segs.append(data)
        r = {_SEG_KEY: len(segs) - 1}
        if narrowed:
            r[_NARROW_KEY] = narrowed
        return r

    def strip(o):
        if isinstance(o, (bytes, bytearray, memoryview)):
            return ref(bytes(o))
        if isinstance(o, LazySeg):
            # a relayed narrowed segment: forward its wire bytes with the
            # same widen marker (the bytes a re-narrow would give)
            return ref(o.raw, [o.wire_dt, o.orig_dt])
        if isinstance(o, dict):
            if isinstance(o.get("data"),
                          (bytes, bytearray, memoryview, LazySeg)) \
                    and isinstance(o.get("dtype"), str):
                if isinstance(o["data"], LazySeg):
                    wire_bytes = o["data"].raw
                    wdt = o["data"].wire_dt
                else:
                    wire_bytes, wdt = _narrow_seg(o["dtype"],
                                                  bytes(o["data"]))
                nw = [wdt, o["dtype"]] if wdt else None
                return {k: (ref(wire_bytes, nw) if k == "data"
                            else strip(v)) for k, v in o.items()}
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o

    header = json.dumps(strip(obj)).encode()
    parts = [len(header).to_bytes(4, "big"), header,
             len(segs).to_bytes(4, "big")]
    for s in segs:
        parts.append(len(s).to_bytes(4, "big"))
    parts.extend(segs)
    return b"".join(parts)


def _decode_v2(body: bytes) -> dict:
    try:
        if len(body) < 8:
            raise ValueError("truncated v2 body")
        hl = int.from_bytes(body[:4], "big")
        if 4 + hl + 4 > len(body):
            raise ValueError(f"header length {hl} exceeds body")
        header = json.loads(body[4:4 + hl].decode())
        off = 4 + hl
        nsegs = int.from_bytes(body[off:off + 4], "big")
        off += 4
        if off + 4 * nsegs > len(body):
            raise ValueError(f"segment table ({nsegs}) exceeds body")
        lens = []
        for _ in range(nsegs):
            lens.append(int.from_bytes(body[off:off + 4], "big"))
            off += 4
        segs: list[bytes] = []
        for n in lens:
            if off + n > len(body):
                raise ValueError("segment exceeds body")
            segs.append(body[off:off + n])
            off += n

        def fill(o):
            if isinstance(o, dict):
                if _SEG_KEY in o and set(o) <= {_SEG_KEY, _NARROW_KEY}:
                    raw = segs[o[_SEG_KEY]]
                    nw = o.get(_NARROW_KEY)
                    if nw is None:
                        return raw
                    wire_dt, orig_dt = nw
                    np.dtype(wire_dt), np.dtype(orig_dt)   # valid dtypes
                    return LazySeg(raw, wire_dt, orig_dt)
                return {k: fill(v) for k, v in o.items()}
            if isinstance(o, list):
                return [fill(v) for v in o]
            return o

        t0 = time.perf_counter()
        out = fill(header)
        WIRE_TIMERS.add_split("WireDecode", "host_glue",
                              time.perf_counter() - t0)
        return out
    except (UnicodeDecodeError, ValueError, KeyError,
            IndexError, TypeError) as e:
        raise CorruptFrame(f"undecodable {len(body)}-byte v2 frame: "
                           f"{e}") from e


def encode_frame(obj: dict, wire: int = 1) -> bytes:
    """Complete on-wire bytes (outer length prefix included)."""
    if wire >= 2:
        body = _encode_v2(obj)
    else:
        body = json.dumps(obj, default=_json_default).encode()
    return len(body).to_bytes(4, "big") + body


def decode_frame(body: bytes, wire: int = 1) -> dict:
    if wire >= 2:
        return _decode_v2(body)
    try:
        return json.loads(body.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise CorruptFrame(f"undecodable {len(body)}-byte frame: {e}") from e


def send_frame(sock: socket.socket, obj: dict, wire: int = 1,
               peer: str = "") -> None:
    frame = encode_frame(obj, wire)
    link_model().charge(len(frame), peer)
    # the only lock a sender holds here is its Conn's, which serializes
    # one socket conversation by design (Conn.call)
    sock.sendall(frame)  # drynx: noqa[blocking-call-under-lock]


def recv_frame(sock: socket.socket, wire: int = 1,
               max_bytes: Optional[int] = None,
               rx_node: str = "") -> Optional[dict]:
    """One frame, or None on a clean EOF. Raises :class:`FrameTooLarge`
    before allocating anything for an oversized header and
    :class:`CorruptFrame` when the body does not decode under `wire`.
    `rx_node` attributes the received bytes to a node in the link model's
    receive ledger ("" skips it)."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    n = int.from_bytes(head, "big")
    cap = MAX_FRAME_BYTES if max_bytes is None else int(max_bytes)
    if n > cap:
        raise FrameTooLarge(
            f"frame header announces {n} bytes, cap is {cap} "
            f"(set_max_frame_bytes to raise)")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    if rx_node:
        link_model().count_rx(4 + n, rx_node)
    return decode_frame(body, wire)


def send_msg(sock: socket.socket, obj: dict) -> None:
    """v1 send, for raw-socket callers outside a negotiated Conn."""
    send_frame(sock, obj, 1)


def recv_msg(sock: socket.socket,
             max_bytes: Optional[int] = None) -> Optional[dict]:
    """v1 receive."""
    return recv_frame(sock, 1, max_bytes)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))  # drynx: noqa[blocking-call-under-lock]
        if not chunk:
            return None
        buf += chunk
    return buf


def _send_faulted_frame(sock: socket.socket, frame: bytes,
                        act: faults.FaultSpec) -> bool:
    """Send (or suppress) one encoded frame as a request/reply fault says.
    Returns False when the connection must be torn down. Corrupting the
    first body byte breaks both wires: v1's JSON starts with 0xFF, v2's
    header length exceeds any body."""
    if act.kind == "drop":
        return True                      # the frame vanishes on the wire
    # as send_frame: the caller holds only its Conn's own lock
    if act.kind == "delay":
        time.sleep(act.delay_s)  # drynx: noqa[blocking-call-under-lock]
        sock.sendall(frame)  # drynx: noqa[blocking-call-under-lock]
        return True
    if act.kind == "corrupt":
        sock.sendall(  # drynx: noqa[blocking-call-under-lock]
            frame[:4] + b"\xff" + frame[5:])
        return True
    if act.kind == "close_mid_frame":
        body = len(frame) - 4
        sock.sendall(  # drynx: noqa[blocking-call-under-lock]
            frame[:4 + max(1, body // 2)])
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        return False
    raise ValueError(f"unhandled fault kind {act.kind!r}")


# ---------------------------------------------------------------------------
# Server and client connections
# ---------------------------------------------------------------------------

Handler = Callable[[dict], dict]


class NodeServer:
    """A request/response dispatcher over TCP, one thread a connection
    (the onet service-handler analogue: handlers registered by message
    type). `node_name` names this node to the fault plan's node and reply
    hooks; `wire` is the highest wire version it agrees to.

    Each connection starts in v1 and upgrades when the client's
    ``wire_hello`` arrives; the hello never reaches a handler and never
    consults the fault plan."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 node_name: str = "", wire: int = WIRE_DEFAULT):
        self.handlers: dict[str, Handler] = {}
        self.node_name = node_name
        self.wire = int(wire)
        outer = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                wire = 1
                # handlers dial other nodes from this thread: pin the
                # serving node so their replies land on its receive ledger
                set_current_node(outer.node_name)
                while True:
                    plan = faults.fault_plan()
                    name = outer.node_name
                    if plan is not None and name and plan.killed(name):
                        return           # a dead node closes without a word
                    try:
                        msg = recv_frame(self.request, wire, rx_node=name)
                    except TransportError:
                        # bad framing is unrecoverable on a stream: drop the
                        # connection; the peer sees ConnectionClosed
                        return
                    if msg is None:
                        return
                    mtype = msg.get("type", "")
                    if mtype == "wire_hello":
                        agreed = min(int(msg.get("max", 1)), outer.wire)
                        send_frame(self.request,
                                   {"type": "wire_hello_reply",
                                    "wire": agreed}, wire)
                        wire = agreed
                        continue
                    if plan is not None and name:
                        nf = plan.node_fault(name)
                        if nf is not None and nf.kind == "kill":
                            return
                        if nf is not None and nf.kind == "pause":
                            time.sleep(nf.delay_s)
                    fn = outer.handlers.get(mtype)
                    try:
                        if fn is None:
                            raise KeyError(f"no handler for {mtype!r}")
                        reply = fn(msg)
                        reply.setdefault("type", mtype + "_reply")
                    except Exception as e:  # reported to the caller
                        reply = {"type": "error", "error": repr(e)}
                    act = (plan.pick("reply", name, mtype)
                           if plan is not None and name else None)
                    if act is not None:
                        frame = encode_frame(reply, wire)
                        if not _send_faulted_frame(self.request, frame,
                                                   act):
                            return
                        continue
                    send_frame(self.request, reply, wire)

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = _Srv((host, port), _H)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def register(self, mtype: str, fn: Handler) -> None:
        self.handlers[mtype] = fn

    # how often the accept loop looks for a shutdown request: stop()
    # returns within it
    POLL_S = 0.05

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, args=(self.POLL_S,),
            daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.server.serve_forever(self.POLL_S)

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class Conn:
    """A client connection with request/response semantics.

    `peer` names the destination for the fault plan and for error texts
    (call_entry passes the roster name; "host:port" otherwise). After a
    failure mid-exchange the connection is ``broken``: closed, and every
    later call raises ConnectionClosed. ``sent`` says whether the last
    call wrote any request bytes (the retry policy's idempotency gate).
    Right after the connect it negotiates the wire format up to `wire`
    (default v2) with one v1 ``wire_hello`` round trip."""

    def __init__(self, host: str, port: int,
                 timeout: float = rp.CALL_TIMEOUT_S, peer: str = "",
                 wire: int = WIRE_DEFAULT):
        self.peer = peer or f"{host}:{port}"
        self.host, self.port = host, int(port)
        self.broken = False
        self.closed = False
        self.sent = False
        self.wire = 1
        self._timeout = float(timeout)
        self._lock = rp.named_lock("conn_lock")
        plan = faults.fault_plan()
        if plan is not None:
            if plan.killed(self.peer):
                raise ConnectError(f"connect to {self.peer} refused "
                                   f"(fault plan: node killed)")
            src = current_node() or "client"
            if plan.partitioned(src, self.peer):
                raise ConnectError(
                    f"connect {src} -> {self.peer} refused "
                    f"(fault plan: partitioned)")
            act = plan.pick("connect", self.peer)
            if act is not None:
                if act.kind == "delay":
                    time.sleep(act.delay_s)
                elif act.kind == "refuse":
                    raise ConnectError(
                        f"connect to {self.peer} refused (fault plan)")
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
        except OSError as e:
            raise ConnectError(f"connect to {self.peer} failed: {e}") from e
        self._negotiate(int(wire))
        if _PROTO_TRACE:
            # minted only for fully constructed conns: a failed
            # negotiation raises before any caller holds a checkout
            from ..analysis import prototrace
            self._proto_inst = prototrace.new_instance("conn")
            prototrace.record(self._proto_inst, "checkout")

    def _negotiate(self, want: int) -> None:
        if want < 2:
            return
        try:
            send_frame(self.sock, {"type": "wire_hello", "max": want},
                       1, peer=self.peer)
            reply = recv_frame(self.sock, 1,
                               rx_node=current_node() or "client")
            if (reply is not None and reply.get("type") != "error"
                    and int(reply.get("wire", 1)) >= 2):
                self.wire = 2
        except (TransportError, OSError) as e:
            self._mark_broken()
            raise ConnectError(
                f"wire negotiation with {self.peer} failed: {e}") from e
        if reply is None:
            self._mark_broken()
            raise ConnectError(
                f"connection closed by {self.peer} during wire "
                f"negotiation")

    # One request/response on a connection at a time: the lock covers the
    # send and the receive, since interleaved frames on one socket would
    # corrupt both conversations. Parallelism across peers comes from the
    # pool handing each worker its own connection.
    def call(self, obj: dict) -> dict:
        mtype = obj.get("type", "")
        if self.broken or self.closed:
            raise ConnectionClosed(
                f"connection to {self.peer} already broken")
        if _PROTO_TRACE:
            _proto_record(self, "use")
        with self._lock:
            self.sent = False
            try:
                plan = faults.fault_plan()
                if (plan is not None
                        and plan.partitioned(current_node() or "client",
                                             self.peer)):
                    # the link is cut: nothing leaves, `sent` stays False
                    # and the retry policy treats it as a connect failure
                    self._mark_broken()
                    raise ConnectionClosed(
                        f"link to {self.peer} cut before {mtype!r} "
                        f"(fault plan: partitioned)")
                act = (plan.pick("request", self.peer, mtype)
                       if plan is not None else None)
                if act is not None:
                    self.sent = True
                    frame = encode_frame(obj, self.wire)
                    if not _send_faulted_frame(self.sock, frame, act):
                        self._mark_broken()
                        raise ConnectionClosed(
                            f"connection to {self.peer} lost after partial "
                            f"write of {mtype!r} (fault plan)")
                else:
                    send_frame(  # drynx: noqa[blocking-call-under-lock]
                        self.sock, obj, self.wire, peer=self.peer)
                    self.sent = True
                reply = recv_frame(  # drynx: noqa[blocking-call-under-lock]
                    self.sock, self.wire, rx_node=current_node() or "client")
            except ConnectionClosed:
                raise
            except socket.timeout as e:
                self._mark_broken()
                raise CallTimeout(
                    f"timeout mid-call to {self.peer} ({mtype!r}); "
                    f"connection dropped") from e
            except TransportError:
                self._mark_broken()
                raise
            except OSError as e:
                self._mark_broken()
                raise ConnectionClosed(
                    f"connection to {self.peer} failed mid-call "
                    f"({mtype!r}): {e}") from e
        if reply is None:
            self._mark_broken()
            raise ConnectionClosed(
                f"connection closed by peer {self.peer}")
        if reply.get("type") == "error":
            raise RemoteError(f"remote error: {reply.get('error')}")
        return reply

    def _mark_broken(self) -> None:
        if _PROTO_TRACE and not self.broken:
            _proto_record(self, "timeout")
        # a Conn is checked out by one thread at a time (the pool hands
        # each worker its own), and the flag only ever turns True
        self.broken = True  # drynx: noqa[unguarded-shared-mutation]
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        if _PROTO_TRACE and not self.closed:
            _proto_record(self, "close")
        self.closed = True
        self.sock.close()


class ConnPool:
    """Per-process connection reuse, keyed by (peer, host, port).

    ``call_entry`` checks a connection out, runs one exchange and returns
    it on success (a RemoteError included: the handler raised, the framing
    is intact); anything that broke the exchange leaves it ``broken`` and
    :meth:`put` refuses it. Checkout re-validates a pooled socket with a
    zero-timeout MSG_PEEK: an EOF or stray bytes (a reply that came after
    its caller timed out) disqualify it. At most `max_idle` idle
    connections a key and `max_total` in all: at the cap a put closes the
    least recently pooled one first. A connection that broke mid-exchange
    makes its key suspect: the next checkout dials fresh, and once that
    dial succeeds the key's stale idle stack is purged. Connections it
    dials negotiate up to `wire`. The fault plan's connect hook fires only
    on real connects."""

    def __init__(self, max_idle: int = rp.CONN_POOL_MAX_IDLE,
                 max_total: int = rp.CONN_POOL_MAX,
                 wire: int = WIRE_DEFAULT):
        self.max_idle = int(max_idle)
        self.max_total = int(max_total)
        self.wire = int(wire)
        self._lock = rp.named_lock("connpool_lock")
        # stacks of (stamp, Conn): LIFO per key keeps the warmest socket
        # on top, the stamp orders the global LRU eviction
        self._idle: dict[tuple, list[tuple[int, Conn]]] = {}
        self._suspect: set[tuple] = set()
        self._stamp = 0
        self.connects = 0
        self.reuses = 0
        self.discards = 0
        self.evictions = 0
        self.purges = 0

    @staticmethod
    def _key(conn: Conn) -> tuple:
        return (conn.peer, conn.host, conn.port)

    def get(self, host: str, port: int,
            timeout: float = rp.CALL_TIMEOUT_S, peer: str = "") -> Conn:
        key = (peer or f"{host}:{port}", host, int(port))
        with self._lock:
            suspect = key in self._suspect
        # a suspect key skips its idle stack: those sockets pass MSG_PEEK
        # (a cut link delivers no FIN) but each would burn a call timeout
        while not suspect:
            with self._lock:
                stack = self._idle.get(key)
                conn = stack.pop()[1] if stack else None
            if conn is None:
                break
            if self._healthy(conn, timeout):
                with self._lock:
                    self.reuses += 1
                conn._timeout = float(timeout)
                if _PROTO_TRACE:
                    # a reuse starts a fresh checkout lifecycle: the
                    # previous token ended at its accepting "returned"
                    from ..analysis import prototrace
                    conn._proto_inst = prototrace.new_instance("conn")
                    prototrace.record(conn._proto_inst, "checkout")
                return conn
            self.discard(conn)
        conn = Conn(host, port, timeout=timeout, peer=peer, wire=self.wire)
        stale: list[Conn] = []
        with self._lock:
            self.connects += 1
            if key in self._suspect:
                self._suspect.discard(key)
                stale = [c for _stamp, c in self._idle.pop(key, [])]
                self.purges += len(stale)
        for s in stale:
            try:
                s.sock.close()
            except OSError:
                pass
            s.closed = True
        return conn

    @staticmethod
    def _healthy(conn: Conn, timeout: float) -> bool:
        if conn.broken or conn.closed:
            return False
        try:
            conn.sock.setblocking(False)
            try:
                conn.sock.recv(1, socket.MSG_PEEK)
            except (BlockingIOError, InterruptedError):
                return True          # nothing pending: idle and alive
            finally:
                conn.sock.settimeout(timeout)
            return False             # EOF or stray bytes: desynced
        except OSError:
            return False

    def put(self, conn: Optional[Conn]) -> None:
        if conn is None:
            return
        if conn.broken or conn.closed:
            self.discard(conn)
            return
        if _PROTO_TRACE:
            _proto_record(conn, "put")
        key = self._key(conn)
        evicted: list[Conn] = []
        pooled = False
        with self._lock:
            if len(self._idle.get(key, ())) < self.max_idle:
                while (sum(len(s) for s in self._idle.values())
                       >= self.max_total):
                    victim = self._pop_lru_locked()
                    if victim is None:
                        break
                    evicted.append(victim)
                    self.evictions += 1
                self._stamp += 1
                # fetched after the eviction, which may have removed this
                # key's stack
                self._idle.setdefault(key, []).append((self._stamp, conn))
                pooled = True
        for v in evicted:
            try:
                v.sock.close()
            except OSError:
                pass
            v.closed = True
        if not pooled:
            # surplus over the idle depth: healthy, so the peer's pooled
            # sockets stay trusted
            self.discard(conn, suspect=False)

    def _pop_lru_locked(self) -> Optional[Conn]:
        """Remove and return the least recently pooled idle connection
        (the caller holds the lock)."""
        best_key, best_stamp = None, None
        for key, stack in self._idle.items():
            if stack and (best_stamp is None or stack[0][0] < best_stamp):
                best_key, best_stamp = key, stack[0][0]
        if best_key is None:
            return None
        conn = self._idle[best_key].pop(0)[1]
        if not self._idle[best_key]:
            del self._idle[best_key]
        return conn

    def discard(self, conn: Optional[Conn], *,
                suspect: bool = True) -> None:
        if conn is None:
            return
        if _PROTO_TRACE and not conn.closed:
            _proto_record(conn, "discard")
        with self._lock:
            self.discards += 1
            if suspect:
                self._suspect.add(self._key(conn))
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.closed = True

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for stack in idle.values():
            for _stamp, conn in stack:
                try:
                    conn.sock.close()
                except OSError:
                    pass
                conn.closed = True

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._idle.values())

    def stats(self) -> dict:
        with self._lock:
            return {"connects": self.connects, "reuses": self.reuses,
                    "discards": self.discards,
                    "evictions": self.evictions, "purges": self.purges,
                    "idle": sum(len(s) for s in self._idle.values())}


_POOL: Optional[ConnPool] = None
# two fan-out workers racing through conn_pool() must not build two pools
_POOL_LOCK = rp.named_lock("connpool_init_lock")


def conn_pool() -> ConnPool:
    """The process's connection pool, made on first use."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = ConnPool()
    return _POOL


def set_conn_pool(p: Optional[ConnPool]) -> None:
    """Install `p` as the process's pool (None: a fresh default one on the
    next use), closing the old pool's idle sockets."""
    global _POOL
    with _POOL_LOCK:
        old, _POOL = _POOL, p
    if old is not None and old is not p:
        old.close_all()


# ---------------------------------------------------------------------------
# In-process calls and the bounded fan-out
# ---------------------------------------------------------------------------

def local_call(peer: str, mtype: str, fn, *args, **kwargs):
    """Run an in-process node call under the fault plan's hooks, in the
    order a TCP exchange meets them (Conn.__init__, Conn.call, the
    NodeServer handler):

      kill       the peer killed -> ConnectError;
      partition  the link from this thread's node (or "client") to the
                 peer cut -> ConnectError;
      connect    refuse -> ConnectError; delay -> sleep, then go on;
      request    drop -> CallTimeout (at once, where a socket would wait
                 out its timeout); corrupt / close_mid_frame ->
                 ConnectionClosed; delay -> sleep, then go on;
      node       kill -> ConnectError; pause -> sleep delay_s, then go on;
      the call;
      reply      drop / corrupt / close_mid_frame -> ConnectionClosed (the
                 node did the work, the answer is lost); delay -> sleep.

    With no plan installed it is the call itself."""
    plan = faults.fault_plan()
    if plan is None:
        return fn(*args, **kwargs)
    if plan.killed(peer):
        raise ConnectError(f"connect to {peer} refused "
                           f"(fault plan: node killed)")
    src = current_node() or "client"
    if plan.partitioned(src, peer):
        raise ConnectError(f"connect {src} -> {peer} refused "
                           f"(fault plan: partitioned)")
    act = plan.pick("connect", peer)
    if act is not None:
        if act.kind == "refuse":
            raise ConnectError(f"connect to {peer} refused (fault plan)")
        if act.kind == "delay":
            time.sleep(act.delay_s)
    act = plan.pick("request", peer, mtype)
    if act is not None:
        if act.kind == "drop":
            raise CallTimeout(
                f"timeout mid-call to {peer} ({mtype!r}); "
                f"request dropped (fault plan)")
        if act.kind in ("corrupt", "close_mid_frame"):
            raise ConnectionClosed(
                f"connection to {peer} lost mid-request of {mtype!r} "
                f"(fault plan: {act.kind})")
        if act.kind == "delay":
            time.sleep(act.delay_s)
    nf = plan.node_fault(peer)
    if nf is not None and nf.kind == "kill":
        raise ConnectError(f"connect to {peer} refused "
                           f"(fault plan: node killed)")
    if nf is not None and nf.kind == "pause":
        time.sleep(nf.delay_s)
    out = fn(*args, **kwargs)
    act = plan.pick("reply", peer, mtype)
    if act is not None:
        if act.kind in ("drop", "corrupt", "close_mid_frame"):
            raise ConnectionClosed(
                f"reply from {peer} lost for {mtype!r} "
                f"(fault plan: {act.kind})")
        if act.kind == "delay":
            time.sleep(act.delay_s)
    return out


def fan_out(entries, call: Callable) -> list:
    """`call(entry)` for each roster entry on a bounded pool (at most
    `rp.FAN_OUT_WORKERS` in flight, one at a time when it is 1), each
    with the caller's node identity. Returns `[(reply, None) | (None,
    exc)]` in roster order, whatever order the calls finish in."""
    entries = list(entries)
    results: list = [None] * len(entries)
    n = max(1, min(rp.FAN_OUT_WORKERS, len(entries)))
    if n == 1:
        for i, e in enumerate(entries):
            try:
                results[i] = (call(e), None)
            except Exception as err:
                results[i] = (None, err)
        return results
    caller = current_node()

    def run(e):
        set_current_node(caller)
        return call(e)

    with ThreadPoolExecutor(max_workers=n) as ex:
        futs = {ex.submit(run, e): i for i, e in enumerate(entries)}
        for f in as_completed(futs):
            try:
                results[futs[f]] = (f.result(), None)
            except Exception as err:
                results[futs[f]] = (None, err)
    return results


__all__ = ["b64", "unb64", "pack_array", "unpack_array",
           "unpack_array_device", "DEVICE_DECODE_MIN_BYTES", "WIRE_TIMERS",
           "LazySeg", "widen_pairs", "send_msg", "recv_msg", "send_frame",
           "recv_frame", "encode_frame", "decode_frame", "WIRE_DEFAULT",
           "jsonable", "NodeServer", "Conn", "ConnPool", "conn_pool",
           "set_conn_pool", "LinkModel", "link_model", "set_link_model",
           "set_max_frame_bytes", "MAX_FRAME_BYTES", "local_call", "fan_out",
           "set_current_node", "current_node", "TransportError",
           "ConnectError", "ConnectionClosed", "CallTimeout", "FrameTooLarge",
           "CorruptFrame", "RemoteError"]
