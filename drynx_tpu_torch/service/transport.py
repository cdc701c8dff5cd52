"""The in-process half of the control plane's transport.

The port's counterpart of the parts of drynx_tpu/service/transport.py and
drynx_tpu/service/node.py that an in-process cluster goes through: the
typed failure classes, the ambient node identity of a thread, `local_call`
(an in-process call under the fault plan's hooks, in the order a TCP
exchange meets them) and `fan_out` (one call per roster entry on a bounded
pool, results in roster order). The TCP half (frames, `NodeServer`,
`Conn`, `ConnPool`, the link model) and the nodes that serve it are step
16's second part (ROADMAP queue A).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable

from ..resilience import faults
from ..resilience import policy as rp


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


# The node a thread acts for: unset means the querier ("client").
# ThreadPoolExecutor threads inherit nothing, so fan_out re-pins the
# caller's identity on its workers.
_CURRENT_NODE = threading.local()


def set_current_node(name: str) -> None:
    _CURRENT_NODE.name = name


def current_node() -> str:
    return getattr(_CURRENT_NODE, "name", "")


def local_call(peer: str, mtype: str, fn, *args, **kwargs):
    """Run an in-process node call under the fault plan's hooks, in the
    order a TCP exchange meets them (reference transport.py:1185-1250):

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
    `rp.FAN_OUT_WORKERS` in flight; reference service/node.py:180), each
    with the caller's node identity. Returns `[(reply, None) | (None,
    exc)]` in roster order, whatever order the calls finish in."""
    entries = list(entries)
    results: list = [None] * len(entries)
    caller = current_node()

    def run(e):
        set_current_node(caller)
        return call(e)

    n = max(1, min(rp.FAN_OUT_WORKERS, len(entries)))
    with ThreadPoolExecutor(max_workers=n) as ex:
        futs = {ex.submit(run, e): i for i, e in enumerate(entries)}
        for f in as_completed(futs):
            try:
                results[futs[f]] = (f.result(), None)
            except Exception as err:
                results[futs[f]] = (None, err)
    return results


__all__ = ["TransportError", "ConnectError", "ConnectionClosed",
           "CallTimeout", "FrameTooLarge", "CorruptFrame", "RemoteError",
           "set_current_node", "current_node", "local_call", "fan_out"]
