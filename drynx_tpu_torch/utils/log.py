"""Leveled logging (reference: onet's log.Lvl1/2/3 + log.Info/log.Error,
used throughout services/ and protocols/; debug visibility set per process
with log.SetDebugVisible — services/service_test.go:71).

Levels: 0 = errors+info only (default), 1..5 increasing verbosity.
Set via set_debug_visible(n) or the DRYNX_DEBUG env var. Python's stdlib
logging underneath so host applications can re-route handlers.
"""
from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("drynx_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s drynx: %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False

_visible = int(os.environ.get("DRYNX_DEBUG", "0") or 0)


def set_debug_visible(level: int) -> None:
    """0 = info/errors only; 1..5 = show lvl(n) for n <= level."""
    global _visible
    _visible = int(level)
    _logger.setLevel(logging.DEBUG if level > 0 else logging.INFO)


def debug_visible() -> int:
    return _visible


def lvl(n: int, *parts) -> None:
    if _visible >= n:
        _logger.log(logging.DEBUG if n > 1 else logging.INFO,
                    " ".join(str(p) for p in parts))


def lvl1(*parts) -> None:
    lvl(1, *parts)


def lvl2(*parts) -> None:
    lvl(2, *parts)


def lvl3(*parts) -> None:
    lvl(3, *parts)


def info(*parts) -> None:
    _logger.info(" ".join(str(p) for p in parts))


def warn(*parts) -> None:
    _logger.warning(" ".join(str(p) for p in parts))


def error(*parts) -> None:
    _logger.error(" ".join(str(p) for p in parts))


if _visible > 0:
    _logger.setLevel(logging.DEBUG)

__all__ = ["set_debug_visible", "debug_visible", "lvl", "lvl1", "lvl2",
           "lvl3", "info", "warn", "error"]
