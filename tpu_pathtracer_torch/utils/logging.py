"""Structured logging with the reference's level-tag format, as
`tpu_pathtracer/utils/logging.py` (without its JAX compile-cache switch).

`[level][tag][seconds since import]: message` to stderr, at or below the
verbosity (4 = info by default)."""

from __future__ import annotations

import sys
import time

_LEVELS = {"fatal": 1, "error": 2, "warn": 3, "info": 4, "debug": 5}
_verbosity = 4
_start = time.time()


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def log(level: str, tag: str, message: str, stream=None) -> None:
    lv = _LEVELS.get(level, 4)
    if lv > _verbosity:
        return
    stream = stream or sys.stderr
    t = time.time() - _start
    stream.write(f"[{lv:2d}][{tag:>12s}][{t:8.2f}s]: {message}\n")
    stream.flush()


def info(tag: str, message: str) -> None:
    log("info", tag, message)


def warn(tag: str, message: str) -> None:
    log("warn", tag, message)


_warned: set = set()


def warn_once(tag: str, message: str) -> None:
    """warn(), deduplicated by (tag, message) for the process lifetime."""
    key = (tag, message)
    if key in _warned:
        return
    _warned.add(key)
    warn(tag, message)


def error(tag: str, message: str) -> None:
    log("error", tag, message)


def debug(tag: str, message: str) -> None:
    log("debug", tag, message)
