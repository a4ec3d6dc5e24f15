"""Error handling (copy of ``gunrock_tpu/utils/error.py``).

Role of reference include/gunrock/error.hxx:13-48: a framework exception
type and ``throw_if_exception(condition, message)`` guards for
framework-level invariant checks. PyTorch and the kernel loader raise
their own exceptions for device errors.
"""

from __future__ import annotations


class GunrockError(RuntimeError):
    """Role of reference ``gunrock::error::exception_t``."""


def throw_if_exception(condition: bool, message: str = "") -> None:
    """Role of reference ``error::throw_if_exception`` (error.hxx:38-46)."""
    if condition:
        raise GunrockError(message or "gunrock_tpu_torch runtime error")
