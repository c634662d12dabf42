"""Transient-vs-fatal classification and backoff.

Counterpart of ``pta_replicator_tpu/faults/retry.py``: the policy
(:class:`RetryPolicy`), the classifier (:func:`is_transient`) and the
jittered exponential backoff (:func:`backoff_delay`) and the in-place
retry helper (:func:`retry_call`). The sweep retries a transient chunk
failure by resuming from its checkpoint sidecar, the prefetcher retries a
transient staging failure once in place, and the server retries a
transient engine call once through :func:`retry_call`; all classify
through :func:`is_transient`.

Transient means "the same operation, retried as it is, can plausibly
succeed": an injected fault marked transient (``inject.InjectedFault``,
whose ``transient`` decides), a stage wedged past its deadline (``DrainTimeout``), a dropped
connection, an interrupted or timed-out syscall, a full disk (``ENOSPC``:
space is often reclaimed, and the bounded budget stops a disk that stays
full). Fatal is everything else, and on the card in particular:

* an error raised by CUDA (a ``RuntimeError`` whose message names a CUDA
  error, or ``torch.AcceleratorError`` where torch has it). CUDA errors
  are sticky: the context is dead, and a retry in the same process cannot
  succeed;
* ``torch.cuda.OutOfMemoryError``, as the reference holds OOM fatal (the
  remedy is a smaller chunk, not the same one again).

Every absorbed retry emits a ``faults.retry`` event (:func:`retry_event`)
into the capture's event stream.
"""
from __future__ import annotations

import errno
import random
import time
from dataclasses import dataclass
from typing import Callable

import torch

from .inject import InjectedFault


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt ``k`` (1-based) sleeps
    ``min(max_delay_s, base_delay_s * multiplier**(k-1))``, jittered by
    ``+/- jitter`` (a fraction). ``max_attempts`` counts every try,
    the first included."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.5


#: the in-process supervisors' policy (sweep chunk retry, prefetch staging)
DEFAULT_POLICY = RetryPolicy()

#: syscall errnos a retry can plausibly outlive
_TRANSIENT_ERRNOS = frozenset({
    errno.EINTR, errno.EAGAIN, errno.ETIMEDOUT, errno.ECONNRESET,
    errno.ECONNREFUSED, errno.EPIPE, errno.ENOSPC,
})

#: lowercase message shapes of dropped connections and collectives
#: (RuntimeErrors without a typed hierarchy)
_TRANSIENT_PATTERNS = (
    "unavailable", "aborted", "failed to connect", "connection reset",
    "socket closed", "deadline exceeded",
)

#: lowercase message shapes of errors raised by CUDA itself: sticky, so
#: fatal whatever else the message says ("... busy or unavailable")
_CUDA_PATTERNS = ("cuda error", "cudaerror", "cublas_status", "cusolver_status",
                  "device-side assert")


def _is_cuda_error(exc: BaseException) -> bool:
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc).lower()
    return any(p in msg for p in _CUDA_PATTERNS)


def is_transient(exc: BaseException) -> bool:
    """True when retrying the same operation can plausibly succeed."""
    # imported here: parallel.stages imports nothing of this package, but
    # the executors that import both would otherwise cycle
    from ..parallel.stages import DrainTimeout

    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, DrainTimeout):
        return True
    if isinstance(exc, ConnectionError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    if isinstance(exc, (RuntimeError, SystemError)):
        if _is_cuda_error(exc):
            return False
        msg = str(exc).lower()
        return any(p in msg for p in _TRANSIENT_PATTERNS)
    return False


def backoff_delay(attempt: int, policy: RetryPolicy = DEFAULT_POLICY) -> float:
    """Delay before retry ``attempt`` (1-based), jittered from the process
    RNG."""
    base = min(policy.max_delay_s,
               policy.base_delay_s * policy.multiplier ** (attempt - 1))
    if policy.jitter <= 0:
        return base
    return base * (1.0 + policy.jitter * (2.0 * random.random() - 1.0))


def retry_call(fn: Callable, *, policy: RetryPolicy = DEFAULT_POLICY,
               classify: Callable[[BaseException], bool] = is_transient,
               sleep: Callable[[float], None] = time.sleep, scope: str = "retry_call"):
    """Call ``fn()`` under ``policy``: a fatal error re-raises at once and
    unchanged; a transient one backs off (``sleep``) and calls again until
    the attempts are spent (then the last error re-raises). Each retry
    emits a ``faults.retry`` event (``scope``: whose retry)."""
    attempt = 1
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — classified, then re-raised
            if attempt >= policy.max_attempts or not classify(exc):
                raise
            retry_event(scope, exc, attempt=attempt)
            sleep(backoff_delay(attempt, policy))
            attempt += 1


def retry_event(scope: str, exc: BaseException, **attrs) -> None:
    """Record one absorbed retry as a ``faults.retry`` event: ``scope``
    names whose retry it was (``sweep``, ``prefetch``), ``attrs`` where
    (the attempt, the chunk or tile), and the error is kept to 200
    characters."""
    from ..obs import event, names

    event(names.EVENT_FAULT_RETRY, scope=scope, **attrs, error=repr(exc)[:200])
