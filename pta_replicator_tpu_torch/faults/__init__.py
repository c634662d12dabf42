"""Fault injection and supervised recovery.

Two halves, in one package so that the machinery and what exercises it
cannot drift apart (counterpart of ``pta_replicator_tpu/faults``):

* :mod:`.inject`: deterministic, seedable faults at named sites inside
  the stage spans (nothing but a ``None`` check while disarmed; armed by a
  schedule string, ``PTA_FAULTS`` or ``--faults``);
* :mod:`.retry`: the one transient-vs-fatal classifier and backoff policy
  of the sweep's chunk retry, the prefetch staging retry and the server's
  engine retry.
"""
from . import inject, retry
from .inject import InjectedFault, arm, arm_from_env, armed, disarm, fire
from .retry import DEFAULT_POLICY, RetryPolicy, backoff_delay, is_transient, retry_call

__all__ = [
    "inject", "retry", "InjectedFault", "arm", "arm_from_env", "armed", "disarm", "fire",
    "RetryPolicy", "DEFAULT_POLICY", "backoff_delay", "is_transient", "retry_call",
]
