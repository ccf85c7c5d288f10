"""Typed error taxonomy for the fault-tolerant request path.

The request path must distinguish three failure classes, because each
gets different treatment by ``DeploymentHandle.call``:

- **Transport / placement** (:class:`RetryableTransportError` and the
  builtin ``ConnectionError`` family): the call may never have reached
  the application. Idempotent calls fail over to another healthy
  replica; non-idempotent calls surface the error exactly once, typed,
  so the caller KNOWS the outcome is ambiguous.
- **Application** (anything the deployment instance raised, locally or
  as a :class:`~bioengine_tpu_torch.rpc.protocol.RemoteError`): the call ran
  and failed deterministically. Never retried — retrying would double
  side effects and hide real bugs.
- **Deadline** (:class:`DeadlineExceeded`): the request's time budget
  ran out. A per-attempt timeout is ambiguous like a transport error
  (retry only if idempotent and budget remains); an exhausted overall
  deadline is terminal.

Remote classification rides the wire via exception TYPE NAMES: the RPC
plane packs ``type(exc).__name__`` into ``RemoteError.type_name``
(rpc/protocol.py ``_pack_exception``), so a worker host raising
``ReplicaUnavailableError`` is recognized as retryable on the
controller side without any new wire fields.
"""

from __future__ import annotations

import asyncio
import enum

from bioengine_tpu_torch.rpc.protocol import RemoteError


class RetryableTransportError(RuntimeError):
    """The call failed before/while crossing the transport or placement
    layer — the application may never have seen it. Safe to retry when
    the call is idempotent."""


class ReplicaUnavailableError(RetryableTransportError):
    """The targeted replica cannot take new calls (not healthy, gone
    from its host, or draining). A placement error: another replica may
    serve the same call."""


class NoHealthyReplicasError(RetryableTransportError):
    """No routable replica exists right now (restart window). Retryable
    because the health loop / provisioner may re-place one."""


class ApplicationError(Exception):
    """The deployment instance itself raised — deterministic, never
    retried. (Classification treats any unrecognized exception as
    application-level; this type exists for callers that want to raise
    an explicitly-final error through the retry layer.)"""


class StaleEpochError(RuntimeError):
    """A control verb carried a LOWER controller epoch than this host
    has already seen — the sender is a wedged-then-revived old
    controller that lost a crash/upgrade race. The verb is rejected
    (epoch fencing, the split-brain guard): deliberately NOT a
    transport error, because retrying the same stale verb can never
    succeed and failing it over would just spray the stale intent at
    another host. Classified APPLICATION both locally and over the
    wire (``RemoteError.type_name == "StaleEpochError"`` is not in the
    retryable set)."""

    def __init__(self, message: str, seen_epoch: int = 0,
                 got_epoch: int = 0):
        super().__init__(message)
        self.seen_epoch = seen_epoch
        self.got_epoch = got_epoch


class StaleTableError(StaleEpochError):
    """A routing-table push carried a LOWER journal epoch (or a lower
    version under the SAME epoch) than the router already holds — the
    publisher is a wedged-then-revived old controller, or the push was
    reordered in flight. Rejected typed so the stale table can never
    regress a router's newer view; inherits the non-retryable
    classification of :class:`StaleEpochError` (re-pushing the same
    stale table can never succeed)."""


class RouterClosedError(RetryableTransportError):
    """The standalone router this request landed on is shutting down
    (or was killed) and admits no new requests. Retryable by design:
    the routing tier is stateless-per-request, so the client's typed
    retry machinery fails the request over to a sibling router."""


class AdmissionRejectedError(RuntimeError):
    """The global scheduler shed this request at admission (queue depth
    over budget, tenant quota exhausted, or a deadline that could never
    be met). Deliberately NOT retryable: the rejection is the
    deployment-wide backpressure signal — retrying against the same
    saturated queue (or failing over to a sibling replica of the same
    deployment) cannot help; back off at the client instead.
    ``reason`` is one of ``queue_full`` / ``tenant_quota`` /
    ``deadline_infeasible``."""

    def __init__(self, message: str, reason: str = "queue_full"):
        super().__init__(message)
        self.reason = reason


class RouterSaturatedError(AdmissionRejectedError):
    """The standalone router this request landed on is at its inflight
    cap (``BIOENGINE_ROUTER_MAX_INFLIGHT``). Same non-retryable
    backpressure semantics as its parent — every sibling router shares
    the replica pool, so failing over would just move the overload —
    but typed so dashboards can tell router saturation apart from a
    scheduler queue rejection."""

    def __init__(self, message: str):
        super().__init__(message, reason="router_saturated")


class DeadlineExceeded(asyncio.TimeoutError):
    """The request's overall deadline expired (including any failover
    backoff)."""


class FailureKind(str, enum.Enum):
    TRANSPORT = "transport"
    APPLICATION = "application"
    DEADLINE = "deadline"


# Remote exception type names that indicate the failure happened in the
# transport/placement layer on the far side, not in application code.
_RETRYABLE_REMOTE_TYPES = frozenset(
    {
        "ConnectionError",
        "ConnectionResetError",
        "ConnectionAbortedError",
        "ConnectionRefusedError",
        "ConnectionLost",       # rpc.client: ws dropped with call in flight
        "BrokenPipeError",
        "FaultInjected",
        "RetryableTransportError",
        "ReplicaUnavailableError",
        "NoHealthyReplicasError",
    }
)


def classify_exception(exc: BaseException) -> FailureKind:
    """Map an exception from a replica call to its failure class."""
    if isinstance(exc, DeadlineExceeded):
        return FailureKind.DEADLINE
    if isinstance(exc, (ApplicationError, AdmissionRejectedError)):
        # admission rejection is terminal backpressure, not a transport
        # fault — the retry layer must surface it, never fail it over
        return FailureKind.APPLICATION
    if isinstance(exc, (RetryableTransportError, ConnectionError)):
        return FailureKind.TRANSPORT
    if isinstance(exc, (asyncio.TimeoutError, TimeoutError)):
        # a per-attempt timeout: outcome ambiguous, same retry rules as
        # a transport error (idempotent-only)
        return FailureKind.TRANSPORT
    if isinstance(exc, RemoteError):
        if exc.type_name in _RETRYABLE_REMOTE_TYPES:
            return FailureKind.TRANSPORT
        if exc.type_name == "TimeoutError":
            return FailureKind.TRANSPORT  # remote per-attempt timeout
        if exc.type_name == "KeyError" and "no replica" in str(exc):
            # the host dropped/never had the replica — placement moved
            return FailureKind.TRANSPORT
        return FailureKind.APPLICATION
    if isinstance(exc, OSError):
        return FailureKind.TRANSPORT
    return FailureKind.APPLICATION


def is_retryable(exc: BaseException) -> bool:
    return classify_exception(exc) is FailureKind.TRANSPORT


def is_caller_timeout(exc: BaseException) -> bool:
    """The CALLER's own time budget expired — locally
    (``asyncio.TimeoutError``, incl. :class:`DeadlineExceeded`) or
    enforced host-side and returned over the wire
    (``RemoteError('TimeoutError')``). Retry rules treat it like
    transport (outcome ambiguous), but it is NOT replica-health
    evidence: an impatient client must never feed the circuit breaker.
    This predicate is the ONE definition of that breaker discipline —
    router, scheduler fast path, and group dispatch all call it."""
    return isinstance(exc, asyncio.TimeoutError) or (
        isinstance(exc, RemoteError) and exc.type_name == "TimeoutError"
    )
