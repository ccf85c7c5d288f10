"""Supervised background tasks.

``asyncio.create_task`` with the result discarded has two failure
modes the event loop never reports: the loop holds only a weak
reference, so the task can be garbage-collected mid-flight, and an
exception raised inside it is swallowed until interpreter shutdown
("Task exception was never retrieved").  ``spawn_supervised`` keeps a
strong reference until the task finishes and logs any exception via
the owner's logger — the standard way to fire off RPC dispatch and
deferred shutdown work in this codebase (flagged otherwise by
``bioengine analyze`` rule BE-ASYNC-003).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine, Optional

_BACKGROUND_TASKS: set[asyncio.Task] = set()

_fallback_logger = logging.getLogger("bioengine.tasks")


def spawn_supervised(
    coro: Coroutine[Any, Any, Any],
    *,
    name: Optional[str] = None,
    logger: Optional[logging.Logger] = None,
) -> asyncio.Task:
    """Schedule ``coro`` keeping a strong reference; log its exception.

    Cancellation is not an error (shutdown cancels these routinely).
    """
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _BACKGROUND_TASKS.add(task)
    log = logger or _fallback_logger

    def _on_done(t: asyncio.Task) -> None:
        _BACKGROUND_TASKS.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error(
                "background task %s failed: %r", t.get_name(), exc,
                exc_info=exc,
            )

    task.add_done_callback(_on_done)
    return task
