"""HTTP GET with bounded retry + exponential backoff.

Capability parity with ref bioengine/datasets/utils/network.py:8-73
(4 attempts, 0.2 s exponential backoff, 4xx-except-429 never retried),
hardened for fleet behavior: FULL jitter on the backoff (a thousand
workers hitting one 503 must not re-synchronize their retries) and
``Retry-After`` honored on 429 responses (the server's stated budget
wins over our schedule, capped so a hostile header can't park us).
"""

from __future__ import annotations

import asyncio
import datetime
from email.utils import parsedate_to_datetime
from typing import Optional

import httpx

from bioengine_tpu_torch.utils.backoff import full_jitter_delay

MAX_ATTEMPTS = 4
BACKOFF_SECONDS = 0.2
RETRY_AFTER_CAP_SECONDS = 30.0


def _retry_after_seconds(resp: httpx.Response) -> Optional[float]:
    """Parse ``Retry-After`` (delta-seconds or HTTP-date form)."""
    raw = resp.headers.get("Retry-After")
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        pass
    try:
        dt = parsedate_to_datetime(raw)
        if dt.tzinfo is None:
            # '-0000' / zone-less dates parse NAIVE; RFC 7231 dates are
            # GMT, so pin UTC rather than crash on aware-naive subtraction
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (dt - now).total_seconds())
    except (TypeError, ValueError):
        return None


async def get_url_with_retry(
    url: str,
    params: Optional[dict] = None,
    headers: Optional[dict] = None,
    client: Optional[httpx.AsyncClient] = None,
    max_attempts: int = MAX_ATTEMPTS,
) -> httpx.Response:
    owns = client is None
    if owns:
        client = httpx.AsyncClient(timeout=httpx.Timeout(60.0))
    try:
        last_error: Exception = RuntimeError("unreachable")
        for attempt in range(max_attempts):
            retry_after: Optional[float] = None
            try:
                resp = await client.get(url, params=params, headers=headers)
                if resp.status_code < 400:
                    return resp
                # client errors are permanent, except throttling
                if 400 <= resp.status_code < 500 and resp.status_code != 429:
                    resp.raise_for_status()
                if resp.status_code == 429:
                    retry_after = _retry_after_seconds(resp)
                last_error = httpx.HTTPStatusError(
                    f"HTTP {resp.status_code} for {url}",
                    request=resp.request,
                    response=resp,
                )
            except httpx.HTTPStatusError:
                raise
            except httpx.HTTPError as e:
                last_error = e
            if attempt < max_attempts - 1:
                # exponential backoff with FULL jitter; a 429's
                # Retry-After sets the floor (capped — the server may
                # ask for minutes, we won't block a worker that long)
                delay = full_jitter_delay(attempt, BACKOFF_SECONDS, 60.0)
                if retry_after is not None:
                    delay = max(
                        delay, min(retry_after, RETRY_AFTER_CAP_SECONDS)
                    )
                await asyncio.sleep(delay)
        raise last_error
    finally:
        if owns:
            await client.aclose()
