"""Exponential backoff with full jitter — the one shared implementation.

Used by the serving retry path (controller.DeploymentHandle), the RPC
client's reconnect loop, and the datasets HTTP retry. Full jitter
(delay uniform in [0, min(cap, base * 2**attempt)]) keeps a fleet that
failed together from retrying together (AWS architecture blog's
"Exponential Backoff And Jitter" result — full jitter minimizes total
work AND completion time versus equal or decorrelated jitter).
"""

from __future__ import annotations

import random

# 2**_MAX_EXPONENT * any sane base already exceeds any sane cap; beyond
# it the uncapped product overflows float for large attempt counts
# (0.2 * 2**1075 raises OverflowError) — clamp before multiplying.
_MAX_EXPONENT = 32


def full_jitter_delay(attempt: int, base_s: float, cap_s: float) -> float:
    """Delay before retry ``attempt`` (0-based): uniform in
    [0, min(cap_s, base_s * 2**attempt)]."""
    window = min(cap_s, base_s * (2 ** min(max(attempt, 0), _MAX_EXPONENT)))
    return random.uniform(0.0, window)
