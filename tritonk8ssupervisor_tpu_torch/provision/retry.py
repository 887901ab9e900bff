"""Decorrelated-jitter backoff: the port's copy of
`tritonk8ssupervisor_tpu/provision/retry.py`'s `RetryPolicy.next_delay`
(:181) and `Cooldown` (:193-220), which the elastic trainer's bounded
wait for a heal draws its delays from. The formula is unchanged: each
delay is uniform over [base, 3 * previous], capped."""

from __future__ import annotations

import dataclasses
import random
from typing import Callable


@dataclasses.dataclass
class RetryPolicy:
    """The delay bounds of the reference's retry policy (its attempt
    counts, deadlines and env overrides drive the provisioning retries,
    which the port does not have)."""

    base_delay: float = 2.0
    max_delay: float = 60.0

    def next_delay(self, previous: float, rng: Callable[[], float]) -> float:
        """Decorrelated jitter: uniform over [base, 3*previous], capped.
        Spreads concurrent retriers apart while still growing roughly
        exponentially."""
        low = self.base_delay
        high = max(low, 3.0 * previous)
        return min(self.max_delay, low + rng() * (high - low))


class Cooldown:
    """The decorrelated-jitter backoff sequence as reusable state: a
    consumer that backs off across events (the trainer's wait for the
    supervisor to finish a heal) grows its delay with the same formula.
    `reset()` snaps back to base."""

    def __init__(self, base: float, cap: float,
                 rng: Callable[[], float] = random.random) -> None:
        self._policy = RetryPolicy(base_delay=base, max_delay=cap)
        self._rng = rng
        self._previous = base

    def next(self) -> float:
        delay = self._policy.next_delay(self._previous, self._rng)
        self._previous = delay
        return delay

    def reset(self) -> None:
        self._previous = self._policy.base_delay
