"""The two types of the gateway that the serving engine's surface uses:
the port's own copy of `Request` and `StepResult` from
`tritonk8ssupervisor_tpu/serving/gateway.py` (:115-171, :295-309).

The rest of the gateway (admission, buckets, routing, the slice workers,
the HTTP server) is not ported yet: ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class Request:
    """One inference request. The real path carries prompt token ids in
    `tokens` and collects the generation in `out_tokens`; the engine
    reads `rid`, `prompt_len`, `max_new_tokens`, `tokens` and `key`."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    tokens: Any = None  # np.ndarray[int] on the real path
    bucket: int = 0
    # shared-system-prompt shape: the real engine ignores these (it hashes
    # token content)
    prefix_len: int = 0
    prefix_id: Any = None
    key: str | None = None  # client-supplied idempotency key
    deadline_s: float | None = None  # relative budget from arrival
    tenant: str | None = None
    priority: int = 0
    wfq_tag: float | None = None
    slice_index: int | None = None
    dispatched_at: float | None = None
    first_token_at: float | None = None
    done_at: float | None = None
    expired_at: float | None = None
    expired_where: str | None = None
    generated: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    retries: int = 0
    notify: Callable | None = None
    session_id: str | None = None
    turn: int = 0
    stream: bool = False
    on_token: Callable | None = None


@dataclasses.dataclass
class StepResult:
    """One engine step boundary's outcome: how long the step took (real
    engines return 0.0: the caller's clock measures them), tokens emitted
    per slot, the slots whose requests finished (mapping to their
    generated ids), and the step's new token ids per slot."""

    dt: float
    emitted: dict = dataclasses.field(default_factory=dict)  # slot -> n
    finished: dict = dataclasses.field(default_factory=dict)  # slot -> ids
    tokens: dict = dataclasses.field(default_factory=dict)  # slot -> new ids
