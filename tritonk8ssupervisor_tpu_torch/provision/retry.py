"""Retry/backoff engine for the provisioning pipeline.

The reference aborted the whole run on the first non-zero child exit
(`set -o errexit`, setup.sh:3-4) and this rebuild kept that contract:
`CommandError` propagated straight to a failed run. Real TPU/GKE
provisioning is dominated by *transient* faults — API 429/5xx, SSH not
yet accepting connections, kubectl connection resets, preempted nodes —
which Podracer (PAPERS.md) treats as the normal operating regime for
TPU pods. This module makes transient-vs-fatal a first-class
distinction:

- `classify(CommandError)` sorts a failure into TRANSIENT (retry) or
  FATAL (abort now) from its exit code and output patterns.
- `RetryPolicy` bounds the retries: max attempts, exponential backoff
  with decorrelated jitter (the AWS formula — each delay is drawn from
  [base, 3*previous], capped), and an optional per-phase deadline
  budget covering attempts *and* sleeps.
- `retrying_runner(run, policy)` wraps any `RunFn` (run_streaming,
  run_capture, or a test fake) with that loop, so every wrapper —
  terraform, ansible, kubectl readiness probes, teardown — retries the
  same way without knowing it retries at all.

Every knob has an env override (TK8S_RETRY_*) so a live chaos drill can
tighten or loosen the policy without a code change; the fault-injection
harness (testing/faults.py) sits UNDER this wrapper so injected faults
exercise exactly the path real ones take.

The port's copy of `tritonk8ssupervisor_tpu/provision/retry.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import sys
import time
from typing import Callable

from tritonk8ssupervisor_tpu_torch.provision.runner import CommandError, RunFn

TRANSIENT = "transient"
FATAL = "fatal"


@dataclasses.dataclass(frozen=True)
class Classification:
    verdict: str  # TRANSIENT or FATAL
    cause: str  # short label for logs/runlog records, e.g. "rate-limited"
    # a floor under the backoff delay: rate/quota throttles (429,
    # RESOURCE_EXHAUSTED) refill on wall-clock windows measured in tens
    # of seconds — retrying at the generic 2 s cadence just burns the
    # attempt budget re-triggering the limiter. Capped by the policy's
    # max_delay, so a drill that zeroes the delays stays instant.
    min_delay: float = 0.0


# Rate/quota throttling backs off at least this long between attempts
# (GCP per-minute quota windows; AIP-194 recommends >= 30 s for
# RESOURCE_EXHAUSTED). The policy's max_delay still caps it.
QUOTA_BACKOFF_FLOOR = 30.0

# Throttle patterns are checked before everything else: an HTTP 429 /
# RESOURCE_EXHAUSTED is a *rate* verdict even when the message mentions
# "quota" (per-minute request quotas refill; resource quotas do not) —
# it must win over the fatal quota-exceeded pattern below, and it
# carries the long-backoff floor.
_THROTTLE_PATTERNS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"\b429\b|Too Many Requests|RESOURCE_EXHAUSTED|"
                r"rateLimitExceeded|rate limit", re.IGNORECASE),
     "rate-limited"),
]

# Fatal patterns are checked next: a quota error that happens to mention
# an HTTP status must not be retried into a 10-minute backoff spiral —
# when a failure is ambiguous, aborting loudly beats burning the phase
# deadline on a fault no retry can fix.
_FATAL_PATTERNS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"quota.{0,20}exceeded|QUOTA_EXCEEDED|quotaExceeded",
                re.IGNORECASE), "quota-exceeded"),
    (re.compile(r"PERMISSION_DENIED|permission denied|not authorized|"
                r"401 Unauthorized|Error 403|status code: 40[13]|"
                r"invalid_grant|oauth2.*token|application default credentials",
                re.IGNORECASE), "auth"),
    (re.compile(r"syntax error|ERROR! Syntax|Unsupported argument|"
                r"Invalid reference|Invalid value|unknown flag|"
                r"unrecognized arguments|invalid choice",
                re.IGNORECASE), "usage"),
]

_TRANSIENT_PATTERNS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"\b50[0234]\b|Internal Server Error|backendError|"
                r"internal error|Service Unavailable|Bad Gateway",
                re.IGNORECASE), "server-5xx"),
    (re.compile(r"connection res[e]?t|connection refused|broken pipe|"
                r"connection closed|unexpected EOF|network is unreachable|"
                r"no route to host|temporar(y|ily)|name resolution|"
                r"dial tcp", re.IGNORECASE), "connection"),
    (re.compile(r"TLS handshake|tls: ", re.IGNORECASE), "tls"),
    (re.compile(r"timed? ?out|deadline exceeded|i/o timeout",
                re.IGNORECASE), "timeout"),
    (re.compile(r"UNREACHABLE"), "host-unreachable"),  # ansible's banner
    (re.compile(r"Unable to connect to the server|error dialing backend|"
                r"etcdserver", re.IGNORECASE), "apiserver"),
]


def classify(error: CommandError) -> Classification:
    """Transient-vs-fatal verdict from exit code + captured output.

    Output patterns are matched against the captured tail only (never
    the command line itself — `-o ConnectTimeout=5` must not read as a
    timeout). Unmatched failures default to FATAL: an error we cannot
    name is an error we cannot promise a retry will fix, and errexit
    semantics are the safe fallback. HTTP 429 / RESOURCE_EXHAUSTED
    throttles are transient-with-long-backoff: they retry, but no sooner
    than QUOTA_BACKOFF_FLOOR (bounded by the policy's max_delay).
    """
    text = getattr(error, "tail", "") or ""
    for pattern, cause in _THROTTLE_PATTERNS:
        if pattern.search(text):
            return Classification(
                TRANSIENT, cause, min_delay=QUOTA_BACKOFF_FLOOR
            )
    for pattern, cause in _FATAL_PATTERNS:
        if pattern.search(text):
            return Classification(FATAL, cause)
    for pattern, cause in _TRANSIENT_PATTERNS:
        if pattern.search(text):
            return Classification(TRANSIENT, cause)
    rc = getattr(error, "returncode", None)
    if rc == 124:
        # run_streaming's hard-timeout kill (the bench.py wedged-tunnel
        # lesson): a hung child, not a wrong command.
        return Classification(TRANSIENT, "hang-timeout")
    if rc == 255:
        # ssh reserves 255 for connection-layer failures (sshd not up yet)
        return Classification(TRANSIENT, "ssh-connect")
    if rc == 127:
        return Classification(FATAL, "missing-binary")
    return Classification(FATAL, f"rc-{rc}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds for one logical command: attempts, backoff, budget.

    `deadline` caps the whole retry loop (attempt time + sleeps) so a
    phase cannot silently eat the 15-minute north-star budget; a retry
    whose backoff would cross the deadline is abandoned and the last
    error re-raised. `attempt_timeout` is forwarded to the underlying
    runner as `timeout=` — the per-child hang kill (rc 124), which the
    classifier then treats as transient.
    """

    max_attempts: int = 4
    base_delay: float = 2.0
    max_delay: float = 60.0
    deadline: float | None = None
    attempt_timeout: float | None = None

    @classmethod
    def from_env(cls, environ: dict | None = None) -> "RetryPolicy":
        env = os.environ if environ is None else environ

        def _opt(name: str) -> float | None:
            # unset or <= 0 means "no limit"
            raw = env.get(name, "")
            if raw == "":
                return None
            value = float(raw)
            return value if value > 0 else None

        return cls(
            max_attempts=max(1, int(env.get("TK8S_RETRY_MAX_ATTEMPTS", "4"))),
            base_delay=float(env.get("TK8S_RETRY_BASE_DELAY", "2.0")),
            max_delay=float(env.get("TK8S_RETRY_MAX_DELAY", "60.0")),
            deadline=_opt("TK8S_RETRY_DEADLINE"),
            attempt_timeout=_opt("TK8S_ATTEMPT_TIMEOUT"),
        )

    def next_delay(self, previous: float, rng: Callable[[], float]) -> float:
        """Decorrelated jitter: uniform over [base, 3*previous], capped.

        Spreads concurrent retriers apart (thundering-herd control for
        multi-slice applies hitting the same regional API) while still
        growing roughly exponentially.
        """
        low = self.base_delay
        high = max(low, 3.0 * previous)
        return min(self.max_delay, low + rng() * (high - low))


class Cooldown:
    """The decorrelated-jitter backoff sequence as reusable state.

    `RetryPolicy.next_delay` lives inside one retry loop; some consumers
    back off across EVENTS instead — the supervisor's circuit breaker
    (provision/supervisor.py) grows its cooldown between consecutive
    trips with exactly this formula (each delay drawn from
    [base, 3*previous], capped) so repeated breaker trips against a
    still-broken fleet space themselves out the way retried commands do.
    `reset()` snaps back to base after a confirmed recovery."""

    def __init__(
        self,
        base: float,
        cap: float,
        rng: Callable[[], float] = random.random,
    ) -> None:
        self._policy = RetryPolicy(base_delay=base, max_delay=cap)
        self._rng = rng
        self._previous = base

    def next(self) -> float:
        delay = self._policy.next_delay(self._previous, self._rng)
        self._previous = delay
        return delay

    def reset(self) -> None:
        self._previous = self._policy.base_delay


def retrying_runner(
    run: RunFn,
    policy: RetryPolicy | None = None,
    *,
    classify_fn: Callable[[CommandError], Classification] = classify,
    record: Callable[[str], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Callable[[], float] = random.random,
    echo: Callable[[str], None] = lambda line: print(
        line, file=sys.stderr, flush=True
    ),
) -> RunFn:
    """Wrap a RunFn with the transient-retry loop.

    FATAL failures re-raise on the first attempt; TRANSIENT ones back
    off and retry until attempts or the deadline budget run out, then
    re-raise the last error unchanged (the caller's error handling —
    cli/main.py's friendly ERROR path — stays intact). `record` is
    called with the short cause label once per retried attempt; wiring
    it to PhaseTimer.note_retry puts per-phase attempt counts into the
    runlog.
    """
    policy = policy or RetryPolicy()

    def attempting(args, **kwargs) -> str:
        if policy.attempt_timeout is not None:
            kwargs.setdefault("timeout", policy.attempt_timeout)
        start = clock()
        delay = policy.base_delay
        for attempt in range(1, policy.max_attempts + 1):
            try:
                return run(args, **kwargs)
            except CommandError as e:
                verdict = classify_fn(e)
                if verdict.verdict == FATAL or attempt >= policy.max_attempts:
                    raise
                delay = policy.next_delay(delay, rng)
                if verdict.min_delay:
                    # long-backoff floor (quota throttles), still capped
                    # by the policy so zeroed-delay drills stay instant
                    delay = max(delay, min(verdict.min_delay,
                                           policy.max_delay))
                if (
                    policy.deadline is not None
                    and clock() - start + delay > policy.deadline
                ):
                    raise  # backoff would cross the phase budget
                if record is not None:
                    record(verdict.cause)
                echo(
                    f"  transient failure ({verdict.cause}, rc "
                    f"{e.returncode}); retry {attempt}/"
                    f"{policy.max_attempts - 1} in {delay:.1f}s"
                )
                sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    return attempting
