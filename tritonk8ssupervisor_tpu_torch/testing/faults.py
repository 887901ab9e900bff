"""Deterministic fault injection for the provisioning pipeline.

The retry engine (provision/retry.py) is only trustworthy if its
fail→retry→converge and fail→fatal→abort paths can be driven without a
cloud. A `FaultPlan` wraps any `RunFn` and deterministically fails the
Nth invocation matching a command pattern — with a chosen exit code,
injected output (what the transient/fatal classifier reads), or a
hang-until-timeout (what the runner's process-group kill handles).

Plans are declarative JSON, loaded from the `--fault-plan` CLI flag or
the TK8S_FAULT_PLAN env var (inline JSON or a file path), so the same
plan drives three regimes:

- unit/e2e tests against stub binaries (tests/test_faults.py);
- chaos drills against a LIVE cluster — inject a terraform 429 into a
  real converge and watch the runlog count the retries;
- reproduction of a production incident from its captured output.

Plan shape (a bare list is accepted too)::

    {"faults": [
        {"match": "terraform apply", "times": 2, "rc": 1,
         "output": "Error: googleapi: Error 429: Too Many Requests"},
        {"match": "kubectl get nodes", "after": 1, "times": 1,
         "output": "Unable to connect to the server: net/http: TLS handshake timeout"},
        {"match": "ansible-playbook", "times": 1, "hang": true},
        {"match": "terraform apply", "kill": true}
    ]}

`match` is a regex searched against the joined command line. The first
rule whose pattern matches OWNS the invocation: its counter advances,
and the call fails iff the count is within [after, after+times).

`kill: true` is the crash-drill kind: instead of a failing child command
it raises `SupervisorKilled` (a BaseException — nothing retries or
records it), simulating SIGKILL of the supervisor at exactly that
invocation. Paired with the durable journal (provision/journal.py) it
drives the kill→resume drills: provision dies mid-DAG, the re-run skips
the journal-verified prefix and redoes only the dirty suffix.

The port's copy of `tritonk8ssupervisor_tpu/testing/faults.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import threading
import time
from pathlib import Path
from typing import Callable

from tritonk8ssupervisor_tpu_torch.provision.runner import CommandError, RunFn

ENV_VAR = "TK8S_FAULT_PLAN"


class FaultPlanError(ValueError):
    """The plan spec is malformed — always an operator error, never a
    reason to fall back to fault-free execution silently."""


class SupervisorKilled(BaseException):
    """Deterministic stand-in for SIGKILL-ing the supervisor mid-task
    (the `kill` fault kind). A BaseException on purpose: nothing may
    catch-and-handle it on the way out — no retry, no journal `failed`
    record — because a real SIGKILL runs no handlers either. The crash
    drills (bench_provision.py --resilience, the chaos kill-resume test)
    catch it at top level and then resume from the journal."""


@dataclasses.dataclass
class FaultRule:
    match: str  # regex searched against the joined command line
    times: int = 1  # how many matching invocations to fail...
    after: int = 0  # ...after letting this many matches through first
    rc: int = 1
    output: str = "fault injected"
    hang: bool = False  # consume the call's timeout budget, then rc 124
    hang_seconds: float = 3600.0  # hang length when the call has no timeout
    kill: bool = False  # simulate SIGKILL of the whole supervisor here
    seen: int = dataclasses.field(default=0, init=False)  # matches so far

    _KNOWN = ("match", "times", "after", "rc", "output", "hang",
              "hang_seconds", "kill")

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultRule":
        unknown = set(raw) - set(cls._KNOWN)
        if unknown:
            raise FaultPlanError(
                f"fault rule has unknown key(s) {sorted(unknown)}; "
                f"known: {list(cls._KNOWN)}"
            )
        if "match" not in raw:
            raise FaultPlanError(f"fault rule needs a 'match' regex: {raw}")
        try:
            re.compile(raw["match"])
        except re.error as e:
            raise FaultPlanError(
                f"bad 'match' regex {raw['match']!r}: {e}"
            ) from e
        return cls(**raw)


class FaultPlan:
    """An ordered list of FaultRules plus the injection ledger."""

    def __init__(
        self,
        rules: list[FaultRule],
        sleep: Callable[[float], None] = time.sleep,
        echo: Callable[[str], None] = lambda line: print(
            line, file=sys.stderr, flush=True
        ),
    ) -> None:
        self.rules = rules
        self.sleep = sleep
        self.echo = echo
        self.injected: list[dict] = []  # what fired, for drills/asserts
        # The DAG scheduler (provision/scheduler.py) drives wrapped
        # runners from several worker threads at once; the Nth-match
        # bookkeeping must stay atomic or "fail the 2nd terraform apply"
        # becomes a race. One lock guards rule.seen and the ledger.
        self._lock = threading.Lock()

    @classmethod
    def from_json(cls, text: str, **kwargs) -> "FaultPlan":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"fault plan is not valid JSON: {e}") from e
        if isinstance(data, dict):
            data = data.get("faults", None)
        if not isinstance(data, list):
            raise FaultPlanError(
                'fault plan must be a list of rules or {"faults": [...]}'
            )
        return cls([FaultRule.from_dict(r) for r in data], **kwargs)

    def _claim(self, line: str) -> tuple[FaultRule, int] | None:
        """Atomically find the owning rule, advance its counter, and
        decide whether this invocation fires. The slow parts (hang
        sleeps, raising) happen OUTSIDE the lock so concurrent
        unmatched commands never serialize behind an injected hang."""
        with self._lock:
            for rule in self.rules:
                if not re.search(rule.match, line):
                    continue
                nth = rule.seen
                rule.seen += 1
                if not (rule.after <= nth < rule.after + rule.times):
                    return None  # owns the call but lets it through
                self.injected.append(
                    {"match": rule.match, "command": line, "nth": nth,
                     "rc": 124 if rule.hang else rule.rc,
                     "hang": rule.hang, "kill": rule.kill}
                )
                return rule, nth
            return None

    def fire(self, args, timeout: float | None = None) -> None:
        """Consult the plan for one invocation and raise if a rule owns
        it. `args` is a command argv OR a bare string — the latter is
        what task-level injection points use (the DAG drills match task
        NAMES, not child command lines: a `kill` rule on
        "host-configuration" dies when that task starts, no subprocess
        required). Returning without raising means "not this one"."""
        if isinstance(args, str):
            line, argv = args, [args]
        else:
            argv = list(args)
            line = " ".join(str(a) for a in argv)
        fired = self._claim(line)
        if fired is None:
            return
        rule, nth = fired
        if rule.kill:
            self.echo(
                f"FAULT-INJECT: SIGKILL(simulated) at {line!r} "
                f"(match {rule.match!r}, occurrence {nth})"
            )
            raise SupervisorKilled(f"supervisor killed at {line!r}")
        if rule.hang:
            budget = timeout or rule.hang_seconds
            self.echo(f"FAULT-INJECT: hanging {line!r} for {budget:.0f}s")
            self.sleep(budget)
            raise CommandError(
                argv, 124,
                tail=f"fault-injected hang killed after {budget:.0f}s",
            )
        self.echo(
            f"FAULT-INJECT: rc={rule.rc} for {line!r} "
            f"(match {rule.match!r}, occurrence {nth})"
        )
        raise CommandError(argv, rule.rc, tail=rule.output)

    def wrap(self, run: RunFn) -> RunFn:
        """The RunFn decorator. Sits UNDER the retry wrapper in the
        cli's composition so injected failures exercise exactly the
        classify/backoff path real ones take. A `kill` rule's
        SupervisorKilled is a BaseException, so it sails PAST the retry
        engine and the scheduler's journal `failed` hook — the process
        'dies' with only the fsync'd `running` record on disk."""

        def faulty(args, **kwargs) -> str:
            self.fire(args, timeout=kwargs.get("timeout"))
            return run(args, **kwargs)

        return faulty


def load_fault_plan(
    spec: str | None = None,
    environ: dict | None = None,
    **kwargs,
) -> FaultPlan | None:
    """Resolve a plan from the CLI flag (wins) or TK8S_FAULT_PLAN.

    A value starting with '{' or '[' is inline JSON; anything else is a
    file path. Returns None when no plan is configured — the pipeline
    then runs the unwrapped runners with zero overhead.
    """
    env = os.environ if environ is None else environ
    spec = spec or env.get(ENV_VAR)
    if not spec:
        return None
    text = spec if spec.lstrip().startswith(("{", "[")) else None
    if text is None:
        try:
            text = Path(spec).read_text()
        except OSError as e:
            raise FaultPlanError(f"cannot read fault plan {spec!r}: {e}") from e
    return FaultPlan.from_json(text, **kwargs)
