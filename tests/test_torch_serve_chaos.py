"""The port's serve campaign (`testing/chaos.py`: `generate_serve_scenario`
and `run_serve_campaign`) against the JAX package's: equal scenarios per
seed, and seeded campaigns that give the same ledgers, request journals,
span logs, published documents and result dicts through both packages,
with zero violations (tests/test_serve_chaos.py's own asserts).

A campaign runs a supervisor thread and the gateway's loop in the calling
thread on one `SimClock`. Both wake at the same virtual instants, and
which of them reads a file the other writes at that instant is decided by
the OS scheduler: the reference alone gives different ledgers from run to
run. So the campaigns here run on `TurnClock`, a `SimClock` that lets one
actor run at a time, which makes every run one fixed interleaving of the
reference's own; both packages' module-level `SimClock` is replaced by it
for the test, and nothing else changes. The only actors that still run
side by side are a parallel heal wave's workers (as in
tests/test_torch_supervisor.py): each virtual instant's records are
compared as a sorted multiset with heal ids named by slice
(`unordered_waves`). The global `random` is seeded alike before each
side's run, since the autoscale drive's cooldown draws from it. No field
is dropped and no tolerance is used. The 40-seed sweep stays behind the
`chaos` marker, as the reference's does.
"""

import dataclasses
import gc
import inspect
import json
import random
import sys
import threading

import pytest

from test_torch_supervisor import normalized, unordered_waves
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu_torch.testing import chaos
from tritonk8ssupervisor_tpu_torch.testing.simclock import SimClock, SimClockStalled

SIDES = {"reference": ref_chaos, "port": chaos}

# the supervisor method (in both packages) whose release of its actor
# slot opens a heal wave, as `TurnClock.release` reads it from the
# caller's frame; `test_turn_clock_knows_where_a_heal_wave_opens` fails on
# a rename, and `drive_both` fails if a campaign's heal waves (its
# heal-wave spans) went by unseen
HEAL_WAVE_CALLER = "_dispatch_heals"

# what a campaign leaves in its workdir and the tests compare, parsed
# (the warm cache and the terraform/ansible trees differ by design: each
# package stages its own archive)
JSONL_FILES = ("supervisor-events.jsonl", "serve-requests.jsonl", "telemetry-spans.jsonl")
JSON_FILES = ("fleet-status.json", "demand-signal.json", "metrics.json", "job-ack.json")


class TurnClock(SimClock):
    """A `SimClock` on which one actor runs at a time.

    An actor that begins, or whose sleep ends, waits for its turn; a turn
    is granted only when every other actor is waiting (the point at which
    `SimClock` would advance time), to the waiting actor with the earliest
    wake-up. Of actors waking at one instant, the thread that made the
    clock (the drive's loop) goes last and the others go in the order they
    started waiting. Time advances to that wake-up. No turn is granted
    before the thread that made the clock has begun, so the drive's first
    step reads what the supervisor's first tick wrote, whichever thread
    reaches the clock first.

    A supervisor heal wave releases the supervisor's slot and then
    launches the wave (`Supervisor._dispatch_heals`), and begins again
    after the wave's last task settles: no turn is granted in either gap,
    which `SimClock` leaves to the OS scheduler. The wave's workers run
    one at a time in the order they reach the clock, which is not fixed.
    `waves` counts the waves seen, over every instance.
    """

    waves = 0

    def __init__(self, start: float = 0.0, stall_timeout: float = 30.0):
        super().__init__(start, stall_timeout)
        self._owner = threading.get_ident()
        self._owner_begun = False
        self._seq = 0
        self._waiting: list = []
        self._turn = None
        self._wave = None  # a heal wave's tasks not yet settled, else None

    def launch(self, *_args, **_kwargs) -> None:
        with self._cv:
            self._launched += 1
            if self._wave is not None:
                self._wave += 1

    def begin(self, *_args, **_kwargs) -> None:
        with self._cv:
            if self._launched > 0:
                self._launched -= 1
            self._active += 1
            if threading.get_ident() == self._owner:
                self._owner_begun = True
            if self._wave == 0:  # the supervisor, back from its wave
                self._wave = None
            self._take_turn(self._now)

    def release(self, *_args, **_kwargs) -> None:
        with self._cv:
            self._active -= 1
            if self._wave is None and sys._getframe(1).f_code.co_name == HEAL_WAVE_CALLER:
                self._wave = 0  # the wave's launches come next
                TurnClock.waves += 1
                return
            if self._wave is not None:
                self._wave -= 1  # one of the wave's tasks settled
                if self._wave == 0:
                    return  # the supervisor begins again next
            self._maybe_advance()
            self._cv.notify_all()

    def sleep(self, seconds: float) -> None:
        with self._cv:
            self._take_turn(self._now + max(0.0, float(seconds)))

    def _take_turn(self, wake: float) -> None:
        entry = (wake, threading.get_ident() == self._owner, self._seq)
        self._seq += 1
        self._waiting.append(entry)
        self._sleepers.append(wake)
        self._maybe_advance()
        while self._turn != entry:
            if not self._cv.wait(timeout=self._stall_timeout):
                self._waiting.remove(entry)
                self._sleepers.remove(wake)
                raise SimClockStalled(f"turn clock stalled at t={self._now:g} "
                                      f"({self._active} active, {self._launched} launched, "
                                      f"{len(self._waiting)} waiting)")
            self._maybe_advance()
        self._waiting.remove(entry)
        self._sleepers.remove(wake)
        self._turn = None
        self._cv.notify_all()

    def _maybe_advance(self) -> None:
        # caller holds self._cv
        if (self._turn is None and self._owner_begun and self._waiting
                and self._wave != 0 and self._launched == 0
                and len(self._waiting) >= self._active):
            entry = min(self._waiting)
            self._now = max(self._now, entry[0])
            self._turn = entry
            self._cv.notify_all()


def one_actor_at_a_time(monkeypatch) -> None:
    """Run both packages' campaigns on `TurnClock`."""
    for mod in SIDES.values():
        monkeypatch.setattr(mod, "SimClock", TurnClock)


def workdir_doc(root) -> dict:
    """The files a campaign leaves in `root`, parsed."""
    gc.collect()  # a dropped span log's buffered writer flushes as it is collected
    doc = {}
    for name in JSONL_FILES:
        path = root / name
        doc[name] = ([json.loads(line) for line in path.read_text().splitlines() if line.strip()]
                     if path.exists() else None)
    for name in JSON_FILES:
        path = root / name
        doc[name] = json.loads(path.read_text()) if path.exists() else None
    return doc


def drive_both(tmp_path, run, seed: int = 0) -> dict:
    """`run(module, root)` through each package on the turn clock, the
    global `random` seeded alike first: asserts the results and the
    workdirs are equal (each virtual instant's ledger records as a
    multiset) and returns the port's result and files."""
    out = {}
    for side, mod in SIDES.items():
        root = tmp_path / side
        random.seed(seed)
        TurnClock.waves = 0
        result = run(mod, root)
        files = workdir_doc(root)
        spans = files["telemetry-spans.jsonl"] or []
        waves = sum(r.get("span") == "heal-wave" for r in spans)
        assert TurnClock.waves >= waves, (side, TurnClock.waves, waves)
        doc = {"ledger": files.pop("supervisor-events.jsonl"), "files": files,
               "lines": [], "applies": [], "plays": [], "result": result}
        out[side] = unordered_waves(normalized(doc, root, side))
    for key in ("result", "ledger", "files"):
        assert out["port"][key] == out["reference"][key], key
    return out["port"]


# ------------------------------------------------------------- the turn clock


@pytest.mark.parametrize("side", SIDES)
def test_turn_clock_knows_where_a_heal_wave_opens(side):
    """`HEAL_WAVE_CALLER` is the supervisor method that releases its slot
    and then runs the wave (`run_dag`) in both packages."""
    source = inspect.getsource(getattr(SIDES[side].sup_mod.Supervisor, HEAL_WAVE_CALLER))
    release = source.index("self._hooks.release()")
    assert release < source.index("run_dag(", release)


def test_turn_clock_runs_one_actor_at_a_time_in_wake_order():
    """Two actors never overlap; at one instant the one that did not make
    the clock goes first; time advances as SimClock's."""
    clock = TurnClock()
    log, running = [], []

    def actor(name: str, naps: list) -> None:
        clock.begin()
        try:
            for nap in naps:
                running.append(name)
                assert len(running) == 1, running
                log.append((clock.time(), name))
                running.remove(name)
                clock.sleep(nap)
        finally:
            clock.release()

    clock.launch()
    other = threading.Thread(target=actor, args=("b", [10.0, 5.0, 5.0]))
    other.start()
    clock.launch()
    actor("a", [5.0, 5.0, 10.0])
    other.join(timeout=60)
    assert log == [(0.0, "b"), (0.0, "a"), (5.0, "a"), (10.0, "b"), (10.0, "a"),
                   (15.0, "b")]
    assert clock.time() == 20.0


# ------------------------------------------------------------ the generator


def test_generate_serve_scenario_equals_the_reference_per_seed():
    kinds = set()
    for seed in range(40):
        ours, ref = chaos.generate_serve_scenario(seed), ref_chaos.generate_serve_scenario(seed)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.fault_times == ref.fault_times
        kinds |= {e["kind"] for e in ours.events}
    assert chaos.generate_serve_scenario(42) == chaos.generate_serve_scenario(42)
    assert chaos.generate_serve_scenario(42) != chaos.generate_serve_scenario(43)
    assert {"slice-outage", "quota-storm", "flapping-ssh", "torn-status",
            "gateway-kill"} <= kinds
    assert chaos.SERVE_PRIMITIVES == ref_chaos.SERVE_PRIMITIVES


# ------------------------------------------------------------- the campaigns


def serve_campaign(tmp_path, seed: int) -> dict:
    return drive_both(tmp_path, lambda mod, root: mod.run_serve_campaign(
        mod.generate_serve_scenario(seed), root), seed=seed)


@pytest.mark.parametrize("seed", (1, 2, 3))  # outage, torn status + flapping SSH, gateway kill
def test_serve_campaign_equals_the_reference_with_zero_violations(tmp_path, monkeypatch, seed):
    one_actor_at_a_time(monkeypatch)
    doc = serve_campaign(tmp_path, seed)
    out = doc["result"]
    assert out["violations"] == [], (seed, out)
    assert out["converged"] is True
    assert out["accepted"] == out["completed"] + out["expired"]
    assert len(doc["files"]["serve-requests.jsonl"]) > 0
    assert out["spans"] == len(doc["files"]["telemetry-spans.jsonl"]) > 0


def test_serve_campaign_gateway_kill_resumes_from_the_journal_as_the_reference(
        tmp_path, monkeypatch):
    """Seed 3 composes a slice outage with a gateway SIGKILL: the restarted
    gateway resumes from the request journal, in both packages alike."""
    assert "gateway-kill" in [e["kind"] for e in chaos.generate_serve_scenario(3).events]
    one_actor_at_a_time(monkeypatch)
    out = serve_campaign(tmp_path, 3)["result"]
    assert out["gateway_kills"] == 1
    assert out["redone_after_kill"] >= 1
    assert out["violations"] == []
    assert out["converged"] is True


@pytest.mark.chaos
def test_serve_chaos_forty_seed_sweep(tmp_path):
    """The full sweep through the port: 40 seeded serve campaigns, zero
    violations, all converged."""
    failures = []
    for seed in range(1, 41):
        out = chaos.run_serve_campaign(chaos.generate_serve_scenario(seed), tmp_path / f"s{seed}")
        if out["violations"] or not out["converged"]:
            failures.append((seed, out["events"], out["violations"]))
    assert failures == []
