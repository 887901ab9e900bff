"""The port's maintenance watchdog (`provision/maintenance.py`) against the
reference's: scripted metadata sequences (NONE, events, fetch errors past
the backoff cap, NONE again) give the same drain-file lifecycle, log
lines, sleeps and `on_event` calls; `drain_requested` resolves the
environment, then the host env file, then the default path, as the
reference does; `main --once` exits as the reference's. The metadata
fetch is always scripted: no test reaches the network. The training side
(`utils/perf.timed_windows`) reads the drain file through this module's
own `drain_requested`."""

import pytest
import torch

from tritonk8ssupervisor_tpu.parallel import distributed as ref_distributed
from tritonk8ssupervisor_tpu.provision import maintenance as ref_mt
from tritonk8ssupervisor_tpu_torch.parallel import distributed
from tritonk8ssupervisor_tpu_torch.provision import maintenance as mt
from tritonk8ssupervisor_tpu_torch.utils import perf

EVENT = "TERMINATE_ON_HOST_MAINTENANCE"


class Stop(Exception):
    pass


def _drive(module, drain, script: list, **kwargs) -> dict:
    """watch() over `script` (values, or exceptions the fetch raises), one
    poll per entry, stopped by its sleep after the last: the sleeps, the
    log, the sink's calls and the drain file's content after each poll."""
    outcomes = iter(script)
    sleeps, log, seen, files = [], [], [], []

    def fetch(url, timeout):
        assert url == module.METADATA_URL and timeout == 2.0
        value = next(outcomes)
        if isinstance(value, Exception):
            raise value
        return value

    def sleep(seconds):
        sleeps.append(seconds)
        files.append(drain.read_text() if drain.exists() else None)
        if len(sleeps) == len(script):
            raise Stop

    def sink(event):
        seen.append((event, drain.exists()))
        if event == "BAD-SINK":
            raise RuntimeError("sink exploded")

    with pytest.raises(Stop):
        module.watch(drain, fetch=fetch, sleep=sleep, log=log.append, on_event=sink, **kwargs)
    return {"sleeps": sleeps, "log": log, "seen": seen, "files": files}


SCRIPTS = {
    "event then clear": ["NONE", "", EVENT, EVENT, "MIGRATE_ON_HOST_MAINTENANCE", "NONE",
                         "NONE"],
    "errors keep a pending drain": [EVENT, OSError("conn refused"), OSError("conn refused"),
                                    OSError("conn refused"), EVENT, "NONE"],
    "errors past the cap": [OSError(f"refused #{i}") for i in range(14)] + ["NONE"],
    "a failing sink": ["BAD-SINK", "NONE", EVENT, "BAD-SINK", "NONE"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("interval,max_backoff", [(10.0, 35.0), (0.05, 300.0)])
def test_watch_lifecycle_equals_the_reference(tmp_path, name, interval, max_backoff):
    ours = _drive(mt, tmp_path / "port" / "drain", SCRIPTS[name], interval=interval,
                  max_backoff=max_backoff)
    ref = _drive(ref_mt, tmp_path / "reference" / "drain", SCRIPTS[name], interval=interval,
                 max_backoff=max_backoff)
    assert ours == ref
    if name == "event then clear":
        assert ours["files"][2] == f"maintenance-event: {EVENT}\n"
        assert ours["files"][-1] is None and any("removing drain file" in line
                                                 for line in ours["log"])
    if name == "errors past the cap":
        assert max(ours["sleeps"]) == max_backoff and "capped" in ours["log"][-2]
    if name == "errors keep a pending drain":
        assert ours["files"][1:4] == [f"maintenance-event: {EVENT}\n"] * 3


def test_watch_once_and_poll_event_equal_the_reference(tmp_path):
    def boom(url, timeout):
        raise OSError("no metadata server")

    for fetch in (lambda u, t: "NONE", lambda u, t: EVENT, lambda u, t: "", boom):
        assert mt.poll_event(fetch=fetch) == ref_mt.poll_event(fetch=fetch)
        for side, module in (("port", mt), ("reference", ref_mt)):
            drain = tmp_path / side / "d"
            drain.unlink(missing_ok=True)
            log: list = []
            fired = module.watch(drain, once=True, fetch=fetch, log=log.append)
            assert (fired, drain.exists(), log) == (
                fetch(None, None) == EVENT if fetch is not boom else False,
                fetch is not boom and fetch(None, None) == EVENT, log)
        assert (tmp_path / "port" / "d").exists() == (tmp_path / "reference" / "d").exists()
    with pytest.raises(OSError):
        mt.poll_event(fetch=boom, errors="raise")
    assert (mt.METADATA_URL, mt.DEFAULT_DRAIN_FILE, mt.DRAIN_FILE_VAR) == (
        ref_mt.METADATA_URL, ref_mt.DEFAULT_DRAIN_FILE, ref_mt.DRAIN_FILE_VAR)


def test_request_drain_is_atomic(tmp_path):
    drain = tmp_path / "sub" / "drain"
    mt.request_drain(drain, "maintenance-event: TERMINATE")
    assert drain.read_text() == "maintenance-event: TERMINATE\n"
    mt.request_drain(drain, "maintenance-event: MIGRATE")
    assert drain.read_text() == "maintenance-event: MIGRATE\n"
    assert [p.name for p in drain.parent.iterdir()] == ["drain"]


def test_drain_requested_resolves_as_the_reference(tmp_path, monkeypatch):
    """The environment first, then the host env file, then the default
    path, in both packages; an empty drain file still reads as a drain."""
    drain = tmp_path / "drain"
    env_file = tmp_path / "tpu-cluster.env"
    env_file.write_text(f"# written by the tpuhost role\nOTHER=1\nTK8S_DRAIN_FILE = {drain}\n")
    cases = []
    for env in ({mt.DRAIN_FILE_VAR: str(drain)}, {mt.DRAIN_FILE_VAR: ""}, {}):
        for file in (env_file, tmp_path / "missing.env"):
            for content in (None, "maintenance-event: X\n", ""):
                cases.append((env, file, content))
    for env, file, content in cases:
        drain.unlink(missing_ok=True)
        if content is not None:
            drain.write_text(content)
        monkeypatch.setattr(distributed, "ENV_FILE", file)
        monkeypatch.setattr(ref_distributed, "ENV_FILE", file)
        assert mt.drain_requested(environ=env) == ref_mt.drain_requested(environ=env)
    monkeypatch.setattr(distributed, "ENV_FILE", env_file)
    drain.write_text("maintenance-event: X\n")
    assert mt.drain_requested(environ={}) == "maintenance-event: X"
    drain.write_text("")
    assert mt.drain_requested(environ={}) == "drain requested"
    monkeypatch.setenv(mt.DRAIN_FILE_VAR, str(drain))
    assert mt.drain_requested() == "drain requested"


def test_main_once_exit_codes_as_the_reference(tmp_path, monkeypatch):
    def boom(url, timeout):
        raise OSError("unreachable")

    for fetch, expected in ((lambda u, t: "NONE", 0), (lambda u, t: EVENT, 3), (boom, 0)):
        codes = []
        for side, module in (("port", mt), ("reference", ref_mt)):
            drain = tmp_path / side / "drain"
            drain.unlink(missing_ok=True)
            monkeypatch.setattr(module, "_default_fetch", fetch)
            codes.append((module.main(["--once", "--drain-file", str(drain)]), drain.exists()))
        assert codes[0] == codes[1] == (expected, expected == 3)


def test_perf_reads_the_one_drain_requested(tmp_path, monkeypatch):
    """`utils/perf.timed_windows` stops at the window whose checkpoint hook
    saw the drain land, through `provision/maintenance.drain_requested`."""
    assert perf.drain_requested is mt.drain_requested
    drain = tmp_path / "drain"
    monkeypatch.setenv(mt.DRAIN_FILE_VAR, str(drain))
    steps, saves = [0], []

    def run_once():
        steps[0] += 1
        return {"loss": torch.tensor(1.0)}

    def on_window():
        saves.append(steps[0])
        if len(saves) == 2:
            mt.request_drain(drain, f"maintenance-event: {EVENT}")

    timing = perf.timed_windows(run_once, steps=2, warmup=1, windows=5, on_window=on_window)
    assert timing["windows"] == 2 and saves == [3, 5]
    assert timing["drained"] == f"maintenance-event: {EVENT}"
    drain.unlink()
    timing = perf.timed_windows(run_once, steps=2, warmup=1, windows=3)
    assert timing["windows"] == 3 and timing["drained"] is None
