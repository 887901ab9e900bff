"""The port's provisioning leaves against the reference's: the task DAG
(`provision/scheduler.py`), its journal (`provision/journal.py`), the
fault plans (`testing/faults.py`), the retry engine (`provision/retry.py`),
the phase timer (`utils/phases.py`) and the subprocess runners
(`provision/runner.py`). Each package runs the same seeded graphs and
scripts with the same injected clocks; journal and runlog records are
compared parsed, with each side's temporary root replaced by one name.
No tolerance."""

import json
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest

from tritonk8ssupervisor_tpu.provision import journal as ref_journal
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu.provision import runner as ref_runner
from tritonk8ssupervisor_tpu.provision import scheduler as ref_scheduler
from tritonk8ssupervisor_tpu.testing import faults as ref_faults
from tritonk8ssupervisor_tpu.utils import phases as ref_phases
from tritonk8ssupervisor_tpu_torch.provision import journal, retry, runner, scheduler
from tritonk8ssupervisor_tpu_torch.testing import faults
from tritonk8ssupervisor_tpu_torch.utils import phases

SIDES = {
    "port": {"scheduler": scheduler, "journal": journal, "faults": faults, "retry": retry,
             "runner": runner, "phases": phases},
    "reference": {"scheduler": ref_scheduler, "journal": ref_journal, "faults": ref_faults,
                  "retry": ref_retry, "runner": ref_runner, "phases": ref_phases},
}


class Ticks:
    """A clock that advances by `step` at every read."""

    def __init__(self, start: float = 1000.0, step: float = 0.25):
        self.t, self.step = start, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _random_graph(seed: int, n: int = 14, chain: bool = False) -> tuple[list, dict]:
    """(name, after) pairs in a shuffled order, each edge to a task of a
    lower index, and a duration per task. With `chain`, every task also
    waits on the one before it, so one task at a time is ready and a run
    on one worker is the same sequence of records however its threads
    interleave."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n):
        deps = {f"t{int(j)}" for j in rng.integers(0, i, int(rng.integers(0, 3)))} if i else set()
        if chain and i:
            deps.add(f"t{i - 1}")
        spec.append((f"t{i}", tuple(sorted(deps))))
    order = rng.permutation(n)
    durations = {f"t{i}": float(rng.integers(1, 60)) for i in range(n)}
    return [spec[i] for i in order], durations


def _tasks(mod, spec, fn=lambda results: None):
    return [mod.Task(name, fn, after=after) for name, after in spec]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("seed", range(6))
def test_seeded_graphs_validate_and_critical_path_as_the_reference(seed):
    spec, durations = _random_graph(seed)
    out = {}
    for side, mods in SIDES.items():
        sched = mods["scheduler"]
        tasks = _tasks(sched, spec)
        # a cycle: the first- and the last-listed task wait on each other
        first, last = spec[0][0], spec[-1][0]
        loop = [(n, a + ((last,) if n == first else (first,) if n == last else ()))
                for n, a in spec]
        out[side] = (
            [t.name for t in sched.validate(tasks)],
            sched.critical_path(tasks, durations),
            _error(lambda: sched.validate(_tasks(sched, loop))),
            _error(lambda: sched.validate(_tasks(sched, spec + [spec[0]]))),
            _error(lambda: sched.validate(_tasks(sched, spec + [("x", ("missing",))]))),
        )
    assert out["port"] == out["reference"]
    assert out["port"][2][0] == "SchedulerError" and "cycle" in out["port"][2][1]


def _norm(value, root: Path):
    return json.loads(json.dumps(value).replace(str(root), "ROOT"))


def _records(path: Path, root: Path) -> list:
    return [_norm(json.loads(line), root) for line in path.read_text().splitlines()
            if line.strip()]


def _dag_tasks(mods, spec, root: Path, ran: list, plan):
    """Tasks that write `<root>/artifacts/<name>.out`, fire the fault plan
    by name first, and restore their result from the artifact."""
    sched = mods["scheduler"]
    (root / "artifacts").mkdir(parents=True, exist_ok=True)

    def make(name, after):
        out = root / "artifacts" / f"{name}.out"

        def fn(results):
            plan.fire(name)
            ran.append(name)
            out.write_text(f"{name}:{sorted(results)}\n")
            return f"{name} result"

        return sched.Task(name, fn, after=after,
                          inputs_hash=mods["journal"].inputs_hash("task", name),
                          artifacts=(out,), restore=lambda results: f"{name} (restored)")

    return [make(name, after) for name, after in spec]


def _killed_and_resumed(mods, spec, root: Path, victim: str) -> dict:
    """run_dag under a Journal and a PhaseTimer, killed by the side's own
    FaultPlan at `victim`; then the same graph resumed, an artifact
    drifted and resumed again, and the journal compacted."""
    faults_mod, sched = mods["faults"], mods["scheduler"]
    echo: list = []
    plan = faults_mod.FaultPlan([faults_mod.FaultRule(match=f"^{victim}$", kill=True)],
                                echo=echo.append)
    ran: list = []
    tasks = _dag_tasks(mods, spec, root, ran, plan)
    path = root / "provision-journal.jsonl"
    runlog = root / "runlog.jsonl"
    clock = Ticks()
    timer_clock = Ticks(start=0.0, step=0.5)
    out = {}
    for attempt in ("killed", "resumed", "drifted"):
        ran.clear()
        timer = mods["phases"].PhaseTimer(out=open(os.devnull, "w"), logfile=runlog,
                                          clock=timer_clock, wall=Ticks(start=5000.0))
        with mods["journal"].Journal(path, clock=clock, echo=echo.append) as j:
            try:
                results = sched.run_dag(tasks, max_workers=1, timer=timer, journal=j,
                                        echo=echo.append)
            except faults_mod.SupervisorKilled as e:
                results = f"killed: {e}"
        out[attempt] = {"ran": list(ran), "results": results,
                        "journal": _records(path, root),
                        "replay": {k: _norm(vars(v), root) for k, v in
                                   mods["journal"].Journal(path, echo=echo.append)
                                   .replay().items()}}
        if attempt == "resumed":
            (root / "artifacts" / f"{spec[len(spec) // 2][0]}.out").write_text("drifted\n")
    j = mods["journal"].Journal(path, clock=clock, echo=echo.append)
    out["compacted"] = {"dropped": j.compact(), "journal": _records(path, root)}
    rows = mods["phases"].analyze_runlog(runlog)
    out["runlog"] = _records(runlog, root)
    out["analysis"] = rows
    out["report"] = mods["phases"].format_runlog_report(rows)
    out["wall"] = mods["phases"].wall_seconds(rows)
    out["echo"] = [line.replace(str(root), "ROOT") for line in echo]
    out["injected"] = _norm(plan.injected, root)
    return out


@pytest.mark.parametrize("seed,victim_index", [(0, 3), (1, 7), (2, 11)])
def test_killed_dag_resumes_and_compacts_as_the_reference(tmp_path, seed, victim_index):
    spec, _ = _random_graph(seed, n=12, chain=True)
    victim = sorted(name for name, _ in spec)[victim_index]
    out = {side: _killed_and_resumed(mods, spec, tmp_path / side, victim)
           for side, mods in SIDES.items()}
    assert out["port"] == out["reference"]
    port = out["port"]
    # the kill leaves the victim's `running` record, and nothing after it
    assert port["killed"]["replay"][victim]["status"] == "running"
    assert [r["status"] for r in port["killed"]["journal"] if r["task"] == victim] == ["running"]
    assert port["killed"]["results"].startswith("killed")
    # the resume redoes the victim and skips the verified prefix
    assert victim in port["resumed"]["ran"]
    assert len(port["resumed"]["ran"]) < len(spec)
    assert all(r.endswith("(restored)") or r.endswith("result")
               for r in port["resumed"]["results"].values())
    assert port["compacted"]["dropped"] > 0
    assert len(port["compacted"]["journal"]) == len(spec)


def _err(mods, tail="", rc=1, args=("tool", "sub")):
    return mods["runner"].CommandError(list(args), rc, tail=tail)


# tests/test_retry.py's classifier table, and its mixed and command-line cases
CLASSIFIER_CORPUS = [
    ("Error: googleapi: Error 429: Too Many Requests", 1),
    ("googleapi: got HTTP response code 503 with body", 1),
    ("Error: Plugin did not respond... connection reset by peer", 1),
    ("read tcp 10.0.0.2:443: i/o timeout", 1),
    ("fatal: [10.0.0.1]: UNREACHABLE! => ssh: connect to host", 4),
    ("Unable to connect to the server: net/http: TLS handshake timeout", 1),
    ("Unable to connect to the server: EOF", 1),
    ("Error 403: Quota exceeded for quota metric 'TPUV5sLitePodPerProjectPerZone'", 1),
    ("ERROR: (gcloud) PERMISSION_DENIED: Permission denied on resource", 1),
    ("error: You must be logged in to the server (the server has asked for the client to "
     "provide credentials); 401 Unauthorized", 1),
    ("Error: Unsupported argument\n  on main.tf line 7", 1),
    ("ERROR! Syntax Error while loading YAML", 4),
    ("", 124), ("", 255), ("", 127), ("something entirely novel", 2),
    ("Error 403: Quota exceeded (http 503 from backend)", 1),
    ("Error 429: Quota exceeded for quota metric 'Read requests' and limit 'Read requests "
     "per minute'", 1),
    ("ERROR: (gcloud.compute.tpus) RESOURCE_EXHAUSTED: Quota exceeded", 1),
    ("googleapi: Error 429: Too Many Requests, rateLimitExceeded", 1),
    ("dial tcp: lookup metadata: Temporary failure in name resolution", 1),
    ("etcdserver: request timed out", 1), ("Internal Server Error", 1),
]


def test_classifier_corpus_as_the_reference():
    for tail, rc in CLASSIFIER_CORPUS:
        ours = retry.classify(_err(SIDES["port"], tail, rc))
        ref = ref_retry.classify(_err(SIDES["reference"], tail, rc))
        assert dataclass_tuple(ours) == dataclass_tuple(ref), tail
    e = SIDES["port"]["runner"].CommandError(["ssh", "-o", "ConnectTimeout=5", "h"], 2)
    assert retry.classify(e).cause == "rc-2"


def dataclass_tuple(c):
    return (c.verdict, c.cause, c.min_delay)


def _retry_drive(mods, policy_kwargs: dict, plan_json: str, commands: list) -> dict:
    """retrying_runner over the side's FaultPlan over a succeeding RunFn:
    every command's result or error, the sleeps, records, log lines and
    the plan's ledger."""
    sleeps, records, echo, calls = [], [], [], []
    clock = {"t": 0.0}

    def sleep(seconds):
        sleeps.append(seconds)
        clock["t"] += seconds

    def ok(args, **kwargs):
        calls.append((list(args), sorted(kwargs.items())))
        return "converged"

    plan = mods["faults"].FaultPlan.from_json(plan_json, sleep=sleep, echo=echo.append)
    rng = iter(np.random.default_rng(4).random(64).tolist())
    run = mods["retry"].retrying_runner(
        plan.wrap(ok), mods["retry"].RetryPolicy(**policy_kwargs), record=records.append,
        sleep=sleep, clock=lambda: clock["t"], rng=lambda: next(rng), echo=echo.append)
    results = []
    for command in commands:
        try:
            results.append(run(command))
        except mods["runner"].CommandError as e:
            results.append(("CommandError", e.args_run, e.returncode, e.tail, str(e)))
    return {"results": results, "sleeps": sleeps, "records": records, "echo": echo,
            "calls": calls, "injected": plan.injected}


RETRY_PLAN = json.dumps({"faults": [
    {"match": "terraform apply", "times": 2, "output": "Error 429: Too Many Requests"},
    {"match": "kubectl get nodes", "after": 1, "times": 1,
     "output": "Unable to connect to the server: net/http: TLS handshake timeout"},
    {"match": "ansible-playbook", "times": 1, "hang": True},
    {"match": "gcloud", "times": 1, "rc": 1,
     "output": "Error 403: Quota exceeded for quota metric 'TPUV5sLitePodPerProjectPerZone'"},
    {"match": "ssh", "times": 9, "rc": 255, "output": ""},
]})
RETRY_COMMANDS = [["terraform", "apply"], ["kubectl", "get", "nodes"],
                  ["kubectl", "get", "nodes"], ["ansible-playbook", "site.yml"],
                  ["gcloud", "compute", "tpus", "list"], ["ssh", "h", "true"],
                  ["terraform", "apply"]]


@pytest.mark.parametrize("policy", [
    {"max_attempts": 4, "base_delay": 2.0, "max_delay": 60.0},
    {"max_attempts": 3, "base_delay": 0.0, "max_delay": 0.0},
    {"max_attempts": 6, "base_delay": 5.0, "max_delay": 40.0, "deadline": 90.0,
     "attempt_timeout": 7.0},
])
def test_retrying_runner_over_a_fault_plan_as_the_reference(policy):
    ours = _retry_drive(SIDES["port"], policy, RETRY_PLAN, RETRY_COMMANDS)
    ref = _retry_drive(SIDES["reference"], policy, RETRY_PLAN, RETRY_COMMANDS)
    assert ours == ref
    assert "rate-limited" in ours["records"]
    assert any(r[0] == "CommandError" and "Quota exceeded" in r[3]
               for r in ours["results"] if isinstance(r, tuple))


def test_retry_policy_from_env_and_cooldown_as_the_reference():
    env = {"TK8S_RETRY_MAX_ATTEMPTS": "0", "TK8S_RETRY_BASE_DELAY": "1.5",
           "TK8S_RETRY_MAX_DELAY": "9", "TK8S_RETRY_DEADLINE": "-1",
           "TK8S_ATTEMPT_TIMEOUT": "30"}
    for environ in ({}, env):
        assert (retry.RetryPolicy.from_env(environ).__dict__
                == ref_retry.RetryPolicy.from_env(environ).__dict__)
    assert retry.RetryPolicy().__dict__ == ref_retry.RetryPolicy().__dict__
    ours = retry.Cooldown(2.0, 30.0, rng=np.random.default_rng(1).random)
    ref = ref_retry.Cooldown(2.0, 30.0, rng=np.random.default_rng(1).random)
    seq = [(ours.next(), ref.next()) for _ in range(6)]
    ours.reset(), ref.reset()
    seq += [(ours.next(), ref.next())]
    assert all(a == b for a, b in seq)


def test_fault_plan_loading_and_errors_as_the_reference(tmp_path):
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(RETRY_PLAN)
    specs = [RETRY_PLAN, str(plan_file), "[]", "{\"faults\": 3}", "not json {",
             "[{\"times\": 1}]", "[{\"match\": \"(\"}]", "[{\"match\": \"x\", \"bogus\": 1}]",
             str(tmp_path / "absent.json")]
    for spec in specs:
        out = {}
        for side, mods in SIDES.items():
            try:
                plan = mods["faults"].load_fault_plan(spec, environ={}, echo=lambda line: None)
                out[side] = [vars(r) for r in plan.rules]
            except mods["faults"].FaultPlanError as e:
                out[side] = ("FaultPlanError", str(e))
        assert out["port"] == out["reference"], spec
    assert faults.load_fault_plan(None, environ={}) is None
    env_plan = faults.load_fault_plan(None, environ={faults.ENV_VAR: RETRY_PLAN})
    assert [r.match for r in env_plan.rules][0] == "terraform apply"
    assert issubclass(faults.SupervisorKilled, BaseException)
    assert not issubclass(faults.SupervisorKilled, Exception)


def _phase_drive(mods, root: Path) -> dict:
    out_lines = []

    class Out:
        def write(self, text):
            out_lines.append(text)

        def flush(self):
            pass

    log = root / "runlog.jsonl"
    root.mkdir(parents=True, exist_ok=True)
    timer = mods["phases"].PhaseTimer(out=Out(), logfile=log, clock=Ticks(0.0, 7.0),
                                      wall=Ticks(2000.0, 1.0))
    with timer.phase("terraform-apply"):
        timer.note_retry("rate-limited")
        timer.note_retry("connection")
    with timer.phase("configure-slice-0", after=("terraform-apply",)):
        pass
    timer.note_skip("compile-manifests", after=("terraform-apply",))
    with pytest.raises(RuntimeError):
        with timer.phase("readiness-slice-1", after=("configure-slice-0",)):
            raise RuntimeError("boom")
    with timer.phase("probe-job"):
        pass
    timer.report()
    rows = mods["phases"].analyze_runlog(log)
    return {"out": "".join(out_lines), "runlog": _records(log, root),
            "durations": timer.durations, "total": timer.total, "wall": timer.wall,
            "rows": rows, "report": mods["phases"].format_runlog_report(rows),
            "wall_seconds": mods["phases"].wall_seconds(rows),
            "budgets": [mods["phases"].phase_budget(n) for n in
                        ("terraform-apply", "configure-slice-3", "readiness-slice-0",
                         "compile-manifests", "probe-job", "unknown")],
            "main": mods["phases"].main([str(log)])}


def test_phase_timer_and_runlog_analysis_as_the_reference(tmp_path, capsys):
    ours = _phase_drive(SIDES["port"], tmp_path / "port")
    ref = _phase_drive(SIDES["reference"], tmp_path / "reference")
    capsys.readouterr()
    assert ours == ref
    assert ours["runlog"][1]["attempts"] == 3
    assert any(r["status"] == "failed" for r in ours["rows"]) and ours["main"] == 1


def _command_error(mods, fn):
    try:
        fn()
    except mods["runner"].CommandError as e:
        return e.args_run, e.returncode, e.tail, str(e)
    return None


def test_runner_errors_as_the_reference(tmp_path):
    script = "echo out-1; echo err-1 >&2; echo out-2; exit 3"
    for side_args in (["sh", "-c", script], [str(tmp_path / "no-such-binary")]):
        out = {}
        for side, mods in SIDES.items():
            echoed: list = []
            out[side] = (
                _command_error(mods, lambda: mods["runner"].run_streaming(
                    side_args, echo=echoed.append, timeout=30)),
                _command_error(mods, lambda: mods["runner"].run_capture(side_args,
                                                                        timeout=30)),
                echoed)
        assert out["port"] == out["reference"]
    streamed = _command_error(SIDES["port"], lambda: runner.run_streaming(
        ["sh", "-c", script], echo=lambda line: None))
    assert streamed[1] == 3 and streamed[2] == "out-1\nerr-1\nout-2"
    assert runner.run_streaming(["sh", "-c", "echo a; echo b"], cwd=tmp_path,
                                echo=lambda line: None) == "a\nb"
    assert runner.run_capture(["sh", "-c", "echo a >&2; echo b"]) == "b\n"


def _alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state != "Z"


def test_run_streaming_timeout_kills_the_process_group(tmp_path):
    """A hung child and the grandchild it started both die at the timeout
    (one process group), and the error is rc 124 with the output so far."""
    pidfile = tmp_path / "grandchild.pid"
    script = f"sleep 60 & echo $! > {pidfile}; echo started; wait"
    start = time.monotonic()
    err = _command_error(SIDES["port"], lambda: runner.run_streaming(
        ["sh", "-c", script], echo=lambda line: None, timeout=1.0))
    assert time.monotonic() - start < 30
    assert err[1] == 124 and err[2] == "started\nkilled after 1s timeout"
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 10
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = _alive(pid)
    if alive:
        os.kill(pid, signal.SIGKILL)
    assert not alive
    capture = _command_error(SIDES["port"], lambda: runner.run_capture(
        ["sh", "-c", "echo partial; sleep 60"], timeout=0.5))
    assert capture[1] == 124 and capture[2].endswith("killed after 0.5s timeout")
