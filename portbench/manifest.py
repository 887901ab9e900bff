"""`BENCHMARK.json` and the files the harness finds by name in it.

- a configuration's sizes: the `file` of its entry (`portbench/configs/`);
  its `family` names `portbench/families/<family>.py`;
- a traffic mix's parameters: `portbench/traffic/<traffic>.json`;
- a cell's own data (the comparison's limits):
  `portbench/workloads/<cell>.json`;
- a metric's reader: `portbench/metrics/<metric>.py`, or where there is
  none `portbench/metrics/<base>.py` for a metric named `<base>.<suffix>`
  (`mfu.lm` and `mfu.resnet` share `mfu.py`); its `read(run)` returns the
  value or None where it finds nothing to read. A metric is read only in
  the cells its `workloads` list names (every cell without the list).

`check` refuses a name or unit the harness cannot use and a name whose
file is missing, so such an entry fails before any run.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

from portbench.training import NUMBERS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = Path(__file__).resolve().parent.name  # the folder under the repo root


def _name(value, what: str) -> None:
    if not (isinstance(value, str) and NAME.match(value)):
        raise ValueError(f"{what} {value!r}: a name is a letter, digit or _ and at most "
                         "64 letters, digits, _, . and -")


def reader_path(root: Path, metric: str) -> Path:
    """`metrics/<metric>.py`, or where there is none, the reader shared by
    the metrics named `<base>.<anything>`: `metrics/<base>.py`."""
    own = root / HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() else root / HERE / "metrics" / f"{metric.split('.')[0]}.py"


def check(bench: dict, root: Path) -> None:
    """Raise ValueError where `bench` has a name or a unit that the harness
    cannot use, or names something the harness cannot find under `root`.
    The ranges `BENCHMARK.json`'s schema sets (counts, bounds,
    run_seconds) are not checked here."""
    names: set = set()

    def unique(name: str, what: str) -> None:
        _name(name, what)
        if name in names:
            raise ValueError(f"{what} {name!r}: the name is taken")
        names.add(name)

    def exists(path: Path, what: str) -> None:
        if not path.is_file():
            raise ValueError(f"{what}: no file {path.relative_to(root)}")

    for c in bench["configs"]:
        unique(c["name"], "config")
        for key in c["reduced"]:
            _name(key, f"config {c['name']}: reduced key")
        exists(root / c["file"], f"config {c['name']}")
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        unique(w["name"], "cell")
        _name(w["traffic"], f"cell {w['name']}: traffic")
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']}: no config {w['config']!r}")
        exists(root / HERE / "traffic" / f"{w['traffic']}.json", f"cell {w['name']}")
        exists(root / HERE / "workloads" / f"{w['name']}.json", f"cell {w['name']}")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        unique(m["name"], "metric")
        if not (isinstance(m["unit"], str) and UNIT.match(m["unit"])):
            raise ValueError(f"metric {m['name']}: unit {m['unit']!r} is 1 to 16 letters, "
                             "digits, _, /, %, . and -")
        if set(m.get("workloads", cells)) - cells:
            raise ValueError(f"metric {m['name']}: workloads names an unknown cell")
        exists(reader_path(root, m["name"]), f"metric {m['name']}")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    workloads: list | None
    read: object

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    family: ModuleType


@dataclasses.dataclass
class Bench:
    root: Path
    doc: dict

    def cell(self, name: str) -> Cell:
        entries = {w["name"]: w for w in self.doc["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
        entry = entries[name]
        config_entry = next(c for c in self.doc["configs"] if c["name"] == entry["config"])
        config = json.loads((self.root / config_entry["file"]).read_text())
        traffic = json.loads((self.root / HERE / "traffic" / f"{entry['traffic']}.json").read_text())
        own = json.loads((self.root / HERE / "workloads" / f"{name}.json").read_text())
        if not own["limits"] or set(own["limits"]) - set(NUMBERS):
            raise ValueError(f"cell {name}: limits name some of {NUMBERS}")
        family = importlib.import_module(f"portbench.families.{config['family']}")
        return Cell(name, entry["chips"], config, traffic, own["limits"], family)

    def metrics(self, cell: str, traced: bool) -> list[Metric]:
        """The cell's end-to-end metrics, or with `traced` its per-layer ones."""
        kind = "per_layer" if traced else "end_to_end"
        out = []
        for m in self.doc[kind]:
            metric = Metric(m["name"], m["unit"], kind, m.get("workloads"), None)
            if metric.applies(cell):
                module = load_module(reader_path(self.root, m["name"]),
                                     f"portbench.metrics.{m['name']}")
                metric.read = module.read
                out.append(metric)
        return out


def load(root: Path) -> Bench:
    doc = json.loads((root / "BENCHMARK.json").read_text())
    check(doc, root)
    return Bench(root, doc)
