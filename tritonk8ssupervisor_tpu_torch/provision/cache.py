"""Content-addressed warm path for the provisioning pipeline.

The journal (provision/journal.py) made re-runs crash-safe, but its skip
logic only fires on a RESUME — scrub the ledger (teardown, or a heal that
rewrites hosts.json) and the next converge pays full compile/converge cost
even when nothing changed. Maple-style incremental bring-up (PAPERS.md)
keys redundant work off the *content* of a task's inputs, not off run
history: if the same inputs already converged once, converging them again
is a no-op by definition (ansible and terraform are idempotent; the only
cost is the minutes they take to discover that).

This module is that content key. A small JSON store
(`provision-cache.json`, next to the journal) records, per task, the
digest of everything that feeds it:

- ``compile-manifests``: the config fingerprint + Job knobs, plus the
  digest of the emitted manifest directory (a hand-edited manifest must
  recompile, not be trusted);
- ``configure-slice-N``: the role tree (playbook + roles/ + group_vars —
  everything ansible executes), THAT SLICE's inventory lines (host lines
  carry ``slice_index=N``; section/vars lines without a slice index are
  global and dirty every slice), the slice's host IPs, and the SSH
  identity ansible will use.

`provision` (cli/main.py), `heal` (provision/heal.py), and crash-resume
all consult the SAME store, so a single lost slice heals by re-converging
only itself: the healthy slices' keys still match and their converge is
skipped. The store is advisory — deleting it merely makes the next run
cold — and every entry verifies by digest, never by timestamp.
docs/performance.md has the "why is my run not warm?" debugging table.

The port's copy of `tritonk8ssupervisor_tpu/provision/cache.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Iterable

from tritonk8ssupervisor_tpu_torch.provision import journal as journal_mod
from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text

# Files under ansible/ that are NOT part of the role tree: the inventory
# is keyed per slice separately, ansible.cfg churns with the patched SSH
# key path (the key identity is part of converge_key instead), and
# *.retry files are ansible's own failure residue.
_ROLE_TREE_EXCLUDE = ("hosts", "ansible.cfg")


def role_tree_hash(ansible_dir: Path) -> str:
    """Digest of everything ansible *executes*: the playbook, roles/
    (including generated role files), group_vars. One changed task file
    dirties every slice's converge — ansible applies the whole tree."""
    ansible_dir = Path(ansible_dir)
    h_parts = []
    if not ansible_dir.is_dir():
        return journal_mod.inputs_hash("role-tree", None)
    for sub in sorted(p for p in ansible_dir.rglob("*") if p.is_file()):
        rel = sub.relative_to(ansible_dir)
        if rel.name in _ROLE_TREE_EXCLUDE and len(rel.parts) == 1:
            continue
        if sub.suffix == ".retry":
            continue
        h_parts.append((str(rel), journal_mod.digest_path(sub)))
    return journal_mod.inputs_hash("role-tree", h_parts)


def slice_inventory_lines(inventory_text: str, slice_index: int) -> list[str]:
    """The inventory lines that affect slice `slice_index`: its own host
    lines (tagged ``slice_index=N``) plus every line that names no slice
    at all — section headers, group vars, the [LOCAL] block — which are
    global and therefore affect every slice."""
    mine = f"slice_index={slice_index} "
    lines = []
    for line in inventory_text.splitlines():
        if "slice_index=" in line:
            if mine in line:
                lines.append(line)
        elif line.strip():
            lines.append(line)
    return lines


def slice_inventory_hash(inventory: Path, slice_index: int) -> str:
    """Digest of one slice's slice-scoped inventory view ("" when the
    inventory has not been written yet — a cold key that can never match
    a recorded one)."""
    inventory = Path(inventory)
    if not inventory.is_file():
        return ""
    return journal_mod.inputs_hash(
        "inventory-slice", slice_index,
        slice_inventory_lines(inventory.read_text(), slice_index),
    )


def converge_key(
    paths,
    slice_index: int,
    slice_ips: Iterable[str],
    ssh_key: str = "",
    ansible_user: str = "",
) -> str:
    """The content key for one slice's converge: role tree + this slice's
    inventory view + its endpoints + the SSH identity. Computed AFTER
    host-prep has written the runtime configs — the generated inventory
    and role files are inputs, not outputs, of the converge."""
    return journal_mod.inputs_hash(
        "converge-slice",
        slice_index,
        role_tree_hash(paths.ansible_dir),
        slice_inventory_hash(paths.inventory, slice_index),
        sorted(slice_ips),
        str(ssh_key),
        ansible_user,
    )


class WarmCache:
    """The digest store. Thread-safe (per-slice converge tasks record
    concurrently from scheduler workers); every write is atomic
    (state.atomic_write_text) so a reader never sees a torn store — a
    corrupt store reads as empty, i.e. cold, never as an error."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        self._mutex = threading.Lock()

    # ------------------------------------------------------------- storage

    def _load(self) -> dict:
        if not self.path.exists():
            return {}
        try:
            raw = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError):
            return {}  # torn/corrupt store == cold store, never fatal
        return raw if isinstance(raw, dict) else {}

    def _store(self, data: dict) -> None:
        atomic_write_text(
            self.path, json.dumps(data, indent=2, sort_keys=True) + "\n"
        )

    # -------------------------------------------------------------- verify

    def fresh(
        self, task: str, key: str, artifacts: Iterable[Path] = ()
    ) -> bool:
        """True iff `task` was recorded with exactly this content key AND
        every artifact recorded at that time still hashes the same (a
        hand-edited manifest dirties compile, the Maple rule: trust
        content, never history)."""
        if not key:
            return False
        with self._mutex:
            entry = self._load().get(task)
        if not isinstance(entry, dict) or entry.get("key") != key:
            return False
        recorded = entry.get("artifacts", {})
        for p in artifacts:
            if str(p) not in recorded:
                return False  # recorded under an older artifact contract
        for p_str, digest in recorded.items():
            if journal_mod.digest_path(Path(p_str)) != digest:
                return False
        return True

    def record(
        self, task: str, key: str, artifacts: Iterable[Path] = ()
    ) -> None:
        digests = {str(p): journal_mod.digest_path(p) for p in artifacts}
        with self._mutex:
            data = self._load()
            data[task] = {"key": key, "artifacts": digests}
            self._store(data)

    def invalidate(self, task: str | None = None) -> None:
        """Drop one task's entry (heal forces the replaced slice cold even
        if its new endpoints collide with the old key) or, with None, the
        whole store."""
        with self._mutex:
            if task is None:
                self.path.unlink(missing_ok=True)
                return
            data = self._load()
            if task in data:
                del data[task]
                self._store(data)

    def tasks(self) -> list[str]:
        with self._mutex:
            return sorted(self._load())

    def scrub(self) -> None:
        self.path.unlink(missing_ok=True)
