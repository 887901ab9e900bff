"""The port's warm cache (`provision/cache.py`) against the reference's:
the role-tree hash of the repository's own `ansible/` tree, the slice
inventory views and hashes, the converge keys, and one scripted sequence
of `WarmCache` records, hits, misses, invalidations and a corrupt store
give equal answers and byte-equal stores (each side's root replaced by
one name). No tolerance."""

import shutil
from pathlib import Path

from tritonk8ssupervisor_tpu.provision import cache as ref_cache
from tritonk8ssupervisor_tpu.provision import journal as ref_journal
from tritonk8ssupervisor_tpu.provision.state import RunPaths as RefRunPaths
from tritonk8ssupervisor_tpu_torch.provision import cache, journal
from tritonk8ssupervisor_tpu_torch.provision.state import RunPaths

ROOT = Path(__file__).resolve().parents[1]

INVENTORY = """\
[TPUHOST]
10.0.0.1 slice_index=0 process_id=0 slice_coordinator=10.1.0.1 global_coordinator=10.1.0.1
10.0.0.2 slice_index=0 process_id=1 slice_coordinator=10.1.0.1 global_coordinator=10.1.0.1
10.0.1.1 slice_index=1 process_id=0 slice_coordinator=10.1.1.1 global_coordinator=10.1.0.1
10.0.12.1 slice_index=12 process_id=0 slice_coordinator=10.1.12.1 global_coordinator=10.1.0.1

[TPUHOST:vars]
ansible_python_interpreter=/usr/bin/python3

[LOCAL]
localhost ansible_connection=local
"""


def test_role_tree_hash_of_the_repository_ansible_tree(tmp_path):
    tree = ROOT / "ansible"
    assert cache.role_tree_hash(tree) == ref_cache.role_tree_hash(tree)
    assert cache.role_tree_hash(tmp_path / "absent") == ref_cache.role_tree_hash(
        tmp_path / "absent")
    copy = tmp_path / "ansible"
    shutil.copytree(tree, copy)
    before = cache.role_tree_hash(copy)
    assert before == cache.role_tree_hash(tree)
    # the inventory, ansible.cfg and *.retry files are not the role tree
    (copy / "hosts").write_text(INVENTORY)
    (copy / "ansible.cfg").write_text("[defaults]\nprivate_key_file = /k\n")
    (copy / "site.retry").write_text("10.0.0.1\n")
    assert cache.role_tree_hash(copy) == ref_cache.role_tree_hash(copy) == before
    task = next(p for p in sorted(copy.rglob("*.yml")))
    task.write_text(task.read_text() + "\n# edited\n")
    assert cache.role_tree_hash(copy) == ref_cache.role_tree_hash(copy) != before


def _workdir(root: Path, paths_cls):
    paths = paths_cls(root)
    shutil.copytree(ROOT / "ansible", paths.ansible_dir)
    paths.inventory.write_text(INVENTORY)
    return paths


def test_slice_inventory_and_converge_keys_as_the_reference(tmp_path):
    ours = _workdir(tmp_path / "port", RunPaths)
    ref = _workdir(tmp_path / "reference", RefRunPaths)
    for index in (0, 1, 2, 12):
        assert (cache.slice_inventory_lines(INVENTORY, index)
                == ref_cache.slice_inventory_lines(INVENTORY, index))
        assert (cache.slice_inventory_hash(ours.inventory, index)
                == ref_cache.slice_inventory_hash(ref.inventory, index))
        for ips, key, user in ((["10.0.0.2", "10.0.0.1"], "/k", "u"), ([], "", "")):
            assert (cache.converge_key(ours, index, ips, ssh_key=key, ansible_user=user)
                    == ref_cache.converge_key(ref, index, ips, ssh_key=key, ansible_user=user))
    # slice 1's own host line dirties slice 1 alone; a global line dirties all
    keys = {i: cache.converge_key(ours, i, []) for i in (0, 1)}
    ours.inventory.write_text(INVENTORY.replace("10.0.1.1 slice_index=1", "10.0.1.9 slice_index=1"))
    assert cache.converge_key(ours, 0, []) == keys[0] != cache.converge_key(ours, 1, [])
    ours.inventory.write_text(INVENTORY.replace("python3", "python3.12"))
    assert all(cache.converge_key(ours, i, []) != keys[i] for i in (0, 1))
    assert cache.slice_inventory_hash(tmp_path / "none", 0) == ""
    parts = ("a", 1, [2, 3], {"b": None})
    assert journal.inputs_hash(*parts) == ref_journal.inputs_hash(*parts)
    for p in (ours.inventory, ours.ansible_dir, tmp_path / "none"):
        assert journal.digest_path(p) == ref_journal.digest_path(p)


def _cache_script(module, root: Path) -> list:
    """One sequence of WarmCache calls: every answer, and the store's
    bytes after each step."""
    root.mkdir(parents=True)
    manifest = root / "manifests"
    manifest.mkdir()
    (manifest / "job.yaml").write_text("kind: Job\n")
    hosts = root / "hosts.json"
    hosts.write_text("{}\n")
    store = root / "provision-cache.json"
    warm = module.WarmCache(store)
    out = []

    def step(label, value=None):
        text = store.read_text().replace(str(root), "ROOT") if store.exists() else None
        out.append((label, value, text))

    step("cold", warm.fresh("compile-manifests", "k1", [manifest]))
    warm.record("compile-manifests", "k1", [manifest])
    step("recorded")
    step("hit", warm.fresh("compile-manifests", "k1", [manifest]))
    step("other key", warm.fresh("compile-manifests", "k2", [manifest]))
    step("empty key", warm.fresh("compile-manifests", "", [manifest]))
    step("new artifact", warm.fresh("compile-manifests", "k1", [manifest, hosts]))
    warm.record("configure-slice-0", "c0", [hosts])
    warm.record("configure-slice-1", "c1")
    step("tasks", warm.tasks())
    (manifest / "job.yaml").write_text("kind: Job\nedited: true\n")
    step("edited artifact", warm.fresh("compile-manifests", "k1", [manifest]))
    step("slice 1", warm.fresh("configure-slice-1", "c1"))
    warm.invalidate("configure-slice-0")
    step("invalidated", warm.fresh("configure-slice-0", "c0", [hosts]))
    warm.invalidate("never-recorded")
    step("invalidate unknown", warm.tasks())
    store.write_text("{ torn")
    step("corrupt store", (warm.fresh("configure-slice-1", "c1"), warm.tasks()))
    store.write_text("[1, 2]\n")
    step("not a dict", warm.tasks())
    warm.record("configure-slice-1", "c1")
    warm.invalidate()
    step("invalidate all", warm.tasks())
    warm.record("a", "ka")
    warm.scrub()
    step("scrubbed", warm.tasks())
    return out


def test_warm_cache_sequence_as_the_reference(tmp_path):
    ours = _cache_script(cache, tmp_path / "port")
    ref = _cache_script(ref_cache, tmp_path / "reference")
    assert ours == ref
    answers = dict((label, value) for label, value, _ in ours)
    assert answers["cold"] is False and answers["hit"] is True
    assert answers["edited artifact"] is False and answers["slice 1"] is True
    assert answers["corrupt store"] == (False, [])
