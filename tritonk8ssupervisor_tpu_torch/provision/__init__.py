"""The port's copies of the reference's jax-free provisioning plane, from
the leaves up: the subprocess runners (`runner.py`), the transient-vs-fatal
retry engine (`retry.py`), the workdir layout and locks (`state.py`), the
task DAG (`scheduler.py`), its durable journal (`journal.py`) and warm
cache (`cache.py`), the maintenance watchdog (`maintenance.py`), the
supervisor's event ledger and its fold (`events.py`), the fleet-status
reader (`fleetview.py`) and the healer's slice states (`heal.py`). The
port imports nothing of the JAX package, so it keeps these copies
(`tests/test_torch_imports.py`). The supervisor, the healer and the
terraform and ansible wrappers are not ported yet (ROADMAP.md)."""
