"""The port's copies of the reference's jax-free provisioning plane, from
the leaves up: the subprocess runners (`runner.py`), the transient-vs-fatal
retry engine (`retry.py`), the workdir layout and locks (`state.py`), the
task DAG (`scheduler.py`), its durable journal (`journal.py`) and warm
cache (`cache.py`), the maintenance watchdog (`maintenance.py`), the
supervisor's event ledger and its fold (`events.py`), the fleet-status
reader (`fleetview.py`), the terraform and ansible wrappers
(`terraform.py`, `ansible.py`), readiness probing (`readiness.py`), the
slice-granular healer (`heal.py`), the autoscaler and allocator
(`autoscale.py`, `allocator.py`), the resident supervisor
(`supervisor.py`) and teardown (`teardown.py`). The port imports nothing
of the JAX package, so it keeps these copies
(`tests/test_torch_imports.py`)."""
