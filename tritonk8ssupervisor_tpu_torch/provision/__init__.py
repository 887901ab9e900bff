"""The port's copies of the reference's jax-free control-plane pieces that
elastic training needs: the fleet-status reader (`fleetview.py`), the
decorrelated-jitter backoff (`retry.py`) and the atomic state-file write
(`state.py`). The port imports nothing of the JAX package, so it keeps
these copies (`tests/test_torch_imports.py`)."""
