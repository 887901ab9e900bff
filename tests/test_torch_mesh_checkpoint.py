"""The resized-mesh restore (the reference's tests/test_checkpoint.py::
test_restore_across_resized_mesh) on gloo ranks: a MoE LM trained one
step on 4 ranks (data 2 x expert 2, each rank holding 2 of the 4
experts) is saved through DCP as DTensor shards, restored on 2 ranks
(data 2, every expert whole on each rank) into a model drawn from
another seed, and training continues there.

Held: the restored parameters equal, bit for bit, the 4-rank run's
shards put together, and the step is 1; the next step on 2 ranks (the
same global batch; momentum restored) equals the next step on the 4
ranks within the f32 tolerance of other summation orders.
"""

import numpy as np
import torch

from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
from tritonk8ssupervisor_tpu_torch.parallel import mesh, train
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

LM = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=16,
          moe_experts=4, dtype=torch.float32, logits_dtype=torch.float32)
TIMEOUT = 180.0
# the second step on 2 ranks against 4: f32, other summation orders
RTOL, ATOL = 1e-4, 2e-5


def _view(state):
    return {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "specs": state.specs,
            "coords": [state.mesh.get_local_rank(a) for a in mesh.AXES]}


def train_and_save_ranks(directory, tokens, expert_parallelism, seed, restore):
    """On a mesh with `expert_parallelism`: a model from `seed`, restored
    from `directory` when `restore`, else one step saved there; then a
    step. Returns the state before and after that step."""
    m = mesh.make_mesh(expert_parallelism=expert_parallelism, device_type="cpu")
    model = TransformerLM(**LM, moe_mesh=m, generator=torch.Generator().manual_seed(seed))
    state = train.create_train_state(model, train.default_optimizer(0.1), mesh=m)
    step = train.make_lm_train_step(state)
    local = batch_shard(m, torch.from_numpy(tokens))
    ckpt = ckpt_lib.TrainCheckpointer(directory)
    if restore:
        ckpt.restore(state)
    else:
        step(local)
        ckpt.save(state.step, state)
    before = {**_view(state), "step": state.step, "latest": ckpt.latest_step()}
    metrics = step(local)
    return before, {**_view(state), "metrics": metrics}


def _whole(results, key):
    """A parameter put together from the ranks' shards (data coordinate 0)."""
    blocks = [r["params"][key] for r in results if r["coords"][0] == 0]
    spec = results[0]["specs"][key]
    if "expert" in spec:
        order = [r["coords"][1] for r in results if r["coords"][0] == 0]
        blocks = [b for _, b in sorted(zip(order, blocks), key=lambda t: t[0])]
        return torch.cat(blocks, dim=spec.index("expert"))
    return blocks[0]


def test_restore_across_resized_mesh(tmp_path):
    tokens = np.random.default_rng(7).integers(0, 64, (8, 16)).astype(np.int32)
    directory = str(tmp_path / "ckpt")
    saved = run_ranks(train_and_save_ranks, 4, args=(directory, tokens, 2, 0, False),
                      timeout=TIMEOUT, threads=1)
    before4 = [b for b, _ in saved]
    after4 = [a for _, a in saved]
    assert before4[0]["specs"]["Block_1.moe_mlp.expert_up_kernel"][0] == "expert"
    assert before4[0]["params"]["Block_1.moe_mlp.expert_up_kernel"].shape[0] == 2

    resumed = run_ranks(train_and_save_ranks, 2, args=(directory, tokens, 1, 9, True),
                        timeout=TIMEOUT, threads=1)
    for before2, after2 in resumed:
        assert before2["step"] == 1 and before2["latest"] == 1
        assert not any(any(s) for s in before2["specs"].values())  # all whole on 2 ranks
        for key, value in before2["params"].items():
            assert torch.equal(value, _whole(before4, key)), key
        np.testing.assert_allclose(float(after2["metrics"]["loss"]),
                                   float(after4[0]["metrics"]["loss"]), rtol=RTOL, atol=ATOL)
        for key, value in after2["params"].items():
            np.testing.assert_allclose(value.numpy(), _whole(after4, key).numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
