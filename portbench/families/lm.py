"""The GPT family: the port's `TransformerLM` with K2 as its attention,
trained by `parallel/train.make_lm_train_step` (loss through K1), against
`portbench/reference/gpt.py`.

Configuration keys (GPT-2's `config.json` names): `n_layer`, `n_head`,
`n_embd`, `n_positions`, `vocab_size`, `layer_norm_epsilon`, and the
training recipe's `learning_rate` and `momentum`. Traffic keys: `batch`,
`seq`, `token_ids` (tokens are drawn uniformly below it), `feed_batches`
(distinct batches the window cycles through).
"""

from __future__ import annotations

import torch

from portbench import frozen
from portbench.reference import gpt
from portbench.seeds import generator
from portbench.training import load_program, make_flat_weights


def leaves(config: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every leaf, under the port's names.
    Matrices lecun-normal (std 1/sqrt(fan in)), the token table
    N(0, 1/embed), the position table N(0, 0.02^2), LayerNorm scales 1,
    biases 0."""
    e, v, s = config["n_embd"], config["vocab_size"], config["n_positions"]
    inner = 4 * e
    out = [("tok_embed.weight", (v, e), "normal", e ** -0.5),
           ("pos_embed", (s, e), "normal", 0.02)]
    for i in range(config["n_layer"]):
        p = f"Block_{i}."
        out += [
            (p + "LayerNorm_0.weight", (e,), "ones", 0.0),
            (p + "LayerNorm_0.bias", (e,), "zeros", 0.0),
            (p + "qkv.weight", (3 * e, e), "normal", e ** -0.5),
            (p + "qkv.bias", (3 * e,), "zeros", 0.0),
            (p + "proj.weight", (e, e), "normal", e ** -0.5),
            (p + "proj.bias", (e,), "zeros", 0.0),
            (p + "LayerNorm_1.weight", (e,), "ones", 0.0),
            (p + "LayerNorm_1.bias", (e,), "zeros", 0.0),
            (p + "mlp_up.weight", (inner, e), "normal", e ** -0.5),
            (p + "mlp_up.bias", (inner,), "zeros", 0.0),
            (p + "mlp_down.weight", (e, inner), "normal", inner ** -0.5),
            (p + "mlp_down.bias", (e,), "zeros", 0.0),
        ]
    out += [("LayerNorm_0.weight", (e,), "ones", 0.0),
            ("LayerNorm_0.bias", (e,), "zeros", 0.0),
            ("lm_head.weight", (v, e), "normal", e ** -0.5),
            ("lm_head.bias", (v,), "zeros", 0.0)]
    return out


def make_weights(config: dict, traffic: dict, seed: int, device) -> dict:
    return make_flat_weights(leaves(config), seed, device)


def make_batch(config: dict, traffic: dict, seed: int, index: int, device) -> torch.Tensor:
    """Batch `index` of the feed: (batch, seq) int32 tokens below `token_ids`."""
    return torch.randint(0, traffic["token_ids"], (traffic["batch"], traffic["seq"]),
                         generator=generator(seed, f"batch{index}", device),
                         device=device, dtype=torch.int32)


def build_program(config: dict, traffic: dict, weights: dict, device):
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.ops.flash_attention import flash_attention
    from tritonk8ssupervisor_tpu_torch.parallel import train

    if config["layer_norm_epsilon"] != 1e-6:
        raise ValueError("the port's LayerNorm epsilon is 1e-6")
    with torch.device("meta"):
        model = TransformerLM(
            vocab_size=config["vocab_size"], num_layers=config["n_layer"],
            num_heads=config["n_head"], embed_dim=config["n_embd"], mlp_ratio=4,
            max_seq_len=config["n_positions"], attention_fn=flash_attention,
        )
    model = model.to_empty(device=device)
    state = train.create_train_state(
        model, train.default_optimizer(config["learning_rate"], config["momentum"]), device)
    step = train.make_lm_train_step(state)
    return load_program(model, weights, state, step)


def reference_loss(leaves: dict, batch: torch.Tensor, config: dict, prec,
                   batch_share: float = 1.0) -> torch.Tensor:
    return gpt.loss_and_grads(leaves, batch, config["n_layer"], config["n_head"],
                              config["layer_norm_epsilon"], prec, batch_share)


def items_per_step(traffic: dict) -> int:
    """Tokens a step trains on."""
    return traffic["batch"] * traffic["seq"]


def model_flops_per_step(config: dict, traffic: dict) -> float:
    """Forward products 2 (12 L E^2 + E V) a token (qkv, proj, the MLP's
    two, the output head) and attention's two products, 4 E a (query, key)
    pair over the S(S+1)/2 pairs a causal sequence keeps, a layer; the
    backward twice the forward."""
    e, v, layers = config["n_embd"], config["vocab_size"], config["n_layer"]
    b, s = traffic["batch"], traffic["seq"]
    dense = 2 * (12 * layers * e * e + e * v) * b * s
    attention = 4 * e * (s * (s + 1) // 2) * layers * b
    return 3.0 * (dense + attention)


def kernel_calls(config: dict, traffic: dict) -> dict:
    """{kernel: [(bytes, operations) of each call of a step]} at bf16."""
    b, s, h = traffic["batch"], traffic["seq"], config["n_head"]
    d = config["n_embd"] // h
    layers = config["n_layer"]
    return {
        "k2": ([frozen.k2_forward_cost(b, h, s, d, True, 2)] * layers
               + [frozen.k2_backward_cost(b, h, s, d, True, 2)] * layers),
    }

