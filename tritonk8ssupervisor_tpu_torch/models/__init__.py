"""Models of the port: the ResNet family of the benchmark's main path, the
transformer LM, its KV-cache decoding (`models/decode.py`), the vision
transformer and the mixture-of-experts MLP."""

from tritonk8ssupervisor_tpu_torch.models.decode import (
    generate,
    init_kv_cache,
    init_kv_pool,
    lm_params,
    prefill,
    quantize_params_int8,
    speculative_accept,
)
from tritonk8ssupervisor_tpu_torch.models.moe import MoEMLP
from tritonk8ssupervisor_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50
from tritonk8ssupervisor_tpu_torch.models.transformer import TransformerLM
from tritonk8ssupervisor_tpu_torch.models.vit import ViT

__all__ = [
    "MoEMLP",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "TransformerLM",
    "ViT",
    "generate",
    "init_kv_cache",
    "init_kv_pool",
    "lm_params",
    "prefill",
    "quantize_params_int8",
    "speculative_accept",
]
