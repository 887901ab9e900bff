"""Models of the port: the ResNet family of the benchmark's main path and
the transformer LM."""

from tritonk8ssupervisor_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50
from tritonk8ssupervisor_tpu_torch.models.transformer import TransformerLM

__all__ = ["ResNet", "ResNet18", "ResNet50", "TransformerLM"]
