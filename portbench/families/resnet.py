"""The ResNet family: the port's `ResNet50` (cuDNN convolutions; with
`fused_1x1_bwd`, K4 for the backward of every stride-1 1x1 convolution),
trained by `parallel/train.make_train_step` (loss through K1), against
`portbench/reference/resnet.py`.

Configuration keys: `stages` (bottleneck blocks a stage), `num_filters`,
`expansion`, `num_classes`, `bn_epsilon`, `learning_rate`, `momentum`.
Traffic keys: `batch`, `image_size`, `fused_1x1_bwd`, `feed_batches`.
"""

from __future__ import annotations

import torch

from portbench import frozen
from portbench.reference import resnet
from portbench.seeds import generator
from portbench.training import load_program, make_flat_weights


def _blocks(config: dict):
    """(name, in features, filters, stride, input size) of every block at
    image size 1 (sizes are multiplied by the caller)."""
    features = config["num_filters"]
    out, index = [], 0
    for stage, size in enumerate(config["stages"]):
        filters = config["num_filters"] * 2 ** stage
        for block in range(size):
            stride = 2 if stage > 0 and block == 0 else 1
            out.append((f"BottleneckBlock_{index}", features, filters, stride))
            features = filters * config["expansion"]
            index += 1
    return out


def leaves(config: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every leaf, under the port's names:
    convolutions and the classifier lecun-normal (std 1/sqrt(fan in)),
    BatchNorm scales 1 but each block's last, which starts at 0 so the
    block starts as its shortcut; biases 0."""
    f0, x = config["num_filters"], config["expansion"]
    out = [("stem_conv.weight", (f0, 3, 7, 7), "normal", (3 * 49) ** -0.5),
           ("stem_norm.weight", (f0,), "ones", 0.0), ("stem_norm.bias", (f0,), "zeros", 0.0)]

    def conv_bn(prefix, conv, norm, cin, cout, k, zero_scale=False):
        return [(prefix + conv + ".weight", (cout, cin, k, k), "normal", (cin * k * k) ** -0.5),
                (prefix + norm + ".weight", (cout,), "zeros" if zero_scale else "ones", 0.0),
                (prefix + norm + ".bias", (cout,), "zeros", 0.0)]

    for name, cin, f, stride in _blocks(config):
        p = name + "."
        out += conv_bn(p, "Conv_0", "BatchNorm_0", cin, f, 1)
        out += conv_bn(p, "Conv_1", "BatchNorm_1", f, f, 3)
        out += conv_bn(p, "Conv_2", "BatchNorm_2", f, f * x, 1, zero_scale=True)
        if stride != 1 or cin != f * x:
            out += conv_bn(p, "shortcut", "shortcut_norm", cin, f * x, 1)
    features = f0 * 2 ** (len(config["stages"]) - 1) * x
    out += [("classifier.weight", (config["num_classes"], features), "normal", features ** -0.5),
            ("classifier.bias", (config["num_classes"],), "zeros", 0.0)]
    return out


def make_weights(config: dict, traffic: dict, seed: int, device) -> dict:
    weights = make_flat_weights(leaves(config), seed, device)
    return {n: w.contiguous(memory_format=torch.channels_last) if w.dim() == 4 else w
            for n, w in weights.items()}


def make_batch(config: dict, traffic: dict, seed: int, index: int, device):
    """Batch `index` of the feed: bf16 NHWC images N(0, 1) and int32 labels."""
    g = generator(seed, f"batch{index}", device)
    n, size = traffic["batch"], traffic["image_size"]
    images = torch.randn((n, size, size, 3), generator=g, device=device, dtype=torch.bfloat16)
    labels = torch.randint(0, config["num_classes"], (n,), generator=g, device=device,
                           dtype=torch.int32)
    return images, labels


def build_program(config: dict, traffic: dict, weights: dict, device):
    from tritonk8ssupervisor_tpu_torch.models import ResNet50
    from tritonk8ssupervisor_tpu_torch.parallel import train

    if (list(config["stages"]) != [3, 4, 6, 3] or config["num_filters"] != 64
            or config["expansion"] != 4 or config["bn_epsilon"] != 1e-5):
        raise ValueError("the port's ResNet50 is stages 3-4-6-3 of 64 filters, x4, epsilon 1e-5")
    with torch.device("meta"):
        model = ResNet50(num_classes=config["num_classes"],
                         fused_1x1_bwd=traffic["fused_1x1_bwd"])
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
    state = train.create_train_state(
        model, train.default_optimizer(config["learning_rate"], config["momentum"]), device)
    step = train.make_train_step(state)
    program = load_program(model, weights, state, step)
    program.step = lambda batch: step(*batch)
    return program


def reference_loss(leaves: dict, batch, config: dict, prec, batch_share: float = 1.0):
    images, labels = batch
    return resnet.loss_and_grads(leaves, images, labels, list(config["stages"]),
                                 config["bn_epsilon"], prec, batch_share)


def items_per_step(traffic: dict) -> int:
    """Images a step trains on."""
    return traffic["batch"]


def _convs(config: dict, size: int):
    """(in, out, kernel, stride, output height and width) of every
    convolution, at input size `size`."""
    out = [(3, config["num_filters"], 7, 2, -(-size // 2))]
    size = -(-size // 2)
    size = -(-size // 2)  # the stem's max pool
    for _, cin, f, stride in _blocks(config):
        x = config["expansion"]
        after = -(-size // stride)
        out += [(cin, f, 1, 1, size), (f, f, 3, stride, after), (f, f * x, 1, 1, after)]
        if stride != 1 or cin != f * x:
            out.append((cin, f * x, 1, stride, after))
        size = after
    return out


def model_flops_per_step(config: dict, traffic: dict) -> float:
    """Every convolution's 2 Cin Cout k^2 a output pixel and the
    classifier's product, forward; the backward twice the forward."""
    n = traffic["batch"]
    convs = sum(2 * cin * cout * k * k * hw * hw for cin, cout, k, _, hw in
                _convs(config, traffic["image_size"]))
    features = config["num_filters"] * 2 ** (len(config["stages"]) - 1) * config["expansion"]
    return 3.0 * n * (convs + 2 * features * config["num_classes"])


def kernel_calls(config: dict, traffic: dict) -> dict:
    """{kernel: [(bytes, operations) of each call of a step]} at bf16: K4
    on every stride-1 1x1 convolution's backward when the traffic takes it."""
    if not traffic["fused_1x1_bwd"]:
        return {"k4": []}
    n = traffic["batch"]
    calls = [frozen.k4_backward_cost(n * hw * hw, cin, cout, 2)
             for cin, cout, k, stride, hw in _convs(config, traffic["image_size"])
             if k == 1 and stride == 1]
    return {"k4": calls}
