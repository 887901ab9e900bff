"""ResNet-50 v1.5 in plain PyTorch float32: the reference of the
benchmark's image cells.

Weights are a dict of leaves under the names the benchmark gives them
(`portbench/families/resnet.py` lists them). A 7x7/2 stem convolution
(padding 3), BatchNorm, ReLU and a 3x3/2 max pool (padding 1); four
stages of bottleneck blocks, 1x1 -> 3x3 -> 1x1 with the stride on the
3x3 (v1.5) and a 1x1 projection shortcut where the shape changes, each
convolution followed by BatchNorm over the batch (biased variance,
epsilon from the configuration); global average pool and a linear
classifier; the mean softmax cross-entropy over the batch. Strided
convolutions pad as TensorFlow's "SAME" does (the extra row and column
after), as the configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = (size + stride - 1) // stride
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(prec: Precision, x, weight, stride: int, pad: tuple | None = None):
    k = weight.shape[-1]
    if pad is None:
        top, bottom = _same_pad(x.shape[2], k, stride)
        left, right = _same_pad(x.shape[3], k, stride)
    else:
        top = bottom = left = right = pad
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return prec.product(F.conv2d, x, weight, stride=stride, padding=(top, left))


def _bn(w: dict, name: str, x, eps: float):
    return F.batch_norm(x, None, None, w[name + ".weight"], w[name + ".bias"],
                        training=True, eps=eps)


def block_names(stages: list[int]) -> list[tuple[str, int]]:
    """(name, stride of its 3x3) of every bottleneck block in order."""
    names, index = [], 0
    for stage, size in enumerate(stages):
        for block in range(size):
            names.append((f"BottleneckBlock_{index}", 2 if stage > 0 and block == 0 else 1))
            index += 1
    return names


def forward(w: dict, images: torch.Tensor, stages: list[int], eps: float,
            prec: Precision) -> torch.Tensor:
    """Logits (N, classes) of NHWC float32 images."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "stem_norm", _conv(prec, x, w["stem_conv.weight"], 2, pad=3), eps))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name, stride in block_names(stages):
        p = name + "."
        y = F.relu(_bn(w, p + "BatchNorm_0", _conv(prec, x, w[p + "Conv_0.weight"], 1), eps))
        y = F.relu(_bn(w, p + "BatchNorm_1", _conv(prec, y, w[p + "Conv_1.weight"], stride), eps))
        y = _bn(w, p + "BatchNorm_2", _conv(prec, y, w[p + "Conv_2.weight"], 1), eps)
        if p + "shortcut.weight" in w:
            x = _bn(w, p + "shortcut_norm", _conv(prec, x, w[p + "shortcut.weight"], stride), eps)
        x = F.relu(x + y)
    x = x.mean(dim=(2, 3))
    return prec.product(F.linear, x, w["classifier.weight"]) + w["classifier.bias"]


def loss_and_grads(w: dict, images: torch.Tensor, labels: torch.Tensor, stages: list[int],
                   eps: float, prec: Precision, batch_share: float = 1.0) -> torch.Tensor:
    """The mean cross-entropy of the batch; its gradient is left in each
    leaf's `.grad`. `batch_share` < 1 keeps that leading share of the batch
    and takes the mean over it alone (the harness's planted fault)."""
    n = max(1, int(images.shape[0] * batch_share))
    logits = forward(w, images[:n].float(), stages, eps, prec)
    loss = F.cross_entropy(logits, labels[:n].long())
    loss.backward()
    return loss.detach().double()
