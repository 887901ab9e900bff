"""utils/convert.py: every flax leaf of the ResNet family maps onto the
port's state dict, and anything it cannot map raises."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu_torch.models import resnet
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

FAMILIES = [
    (jax_resnet.ResNet18, resnet.ResNet18),
    (jax_resnet.ResNet50, resnet.ResNet50),
]


def _variables(jax_cls):
    """flax variables with distinct seeded numpy values per leaf."""
    shapes = jax.eval_shape(
        lambda: jax_cls(num_classes=10, num_filters=8).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False
        )
    )
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes
    )


@pytest.mark.parametrize("jax_cls,torch_cls", FAMILIES, ids=["resnet18", "resnet50"])
def test_every_leaf_is_mapped_with_its_layout(jax_cls, torch_cls):
    variables = _variables(jax_cls)
    model = torch_cls(num_classes=10, num_filters=8)
    state = state_dict_from_flax(variables, model)
    assert set(state) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves
    model.load_state_dict(state)

    p, s = variables["params"], variables["batch_stats"]
    block = "BasicBlock_2" if torch_cls is resnet.ResNet18 else "BottleneckBlock_3"
    np.testing.assert_array_equal(
        model.stem_conv.weight.detach().numpy(),
        p["stem_conv"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        model.classifier.weight.detach().numpy(), p["classifier"]["kernel"].T
    )
    np.testing.assert_array_equal(model.classifier.bias.detach().numpy(), p["classifier"]["bias"])
    norm = getattr(model, block).shortcut_norm
    np.testing.assert_array_equal(norm.weight.detach().numpy(), p[block]["shortcut_norm"]["scale"])
    np.testing.assert_array_equal(norm.bias.detach().numpy(), p[block]["shortcut_norm"]["bias"])
    np.testing.assert_array_equal(norm.running_mean.numpy(), s[block]["shortcut_norm"]["mean"])
    np.testing.assert_array_equal(norm.running_var.numpy(), s[block]["shortcut_norm"]["var"])


def test_missing_extra_and_misshapen_leaves_raise():
    variables = _variables(jax_resnet.ResNet18)
    model = resnet.ResNet18(num_classes=10, num_filters=8)

    missing = copy.deepcopy(variables)
    del missing["batch_stats"]["BasicBlock_1"]["BatchNorm_0"]["var"]
    with pytest.raises(ValueError, match=r"unfilled.*BasicBlock_1\.BatchNorm_0\.running_var"):
        state_dict_from_flax(missing, model)

    extra = copy.deepcopy(variables)
    extra["params"]["BasicBlock_1"]["Conv_9"] = {"kernel": np.zeros((3, 3, 8, 8), np.float32)}
    with pytest.raises(ValueError, match="Conv_9"):
        state_dict_from_flax(extra, model)

    unknown_leaf = copy.deepcopy(variables)
    unknown_leaf["params"]["stem_norm"]["offset"] = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="unmapped leaf"):
        state_dict_from_flax(unknown_leaf, model)

    with pytest.raises(ValueError, match="collection"):
        state_dict_from_flax({**variables, "moe_losses": {}}, model)

    misshapen = copy.deepcopy(variables)
    misshapen["params"]["classifier"]["kernel"] = np.zeros((10, 64), np.float32)
    with pytest.raises(ValueError, match="classifier.weight"):
        state_dict_from_flax(misshapen, model)

    # a state dict from a model of another width is refused as a whole
    with pytest.raises(ValueError):
        state_dict_from_flax(variables, resnet.ResNet18(num_classes=10, num_filters=16))
    assert isinstance(state_dict_from_flax(variables, model)["stem_norm.weight"], torch.Tensor)


LM_CONFIG = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=16)


def _lm_variables(head_major=False):
    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM

    shapes = jax.eval_shape(
        lambda: JaxLM(**LM_CONFIG, head_major=head_major).init(
            jax.random.key(0), jnp.zeros((1, 16), jnp.int32)
        )
    )
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes
    )


@pytest.mark.parametrize("head_major", [False, True], ids=["seq-major", "head-major"])
def test_every_lm_leaf_is_mapped_with_its_layout(head_major):
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM

    variables = _lm_variables(head_major)
    model = TransformerLM(**LM_CONFIG, head_major=head_major)
    state = state_dict_from_flax(variables, model)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state)

    p = variables["params"]
    np.testing.assert_array_equal(model.tok_embed.weight.detach().numpy(),
                                  p["tok_embed"]["embedding"])
    np.testing.assert_array_equal(model.pos_embed.detach().numpy(), p["pos_embed"])
    np.testing.assert_array_equal(model.Block_1.qkv.weight.detach().numpy(),
                                  p["Block_1"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(model.Block_0.proj.bias.detach().numpy(),
                                  p["Block_0"]["proj"]["bias"])
    np.testing.assert_array_equal(model.Block_0.LayerNorm_1.weight.detach().numpy(),
                                  p["Block_0"]["LayerNorm_1"]["scale"])
    np.testing.assert_array_equal(model.LayerNorm_0.bias.detach().numpy(),
                                  p["LayerNorm_0"]["bias"])
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(),
                                  p["lm_head"]["kernel"].T)


def test_lm_unmapped_unfilled_and_misshapen_leaves_raise():
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM

    variables = _lm_variables()
    model = TransformerLM(**LM_CONFIG)

    missing = copy.deepcopy(variables)
    del missing["params"]["pos_embed"]
    with pytest.raises(ValueError, match=r"unfilled.*'pos_embed'"):
        state_dict_from_flax(missing, model)

    no_embed = copy.deepcopy(variables)
    del no_embed["params"]["tok_embed"]["embedding"]
    with pytest.raises(ValueError, match=r"unfilled.*tok_embed\.weight"):
        state_dict_from_flax(no_embed, model)

    extra = copy.deepcopy(variables)
    extra["params"]["rope_freqs"] = np.zeros(16, np.float32)
    with pytest.raises(ValueError, match="rope_freqs"):
        state_dict_from_flax(extra, model)

    unknown_leaf = copy.deepcopy(variables)
    unknown_leaf["params"]["Block_0"]["LayerNorm_0"]["offset"] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match="unmapped leaf params/Block_0/LayerNorm_0/offset"):
        state_dict_from_flax(unknown_leaf, model)

    misshapen = copy.deepcopy(variables)
    misshapen["params"]["pos_embed"] = np.zeros((8, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        state_dict_from_flax(misshapen, model)

    with pytest.raises(ValueError, match="collection"):
        state_dict_from_flax({**variables, "moe_losses": {}}, model)
