"""Every UNet head dim of the zoo's eight variants lies in the backward kernels' range.

The JAX trainer differentiates through each UNet self-attention that takes its flash
kernels (``controllora_tpu/ops/attention.py::_use_flash``: L >= 2048, any head dim),
so K3/K4 have to take every head dim a variant's UNet has: ``MAX_BWD_HEAD_DIM`` covers
them all and is the widest of them (SD1.5's level-2 160, which it reaches from 1472²
up). The head dims come from the configs (``models/zoo.py::VARIANTS``, which equal the
JAX package's: tests/test_torch_families.py) through the attention modules a UNet
builds from them, on the meta device.
"""

import pytest
import torch

from controllora_tpu_torch.models import zoo
from controllora_tpu_torch.models.unet import CrossAttention, UNet2DConditionModel
from controllora_tpu_torch.ops import flash_attention as fa


def head_dims(variant):
    """The head dims of every attention layer of the variant's UNet."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(zoo.VARIANTS[variant][0])
    return {m.to_q.out_features // m.heads for m in unet.modules()
            if isinstance(m, CrossAttention)}


@pytest.mark.parametrize("variant", sorted(zoo.VARIANTS))
def test_unet_head_dims_are_in_the_backward_range(variant):
    dims = head_dims(variant)
    assert dims and all(d % 8 == 0 and d <= fa.MAX_BWD_HEAD_DIM for d in dims), dims


def test_the_backward_range_ends_at_the_widest_unet_head():
    widest = {v: max(head_dims(v)) for v in zoo.VARIANTS}
    assert head_dims("sd15") == {40, 80, 160}
    assert max(widest.values()) == fa.MAX_BWD_HEAD_DIM == 160, widest
