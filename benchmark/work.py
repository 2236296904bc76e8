"""The work of one unit of a cell (a served batch, a training step), counted by the
benchmark, not by the program: model FLOPs by ``torch.utils.flop_counter`` over the
plain reference on the meta device at the cell's shapes, the attention calls that
the flash kernels serve, and their least time on the card's roofline.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s bf16,
3.35 TB/s HBM3."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models as ref
from benchmark.stack import layouts

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
FLASH_MIN_LEN = 2048  # self-attention at L >= this runs on the flash kernels
BF16_BYTES = 2


@dataclass(frozen=True)
class Site:
    """Attention calls of one shape in a unit: ``count`` calls at (B, H, L, D)."""

    direction: str  # "fwd" or "bwd"
    b: int
    h: int
    length: int
    d: int
    count: int

    @property
    def flops(self) -> float:
        per = 4 if self.direction == "fwd" else 10  # QK^T + PV; S, dP, dV, dQ, dK
        return float(per * self.b * self.h * self.length ** 2 * self.d * self.count)

    @property
    def bytes(self) -> float:
        """Each input read once, each output written once (bf16; LSE fp32)."""
        tile = self.b * self.h * self.length * self.d * BF16_BYTES
        lse = self.b * self.h * self.length * 4
        # fwd: q, k, v in, o out; bwd: q, k, v, o, dO, LSE in, dq, dk, dv out
        per = 4 * tile if self.direction == "fwd" else 8 * tile + lse
        return float(per * self.count)

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


def unet_sites(unet: dict, rows: int, latent: int, direction: str, evals: int) -> List[Site]:
    """The UNet's self-attentions at L >= FLASH_MIN_LEN, ``evals`` evaluations of
    ``rows`` rows on a ``latent`` x ``latent`` grid."""
    n = len(unet["block_out_channels"])
    heads = ref._per_block(unet["attention_head_dim"], n)
    counts = {}
    for name in ref.processor_names(unet):
        if ".attn1." not in name:
            continue
        level = ref.processor_level(name, n)
        length = (latent >> level) ** 2
        if length >= FLASH_MIN_LEN:
            counts[level] = counts.get(level, 0) + 1
    return [Site(direction, rows, heads[lv], (latent >> lv) ** 2,
                 unet["block_out_channels"][lv] // heads[lv], c * evals)
            for lv, c in sorted(counts.items())]


def vae_sites(vae: dict, images: int, latent: int) -> List[Site]:
    """The VAE's single-head mid-block attention (encoder or decoder), forward."""
    length = latent * latent
    if length < FLASH_MIN_LEN:
        return []
    return [Site("fwd", images, 1, length, vae["block_out_channels"][-1], 1)]


def count_flops(fn) -> float:
    """FLOPs of the matrix products and convolutions ``fn`` runs (meta tensors)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _ids(rows: int) -> torch.Tensor:
    return torch.zeros((rows, 77), dtype=torch.long, device="meta")


def serve_batch_flops(config: dict, images: int, resolution: int, steps: int) -> float:
    """A guided CFG batch: text encoders on 2n prompts, the hint encoder on n guides,
    ``steps`` UNet evaluations of 2n rows with the adapters, one VAE decode of n."""
    mods = layouts(config)
    latent = resolution // 8
    with torch.no_grad():
        ctx, pooled = ref.encode_text(mods["text"], _ids(2 * images), _ids(2 * images))
        guides = torch.empty((images, 3, resolution, resolution), device="meta")
        adapters = mods["control"].adapters(mods["control"].controls(guides), config["unet"])
        x = torch.empty((2 * images, 4, latent, latent), device="meta")
        t = torch.zeros((2 * images,), device="meta")
        extra = _text_time(config, pooled, 2 * images)
        z = torch.empty((images, 4, latent, latent), device="meta")
        return (count_flops(lambda: ref.encode_text(mods["text"], _ids(2 * images),
                                                     _ids(2 * images)))
                + count_flops(lambda: mods["control"].controls(guides))
                + steps * count_flops(lambda: mods["unet"](x, t, ctx, adapters, 1.0, **extra))
                + count_flops(lambda: mods["vae"].decode(z)))


def train_step_flops(config: dict, batch: int, resolution: int) -> float:
    """One step: VAE encode and text encode (no gradient), the hint encoder and the
    UNet forward with the adapters, and the backward to the adapters (the frozen
    weights take no gradient)."""
    mods = layouts(config)
    latent = resolution // 8
    for key in ("unet", "vae", "text"):
        mods[key].requires_grad_(False)
    mods["control"].requires_grad_(True)

    def run():
        with torch.no_grad():
            px = torch.empty((batch, 3, resolution, resolution), device="meta")
            lat = mods["vae"].encode(px, torch.empty((batch, 4, latent, latent), device="meta"))
            ctx, pooled = ref.encode_text(mods["text"], _ids(batch), _ids(batch))
        controls = mods["control"].controls(px)
        adapters = mods["control"].adapters(controls, config["unet"])
        pred = mods["unet"](lat, torch.zeros((batch,), device="meta"), ctx, adapters, 1.0,
                            **_text_time(config, pooled, batch))
        pred.float().pow(2).mean().backward()

    return count_flops(run)


def _text_time(config: dict, pooled, rows: int) -> dict:
    if config["unet"]["addition_embed_type"] != "text_time":
        return {}
    return {"text_embeds": pooled, "time_ids": torch.zeros((rows, 6), device="meta")}
