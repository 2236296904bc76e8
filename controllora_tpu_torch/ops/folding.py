"""Inference-time adapter folding (counterpart of ``controllora_tpu/ops/folding.py``).

Every ControlLoRA/LoRA operation is affine in the hidden states and the control
features, so for fixed control states the adapter stack collapses into folded
projection weights plus per-position biases computed once per guide. The algebra is
the JAX package's, written on weights in its (in, out) layout (``W = linear.weight.T``)
and in fp32; folded weights are cast back to the frozen weight dtype.

``fold_adapters`` leaves the UNet untouched: it returns the replaced weights as
``{parameter name: tensor}`` for ``torch.func.functional_call``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from controllora_tpu_torch.models.lora import AdapterStack


@dataclasses.dataclass
class FoldedBias:
    """Per-attention-layer position biases (None = not present)."""

    q_bias: Optional[torch.Tensor] = None  # (B, L, C) added after to_q
    k_bias: Optional[torch.Tensor] = None  # v2 self-attention only
    v_bias: Optional[torch.Tensor] = None  # v2 self-attention only
    out_bias: Optional[torch.Tensor] = None  # added after to_out

    def to(self, dtype) -> "FoldedBias":
        return FoldedBias(*(None if t is None else t.to(dtype)
                            for t in (self.q_bias, self.k_bias, self.v_bias,
                                      self.out_bias)))


def _f32(x):
    return x.float()


def _add_low_rank_post(W, down, up, s):
    """W @ (I + s*down@up) = W + s*(W@down)@up."""
    return _f32(W) + s * ((_f32(W) @ _f32(down)) @ _f32(up))


def _add_low_rank_pre(W, down, up, s):
    """(I + s*down@up) @ W = W + s*down@(up@W)."""
    return _f32(W) + s * (_f32(down) @ (_f32(up) @ _f32(W)))


# (in, out) projection kernel name in the JAX tree -> torch parameter suffix
_PROJ_PARAM = {"to_q": "to_q.weight", "to_k": "to_k.weight", "to_v": "to_v.weight",
               "to_out_0": "to_out.0.weight"}


def fold_adapters(
    unet: nn.Module,
    adapters: Dict[str, AdapterStack],
    lora_scale: float = 1.0,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, FoldedBias]]:
    """Returns ({unet parameter name: folded weight}, {processor name: FoldedBias}).

    Raises ValueError for stacks that cannot fold (pre/post chains)."""
    s = lora_scale
    weights: Dict[str, torch.Tensor] = {}
    biases: Dict[str, FoldedBias] = {}

    for name, stack in adapters.items():
        if stack.pre or stack.post or stack.main is None:
            raise ValueError(f"cannot fold chained stack at {name}")
        a = stack.main
        spec = a.spec
        attn_path = name[: -len(".processor")]
        attn = unet.get_submodule(attn_path)
        W = {k: getattr(attn, k).weight.t() for k in ("to_q", "to_k", "to_v")}
        W["to_out_0"] = attn.to_out[0].weight.t()
        dtype = W["to_q"].dtype
        C = W["to_q"].shape[0]
        is_self = ".attn1." in name
        p = a.params
        Wq = W["to_q"]

        def lora_delta(pair):
            return s * (_f32(pair["down"]) @ _f32(pair["up"]))

        def fold_plain(param_key, Wp):
            pr = p[param_key]
            if spec.post_add:
                return _add_low_rank_post(Wp, pr["down"], pr["up"], s)
            return _f32(Wp) + lora_delta(pr)

        q_bias = k_bias = v_bias = out_bias = None
        upd: Dict[str, torch.Tensor] = {}

        if spec.kind == "lora":
            upd["to_q"] = fold_plain("to_q", Wq)
            if "to_k" in p and not spec.key_skipped:
                upd["to_k"] = fold_plain("to_k", W["to_k"])
            if "to_v" in p and not spec.value_skipped:
                upd["to_v"] = fold_plain("to_v", W["to_v"])
            if "to_out" in p and not spec.output_skipped:
                upd["to_out_0"] = fold_plain("to_out", W["to_out_0"])

        elif spec.kind == "control_v1":
            c = _f32(a.control)  # (B, L, Cc)
            dq, uq = _f32(p["to_q"]["down"]), _f32(p["to_q"]["up"])
            dc, uc = _f32(p["to_control"]["down"]), _f32(p["to_control"]["up"])
            if spec.concat_hidden:
                d_h, d_c = dc[:C], dc[C:]
                A_through_q = (s * s) * (d_h @ ((uc @ dq) @ uq))
                Pc = s * ((c @ d_c) @ uc)
            else:
                A_through_q = None
                Pc = s * ((c @ dc) @ uc)
            if spec.control_self_add:
                Pc = c + Pc
            if spec.post_add:
                Wq2 = _add_low_rank_post(Wq, p["to_q"]["down"], p["to_q"]["up"], s)
            else:
                Wq2 = _f32(Wq) + lora_delta(p["to_q"])
            if A_through_q is not None:
                Wq2 = Wq2 + A_through_q
            upd["to_q"] = Wq2
            q_bias = s * ((Pc @ dq) @ uq)
            if "to_k" in p and not spec.key_skipped:
                upd["to_k"] = fold_plain("to_k", W["to_k"])
            if "to_v" in p and not spec.value_skipped:
                upd["to_v"] = fold_plain("to_v", W["to_v"])
            # the main control out-LoRA applies unconditionally (reference models.py:279)
            if spec.post_add:
                upd["to_out_0"] = _add_low_rank_post(
                    W["to_out_0"], p["to_out"]["down"], p["to_out"]["up"], s)
            else:
                upd["to_out_0"] = _f32(W["to_out_0"]) + lora_delta(p["to_out"])

        elif spec.kind == "control_v2":
            c = _f32(a.control)
            dc, uc = _f32(p["to_control"]["down"]), _f32(p["to_control"]["up"])
            dco, uco = _f32(p["to_control_out"]["down"]), _f32(p["to_control_out"]["up"])
            d_h, d_c = dc[:C], dc[C:]
            do_h, do_c = dco[:C], dco[C:]
            b = s * ((c @ d_c) @ uc)  # h' = h@M + b, M = I + s*d_h@uc
            bo = s * ((c @ do_c) @ uco)  # a' = a@Mo + bo
            Wq_eff = _f32(Wq) + lora_delta(p["to_q"])
            upd["to_q"] = Wq_eff + s * (d_h @ (uc @ Wq_eff))
            q_bias = b @ Wq_eff
            if is_self:
                upd["to_k"] = _add_low_rank_pre(W["to_k"], d_h, uc, s)
                k_bias = b @ _f32(W["to_k"])
                upd["to_v"] = _add_low_rank_pre(W["to_v"], d_h, uc, s)
                v_bias = b @ _f32(W["to_v"])
            Wo_eff = _f32(W["to_out_0"]) + lora_delta(p["to_out"])
            upd["to_out_0"] = Wo_eff + s * (do_h @ (uco @ Wo_eff))
            out_bias = bo @ Wo_eff
        else:
            raise ValueError(f"unknown adapter kind {spec.kind}")

        for proj, kernel in upd.items():
            weights[f"{attn_path}.{_PROJ_PARAM[proj]}"] = kernel.t().to(dtype).contiguous()
        biases[name] = FoldedBias(q_bias=q_bias, k_bias=k_bias, v_bias=v_bias,
                                  out_bias=out_bias)
    return weights, biases
