"""Load JAX parameter trees (as numpy) into the port's modules.

The numpy key maps below are the port's own copies of the JAX package's exporters
(``controllora_tpu/utils/torch_compat.py``: ``flax_to_torch_unet``, ``_vae``,
``_clip`` and ``control_lora_to_torch``, with the helpers they call), so the port
imports nothing of the JAX package. They turn a flax parameter tree into diffusers /
reference state-dict keys, which are the port's parameter names. Every load is
``strict=True``, so a key gap fails loudly. tests/test_torch_standalone.py holds the
copies equal to the originals.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from controllora_tpu_torch.config import ControlLoRAConfig


def load_numpy_state_dict(module: nn.Module, sd: Dict[str, Any]) -> nn.Module:
    """Copy numpy arrays into ``module`` (strict), converting to its dtypes."""
    tensors = {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
               for k, v in sd.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def load_unet(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, flax_to_torch_unet(params))


def load_vae(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, flax_to_torch_vae(params))


def load_clip(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """A text tower's tree, or SDXL's dual-encoder tree {"te1": ..., "te2": ...}
    (the JAX ``DualCLIPTextEncoder``'s) into the port's ``te1``/``te2``."""
    if "te1" in params:
        return load_numpy_state_dict(module, {
            f"{tower}.{k}": v for tower in ("te1", "te2")
            for k, v in flax_to_torch_clip(params[tower]).items()})
    return load_numpy_state_dict(module, flax_to_torch_clip(params))


def load_control_lora(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    return load_numpy_state_dict(module, control_lora_to_torch(params, module.config))


# ---------------------------------------------------------------------------- key maps
# copied from controllora_tpu/utils/torch_compat.py


_LORA_PROJ = {
    "to_q_lora": "to_q",
    "to_k_lora": "to_k",
    "to_v_lora": "to_v",
    "to_out_lora": "to_out",
    "to_control": "to_control",
    "to_control_out": "to_control_out",
}


def _export_conv(sd, key, node):
    sd[f"{key}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _export_linear(sd, key, node):
    sd[f"{key}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _export_norm(sd, key, node):
    inner = node["norm"] if "norm" in node else node
    sd[f"{key}.weight"] = np.asarray(inner["scale"])
    sd[f"{key}.bias"] = np.asarray(inner["bias"])


def _torch_block_name(flax_name: str) -> Optional[str]:
    """down_blocks_0_resnets_1 -> down_blocks.0.resnets.1 ; mid_resnets_0 ->
    mid_block.resnets.0 ; down_blocks_0_downsample -> down_blocks.0.downsamplers.0.conv."""
    m = re.fullmatch(r"(down|up)_blocks_(\d+)_(resnets|attentions)_(\d+)", flax_name)
    if m:
        return f"{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}.{m.group(4)}"
    m = re.fullmatch(r"mid_(resnets|attentions)_(\d+)", flax_name)
    if m:
        return f"mid_block.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"down_blocks_(\d+)_downsample", flax_name)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.conv"
    m = re.fullmatch(r"up_blocks_(\d+)_upsample", flax_name)
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0.conv"
    return None


def flax_to_torch_unet(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of translate_unet — export flax UNet params in diffusers naming."""
    sd: Dict[str, np.ndarray] = {}

    def export_attention(prefix, node):
        for proj in ("to_q", "to_k", "to_v"):
            _export_linear(sd, f"{prefix}.{proj}", node[proj])
        _export_linear(sd, f"{prefix}.to_out.0", node["to_out_0"])

    def export_transformer(prefix, node):
        _export_norm(sd, f"{prefix}.norm", node["norm"])
        for proj in ("proj_in", "proj_out"):
            # 2-D kernel = SD2.x Linear projection, 4-D = SD1.x 1x1 conv
            (_export_linear if np.asarray(node[proj]["kernel"]).ndim == 2
             else _export_conv)(sd, f"{prefix}.{proj}", node[proj])
        for name, child in node.items():
            if name.startswith("transformer_blocks_"):
                ti = name.split("_")[-1]
                tp = f"{prefix}.transformer_blocks.{ti}"
                for nm in ("norm1", "norm2", "norm3"):
                    _export_norm(sd, f"{tp}.{nm}", child[nm])
                export_attention(f"{tp}.attn1", child["attn1"])
                export_attention(f"{tp}.attn2", child["attn2"])
                _export_linear(sd, f"{tp}.ff.net.0.proj", child["ff"]["net_0_proj"])
                _export_linear(sd, f"{tp}.ff.net.2", child["ff"]["net_2"])

    def export_resnet(prefix, node):
        _export_norm(sd, f"{prefix}.norm1", node["norm1"])
        _export_conv(sd, f"{prefix}.conv1", node["conv1"])
        _export_norm(sd, f"{prefix}.norm2", node["norm2"])
        _export_conv(sd, f"{prefix}.conv2", node["conv2"])
        if "time_emb_proj" in node:
            _export_linear(sd, f"{prefix}.time_emb_proj", node["time_emb_proj"])
        if "conv_shortcut" in node:
            _export_conv(sd, f"{prefix}.conv_shortcut", node["conv_shortcut"])

    for name, node in params.items():
        if name in ("conv_in", "conv_out"):
            _export_conv(sd, name, node)
        elif name == "conv_norm_out":
            _export_norm(sd, name, node)
        elif name.startswith("time_embedding_"):
            _export_linear(sd, f"time_embedding.{name[len('time_embedding_'):]}", node)
        elif name.startswith("add_embedding_"):
            _export_linear(sd, f"add_embedding.{name[len('add_embedding_'):]}", node)
        else:
            tname = _torch_block_name(name)
            if tname is None:
                raise KeyError(f"unrecognized flax UNet module: {name}")
            if "downsamplers" in tname or "upsamplers" in tname:
                _export_conv(sd, tname, node["conv"])
            elif ".resnets." in tname:
                export_resnet(tname, node)
            else:
                export_transformer(tname, node)
    return sd


def flax_to_torch_vae(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of translate_vae (diffusers 0.13 AttentionBlock naming)."""
    sd: Dict[str, np.ndarray] = {}

    def export_resnet(prefix, node):
        _export_norm(sd, f"{prefix}.norm1", node["norm1"])
        _export_conv(sd, f"{prefix}.conv1", node["conv1"])
        _export_norm(sd, f"{prefix}.norm2", node["norm2"])
        _export_conv(sd, f"{prefix}.conv2", node["conv2"])
        if "conv_shortcut" in node:
            _export_conv(sd, f"{prefix}.conv_shortcut", node["conv_shortcut"])

    for coder in ("encoder", "decoder"):
        for name, node in params[coder].items():
            if name in ("conv_in", "conv_out"):
                _export_conv(sd, f"{coder}.{name}", node)
            elif name == "conv_norm_out":
                _export_norm(sd, f"{coder}.{name}", node)
            elif name == "mid_attn":
                p = f"{coder}.mid_block.attentions.0"
                _export_norm(sd, f"{p}.group_norm", node["group_norm"])
                for t, f in (("query", "query"), ("key", "key"), ("value", "value"),
                             ("proj_attn", "proj_attn")):
                    _export_linear(sd, f"{p}.{t}", node[f])
            elif name.startswith("mid_resnets_"):
                export_resnet(f"{coder}.mid_block.resnets.{name.split('_')[-1]}", node)
            elif name.endswith("_downsample"):
                bi = name.split("_")[2]
                _export_conv(sd, f"{coder}.down_blocks.{bi}.downsamplers.0.conv", node)
            elif name.endswith("_upsample"):
                bi = name.split("_")[2]
                _export_conv(sd, f"{coder}.up_blocks.{bi}.upsamplers.0.conv", node)
            else:
                m = re.fullmatch(r"(down|up)_blocks_(\d+)_resnets_(\d+)", name)
                if not m:
                    raise KeyError(f"unrecognized flax VAE module: {coder}.{name}")
                export_resnet(
                    f"{coder}.{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(3)}", node
                )
    for name in ("quant_conv", "post_quant_conv"):
        _export_conv(sd, name, params[name])
    return sd


def flax_to_torch_clip(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of translate_clip_text (transformers CLIPTextModel naming)."""
    sd: Dict[str, np.ndarray] = {}
    sd["text_model.embeddings.token_embedding.weight"] = np.asarray(
        params["token_embedding"]["embedding"]
    )
    sd["text_model.embeddings.position_embedding.weight"] = np.asarray(
        params["position_embedding"]["embedding"]
    )
    _export_linear_plain = _export_linear
    for name, node in params.items():
        if not name.startswith("layers_"):
            continue
        li = name.split("_")[-1]
        p = f"text_model.encoder.layers.{li}"
        for nm in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{nm}.weight"] = np.asarray(node[nm]["scale"])
            sd[f"{p}.{nm}.bias"] = np.asarray(node[nm]["bias"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _export_linear_plain(sd, f"{p}.self_attn.{proj}", node["self_attn"][proj])
        _export_linear_plain(sd, f"{p}.mlp.fc1", node["fc1"])
        _export_linear_plain(sd, f"{p}.mlp.fc2", node["fc2"])
    sd["text_model.final_layer_norm.weight"] = np.asarray(params["final_layer_norm"]["scale"])
    sd["text_model.final_layer_norm.bias"] = np.asarray(params["final_layer_norm"]["bias"])
    if "text_projection" in params:
        # pooled head lives OUTSIDE text_model in the transformers layout
        sd["text_projection.weight"] = np.asarray(params["text_projection"]["kernel"]).T
    return sd


def control_lora_to_torch(
    params: Dict[str, Any], config: ControlLoRAConfig
) -> Dict[str, np.ndarray]:
    """Export our param tree back to the reference's state-dict naming (bin/safetensors
    interchange with the PyTorch ecosystem)."""
    sd: Dict[str, np.ndarray] = {}
    inv_proj = {v: k for k, v in _LORA_PROJ.items()}

    def put_conv(key, node):
        sd[f"{key}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def put_norm(key, node):
        sd[f"{key}.weight"] = np.asarray(node["norm"]["scale"])
        sd[f"{key}.bias"] = np.asarray(node["norm"]["bias"])

    enc = params["encoder"]
    put_conv("conv_in", enc["conv_in"])

    def put_block(prefix, node):
        for name, child in node.items():
            if name.startswith("convnets_"):
                j = name.split("_")[-1]
                put_norm(f"{prefix}.convnets.{j}.norm1", child["norm1"])
                put_conv(f"{prefix}.convnets.{j}.conv1", child["conv1"])
                put_norm(f"{prefix}.convnets.{j}.norm2", child["norm2"])
            elif name == "downsampler":
                put_conv(f"{prefix}.downsamplers.0.conv", child)

    for name, node in enc.items():
        if name.startswith("down_blocks_0_"):
            k = name.split("_")[-1]
            put_block(f"down_blocks.0.{k}", node)
        elif re.fullmatch(r"down_blocks_[1-9]\d*", name):
            i = name.split("_")[-1]
            put_block(f"down_blocks.{i}", node)
        elif name.startswith("pre_lora_layers_"):
            i = name.split("_")[-1]
            put_block(f"pre_lora_layers.{i}", node)

    for i, bucket in enumerate(params["lora_layers"]):
        for j, adapter in enumerate(bucket):
            for proj, pair in adapter.items():
                tname = inv_proj[proj]
                sd[f"lora_layers.{i}.{j}.{tname}.down.weight"] = np.asarray(pair["down"]).T
                sd[f"lora_layers.{i}.{j}.{tname}.up.weight"] = np.asarray(pair["up"]).T
    return sd


# ---------------------------------------------------------------------------- attn procs
# copied from controllora_tpu/utils/torch_compat.py (the DreamBooth-LoRA artifact)


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def attn_procs_to_torch(adapters: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Export {processor_name: AttnAdapter or params tree} to diffusers
    ``unet.save_attn_procs`` naming ('<proc_name>.to_q_lora.down.weight', reference
    train_dreambooth_lora.py:987-994); torch (out, in) layouts, numpy values."""
    sd: Dict[str, np.ndarray] = {}
    inv = {v: k for k, v in _LORA_PROJ.items()}
    for name, adapter in adapters.items():
        params = adapter.params if hasattr(adapter, "params") else adapter
        for proj, pair in params.items():
            sd[f"{name}.{inv[proj]}.down.weight"] = _to_numpy(pair["down"]).T
            sd[f"{name}.{inv[proj]}.up.weight"] = _to_numpy(pair["up"]).T
    return sd


def attn_procs_from_torch(sd: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Import a diffusers attn-procs LoRA state dict -> {processor_name: params tree}
    of numpy arrays in the (in, r) / (r, out) layout (``unet.load_attn_procs``)."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, w in sd.items():
        m = re.fullmatch(r"(.+\.processor)\.(\w+)\.(down|up)\.weight", key)
        if not m:
            raise KeyError(f"unrecognized attn-procs key: {key}")
        name, proj_t, which = m.groups()
        proj = _LORA_PROJ[proj_t]
        out.setdefault(name, {}).setdefault(proj, {})[which] = _to_numpy(w).T
    return out


# ---------------------------------------------------------------------------- state-dict IO
# The card's machine has no ``safetensors`` package: the format is written and read
# here (an 8-byte little-endian header length, a JSON header, the raw little-endian
# bytes), byte for byte as ``safetensors.numpy.save`` writes it.

# the Rust crate's Dtype order: tensors are laid out by descending dtype, then name
_ST_DTYPES = (("BOOL", np.bool_), ("U8", np.uint8), ("I8", np.int8), ("I16", np.int16),
              ("U16", np.uint16), ("F16", np.float16), ("I32", np.int32),
              ("U32", np.uint32), ("F32", np.float32), ("F64", np.float64),
              ("I64", np.int64), ("U64", np.uint64))
_ST_RANK = {np.dtype(t): (i, name) for i, (name, t) in enumerate(_ST_DTYPES)}
_ST_NUMPY = {name: np.dtype(t) for name, t in _ST_DTYPES}


def safetensors_bytes(sd: Dict[str, np.ndarray]) -> bytes:
    """The .safetensors file of a numpy state dict."""
    import json

    arrays = {k: np.ascontiguousarray(v) for k, v in sd.items()}
    order = sorted(arrays, key=lambda k: (-_ST_RANK[arrays[k].dtype][0], k))
    header, offset = {}, 0
    for k in order:
        a = arrays[k]
        header[k] = {"dtype": _ST_RANK[a.dtype][1], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    return (len(text).to_bytes(8, "little") + text
            + b"".join(arrays[k].astype(arrays[k].dtype.newbyteorder("<")).tobytes()
                       for k in order))


def safetensors_load(data: bytes) -> Dict[str, np.ndarray]:
    import json

    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for k, info in header.items():
        begin, end = info["data_offsets"]
        dt = _ST_NUMPY[info["dtype"]].newbyteorder("<")
        out[k] = (np.frombuffer(data[base + begin:base + end], dt)
                  .astype(dt.newbyteorder("=")).reshape(info["shape"]))
    return out


def save_state_dict(sd: Dict[str, Any], path: str) -> None:
    """A state dict (numpy or tensors) to .safetensors, or to a ``torch.save`` .bin."""
    if path.endswith(".safetensors"):
        with open(path, "wb") as f:
            f.write(safetensors_bytes({k: _to_numpy(v) for k, v in sd.items()}))
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(_to_numpy(v)).copy())
                    for k, v in sd.items()}, path)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors or pickled .bin state dict -> numpy arrays."""
    if path.endswith(".safetensors"):
        with open(path, "rb") as f:
            return safetensors_load(f.read())
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}
