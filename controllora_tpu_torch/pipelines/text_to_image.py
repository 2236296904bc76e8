"""Guided text-to-image pipeline in PyTorch (counterpart of
``controllora_tpu/pipelines/text_to_image.py``).

Order of work: tokenizer -> CLIP -> hint encoder -> ``fold_adapters`` -> a plain
Python loop of CFG UNet evals and scheduler updates -> one batched VAE decode.
The CFG batch is the block layout [uncond * n || cond * n]; a batch-1 guide's biases
broadcast over it and per-image guides tile to it.

The samplers are the JAX package's five (DPM-Solver++, DDIM, PNDM, Euler, UniPC).
Each keeps its grid after ``set_timesteps(n)`` (``ts``) and offers the same four
calls, which the loop makes directly: ``init_state(noise)``, ``model_input(state,
i)`` (what the UNet sees at step i: the sample, or Euler's 1 / sqrt(sigma^2 + 1)
rescale), ``step(state, eps, i)`` and ``get_sample(state)``. The scheduler holds the
grid of the render in progress, so one pipeline renders one request batch at a time
(the serving engine's single worker). Two serving accelerations are off by default:
``tome_ratio`` (token merging in the level-0 self-attentions, ``ops/tome.py``) and
``deepcache_interval`` (the deep UNet levels run every interval-th step; between,
a cached deep feature stands in for them).

The public layout is the JAX package's: guides (H, W, 3) or (n, H, W, 3) in [-1, 1],
``latents=`` (n, H/8, W/8, 4), results HWC uint8 images or float arrays in [-1, 1]
with ``return_array=True``. Inside, tensors are NCHW on ``device``.

Every family of ``models/zoo.py`` renders through the same loop. A text encoder with
a pooled head (SDXL's dual encoder, the refiner's tower) makes ``encode_prompt``
return (context, pooled), and a ``text_time`` UNet then takes the pooled vector and
the size ids of the render (JAX :680-715): 6 ids ``[h, w, 0, 0, h, w]`` (SDXL), or
5 ids ``[h, w, 0, 0, score]`` (the refiner) with ``aesthetic_score`` on the cond
rows and ``negative_aesthetic_score`` on the uncond rows. SD2.1's v-prediction is
the scheduler's: ``DPMSolverMultistepScheduler(DiffusionSchedule.create(
prediction_type="v_prediction"))``.
Extra plain LoRAs (``extra_loras=``, ``merge_extra_loras``) render where they fold:
as the main adapters of a stack without a ControlLoRA (DreamBooth validation).
Not ported yet: img2img, inpaint and ``denoising_start``/``denoising_end`` (so the
SDXL base -> refiner ensemble), ``hires``, extra controls, threaded (unfoldable)
adapter stacks such as a LoRA chained beside a ControlLoRA, and meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from controllora_tpu_torch.models.clip import DualCLIPTextEncoder
from controllora_tpu_torch.models.lora import AdapterStack, AttnAdapter, is_foldable
from controllora_tpu_torch.ops.folding import fold_adapters
from controllora_tpu_torch.ops.tome import ToMeConfig
from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler


def merge_extra_loras(stacks: Dict[str, AdapterStack], extra: Dict[str, AttnAdapter],
                      where: str = "pre") -> Dict[str, AdapterStack]:
    """Compose plain LoRA adapters with installed ControlLoRA stacks (reference
    mix_lora_and_control_lora.py:114-121: DreamBooth LoRAs become the pre_loras /
    post_loras of each control processor); where a layer has no stack, the LoRA is
    its main adapter."""
    out = dict(stacks)
    for name, adapter in extra.items():
        stack = out.get(name)
        if stack is None:
            stack = AdapterStack(main=adapter)
        elif where == "pre":
            stack = dataclasses.replace(stack, pre=stack.pre + (adapter,))
        else:
            stack = dataclasses.replace(stack, post=stack.post + (adapter,))
        out[name] = stack
    return out


def _nhwc_to_nchw(x, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x)
    return t.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()


def _cfg_batch(pair: torch.Tensor, n: int, per_image: bool) -> torch.Tensor:
    """An [uncond || cond] pair, (2, ...), or per-image pairs, (2, n, ...), as the
    block CFG batch [u1..un || c1..cn], (2n, ...)."""
    if per_image:
        return pair.reshape((-1,) + pair.shape[2:])
    return torch.cat([pair[:1].expand((n,) + pair.shape[1:]),
                      pair[1:].expand((n,) + pair.shape[1:])])


class StableDiffusionControlLoRAPipeline:
    def __init__(self, unet, vae, text_encoder, tokenizer, control_lora=None,
                 scheduler=None, device="cuda"):
        """``scheduler``: one of the five samplers (default DPM-Solver++)."""
        self.device = torch.device(device)
        self.unet = unet.to(self.device)
        self.vae = vae.to(self.device)
        self.text_encoder = text_encoder.to(self.device)
        self.control_lora = None if control_lora is None else control_lora.to(self.device)
        self.tokenizer = tokenizer
        self.scheduler = scheduler or DPMSolverMultistepScheduler()

    # ------------------------------------------------------------------ text

    @torch.inference_mode()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      negative_prompt: Union[str, Sequence[str]] = ""
                      ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """-> (2, 77, hidden) [uncond || cond] context; for a LIST of n prompts,
        (2, n, 77, hidden) with the uncond row block first (image-major on axis 1).
        ``negative_prompt`` may be a matching list or one string for all images.
        An encoder with a pooled head returns (context, pooled), pooled (2, d) or
        (2, n, d). SDXL's tower 2 reads ids padded with 0 (its tokenizer_2's pad)."""
        per_image = None
        if isinstance(prompt, (list, tuple)):
            prompts = list(prompt)
            negs = (list(negative_prompt) if isinstance(negative_prompt, (list, tuple))
                    else [negative_prompt] * len(prompts))
            if len(negs) != len(prompts):
                raise ValueError(f"{len(prompts)} prompts but {len(negs)} negative prompts")
            texts = negs + prompts
            per_image = len(prompts)
        elif isinstance(negative_prompt, (list, tuple)):
            raise ValueError("list negative_prompt requires a list prompt")
        else:
            texts = [negative_prompt, prompt]
        def tensor(ids):
            return torch.as_tensor(ids, dtype=torch.long, device=self.device)

        ids = tensor(self.tokenizer(texts))
        if isinstance(self.text_encoder, DualCLIPTextEncoder):
            enc = self.text_encoder(ids, tensor(self.tokenizer(texts, pad_id=0)))
        else:
            enc = self.text_encoder(ids)
        if per_image is None:
            return enc
        if isinstance(enc, tuple):
            return tuple(e.reshape((2, per_image) + e.shape[1:]) for e in enc)
        return enc.reshape((2, per_image) + enc.shape[1:])

    def text_time_ids(self, pooled: Optional[torch.Tensor], height: int, width: int,
                      aesthetic_score: float, negative_aesthetic_score: float
                      ) -> torch.Tensor:
        """The (2, n_ids) [uncond || cond] size ids of a ``text_time`` UNet; their
        count follows the conditioning width: 6 for SDXL (original == target == the
        render's size, no crop), 5 for the refiner (with the aesthetic scores)."""
        if pooled is None:
            raise ValueError("this UNet needs text_time micro-conditioning; build the "
                             "stack with a pooled-projection text encoder "
                             "(zoo.build_models('sdxl' | 'sdxl-refiner'))")
        cfg = self.unet.config
        n_ids = ((cfg.projection_class_embeddings_input_dim - pooled.shape[-1])
                 // cfg.addition_time_embed_dim)
        if n_ids == 5:
            ids = [[height, width, 0, 0, negative_aesthetic_score],
                   [height, width, 0, 0, aesthetic_score]]
        else:
            ids = [[height, width, 0, 0, height, width]] * 2
        return torch.tensor(ids, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ call

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        guide: Optional[np.ndarray] = None,
        negative_prompt: Union[str, Sequence[str]] = "",
        num_inference_steps: int = 20,
        guidance_scale: float = 9.0,
        num_images: int = 1,
        height: Optional[int] = None,
        width: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        lora_scale: float = 1.0,
        latents=None,
        return_array: bool = False,
        tome_ratio: float = 0.0,
        tome_min_tokens: int = 4096,
        deepcache_interval: int = 1,
        aesthetic_score: float = 6.0,
        negative_aesthetic_score: float = 2.5,
        extra_loras: Optional[Dict[str, AttnAdapter]] = None,
    ) -> List[np.ndarray]:
        """Returns a list of HWC uint8 images (float arrays in [-1, 1] with
        ``return_array``). Without ``latents=`` the initial noise is drawn from
        ``generator`` (a CPU generator; default seed 0).

        ``tome_ratio`` (0 = the exact path): before each self-attention on a grid of
        at least ``tome_min_tokens`` tokens (level 0 at 512²), that fraction of the
        tokens merges into their most similar neighbours and the output unmerges;
        the folded per-position biases merge with the same map. 0.5 is tomesd's
        published setting.

        ``deepcache_interval`` (1 = the exact path): the deep UNet levels run on
        every interval-th step only (``i % interval == 0``, so step 0 always); the
        steps between run the level-0 modules around the deep feature cached by the
        last full step. Composes with ``tome_ratio``.

        ``aesthetic_score`` / ``negative_aesthetic_score``: the cond / uncond score
        id of a 5-id ``text_time`` UNet (the refiner); other UNets ignore them.

        ``extra_loras``: {processor name: plain LoRA AttnAdapter} composed with the
        ControlLoRA by ``merge_extra_loras``. Without a guide they are the stacks'
        main adapters and fold (a DreamBooth LoRA's render); beside a ControlLoRA
        they form a chain, which does not fold and is refused."""
        tome = None
        if tome_ratio:
            if not 0.0 < tome_ratio <= 0.75:
                raise ValueError(f"tome_ratio must be in (0, 0.75] (max merge = the 3/4 "
                                 f"src fraction of the 2x2 dst grid), got {tome_ratio}")
            tome = ToMeConfig(ratio=float(tome_ratio), min_tokens=int(tome_min_tokens))
        deepcache_interval = int(deepcache_interval)
        if deepcache_interval < 1:
            raise ValueError(f"deepcache_interval must be >= 1 (1 = exact path), "
                             f"got {deepcache_interval}")
        if isinstance(prompt, (list, tuple)):
            if num_images not in (1, len(prompt)):
                raise ValueError(f"{len(prompt)} per-image prompts conflict with "
                                 f"num_images={num_images}")
            num_images = len(prompt)
        if guide is not None:
            guide = np.asarray(guide, np.float32)
            guide = guide[None] if guide.ndim == 3 else guide
            height = height or guide.shape[1]
            width = width or guide.shape[2]
        if latents is not None:
            latents = np.asarray(latents.cpu() if torch.is_tensor(latents) else latents,
                                 np.float32)
            latents = latents if latents.ndim == 4 else latents[None]
            height = height or latents.shape[1] * 8
            width = width or latents.shape[2] * 8
        height, width = height or 512, width or 512
        lh, lw = height // 8, width // 8
        c_in = self.unet.config.in_channels

        if latents is not None:
            n = latents.shape[0]
            if num_images not in (1, n):
                raise ValueError(f"explicit latents provide the batch ({n} image(s)); "
                                 f"num_images={num_images} conflicts")
            lat = _nhwc_to_nchw(latents, self.device)
        else:
            n = num_images
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            noise = torch.randn((n, lh, lw, c_in), generator=generator)
            lat = _nhwc_to_nchw(noise, self.device)

        encoded = self.encode_prompt(prompt, negative_prompt)
        ctx, pooled = encoded if isinstance(encoded, tuple) else (encoded, None)
        per_image = isinstance(prompt, (list, tuple))
        if per_image and ctx.shape[1] != n:
            raise ValueError(f"{ctx.shape[1]} per-image prompts for a batch of {n}")
        ctx_n = _cfg_batch(ctx, n, per_image)
        added = {}
        if self.unet.config.addition_embed_type == "text_time":
            ids = self.text_time_ids(pooled, height, width, aesthetic_score,
                                     negative_aesthetic_score)
            added = dict(added_text_embeds=_cfg_batch(pooled, n, per_image),
                         added_time_ids=_cfg_batch(ids, n, False))

        weights, biases, adapters = {}, None, {}
        if guide is not None and self.control_lora is not None:
            if guide.shape[0] not in (1, n):
                raise ValueError(f"guide batch {guide.shape[0]} must be 1 (shared) or "
                                 f"match the image batch {n} (per-image guides)")
            g = _nhwc_to_nchw(guide, self.device)
            adapters = self.control_lora.adapters_for(g, self.unet.config)
        if extra_loras:
            adapters = merge_extra_loras(adapters, extra_loras)
        if adapters:
            if not is_foldable(adapters):
                raise ValueError("only foldable adapter stacks are served by the port: a "
                                 "LoRA chained beside a ControlLoRA (pre/post) needs the "
                                 "threaded serving path, ROADMAP Queue 1 item 11.3")
            weights, biases = fold_adapters(self.unet, adapters, lora_scale)
            # cast once: every step adds them in the UNet's compute dtype
            dtype = self.unet.conv_in.weight.dtype
            biases = {k: b.to(dtype) for k, b in biases.items()}

        sch = self.scheduler
        sch.set_timesteps(num_inference_steps)
        state = sch.init_state(lat)
        # DeepCache: step 0 is a full eval, so the cache is set before any shallow
        # step reads it (the JAX loop's zeros are only the initial lax.cond carry)
        cache = None
        for i in range(num_inference_steps):
            x = sch.model_input(state, i)
            t_i = sch.ts[i]
            kw = dict(added, biases=biases)
            if tome is not None:
                kw.update(tome=tome, tome_step=(0, t_i, i))
            args = (torch.cat([x, x]),
                    torch.full((2 * n,), float(t_i), dtype=torch.float32, device=self.device),
                    ctx_n)
            if deepcache_interval == 1:
                eps = functional_call(self.unet, weights, args, kw)
            elif i % deepcache_interval == 0:
                eps, cache = functional_call(self.unet, weights, args,
                                             dict(kw, deepcache="full"))
            else:
                eps = functional_call(self.unet, weights, args,
                                      dict(kw, deepcache="shallow", deepcache_feat=cache))
            eps_u, eps_c = eps.chunk(2)
            state = sch.step(state, eps_u + guidance_scale * (eps_c - eps_u), i)

        img = (self.vae.decode(sch.get_sample(state)).float().permute(0, 2, 3, 1)
               .cpu().numpy())
        if return_array:
            return [img[i] for i in range(n)]
        return [np.clip((img[i] + 1.0) * 127.5, 0, 255).astype(np.uint8) for i in range(n)]
