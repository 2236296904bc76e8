"""Guided text-to-image pipeline in PyTorch (counterpart of
``controllora_tpu/pipelines/text_to_image.py``).

Order of work: tokenizer -> CLIP -> hint encoder -> ``fold_adapters`` -> a plain
Python loop of CFG UNet evals and scheduler updates -> one batched VAE decode.
While a ``torch.profiler`` records, a call records its host spans
(``utils/spans.py``): ``pipeline.call`` around one ``pipeline.step`` a grid index.
The CFG batch is the block layout [uncond * n || cond * n]; a batch-1 guide's biases
broadcast over it and per-image guides tile to it.

The samplers are the JAX package's five (DPM-Solver++, DDIM, PNDM, Euler, UniPC).
Each keeps its grid after ``set_timesteps(n)`` (``ts``) and offers the same calls,
which the loop makes directly: ``init_state(noise)``, ``model_input(state, i)`` (what
the UNet sees at step i: the sample, or Euler's 1 / sqrt(sigma^2 + 1) rescale),
``step(state, eps, i, first_index=)``, ``get_sample(state)``, and the frame of a
partial trajectory (JAX :280-308): ``noised_init(init, noise, i)``,
``prepare_state(init, noise, start)``, ``wrap_state(latents)`` and
``set_sample(state, x)``. The scheduler holds the grid of the render in progress,
so one pipeline renders one request batch at a time (the serving engine's single
worker). Two serving accelerations are off by default: ``tome_ratio`` (token merging
in the level-0 self-attentions, ``ops/tome.py``) and ``deepcache_interval`` (the deep
UNet levels run every interval-th step; between, a cached deep feature stands in for
them).

The render modes are the JAX pipeline's (its :562-889): text-to-image;
img2img (``image``, ``strength``) and inpaint (``mask``); a window of the trajectory
(``denoising_start``, ``denoising_end``, ``return_latents``: the SDXL base ->
refiner ensemble); extra plain LoRAs (``extra_loras``, ``merge_extra_loras``) and
extra ControlLoRAs (``extra_controls``, ``merge_extra_controls``). Adapter stacks
that fold are folded into the weights; a chain (a LoRA beside a ControlLoRA) runs
threaded through the UNet. ``pipelines/hires.py`` composes two calls.

The public layout is the JAX package's: guides and init images (H, W, 3) or
(n, H, W, 3) in [-1, 1], masks (H, W) in [0, 1], ``latents=`` (n, H/8, W/8, 4),
results HWC uint8 images or float arrays in [-1, 1] with ``return_array=True``.
Inside, tensors are NCHW on ``device``.

Every family of ``models/zoo.py`` renders through the same loop. A text encoder with
a pooled head (SDXL's dual encoder, the refiner's tower) makes ``encode_prompt``
return (context, pooled), and a ``text_time`` UNet then takes the pooled vector and
the size ids of the render (JAX :680-715): 6 ids ``[h, w, 0, 0, h, w]`` (SDXL), or
5 ids ``[h, w, 0, 0, score]`` (the refiner) with ``aesthetic_score`` on the cond
rows and ``negative_aesthetic_score`` on the uncond rows. SD2.1's v-prediction is
the scheduler's: ``DPMSolverMultistepScheduler(DiffusionSchedule.create(
prediction_type="v_prediction"))``.

``mesh=`` (``parallel/mesh.py``; one process per rank) spreads a render over ranks as
the JAX ``shard_map`` paths do (JAX :490-557):
  * 'data': each rank renders its rows of the batch. The initial noise (and
    img2img's) is drawn for the whole batch from the one generator on every rank and
    sliced, so a mesh render equals the 1-process render image for image; per-image
    prompts shard with the latents, a batch-1 guide replicates. The images are
    gathered over the axis, in order, as host objects: every rank returns all of them.
  * 'cfg' (size 2): rank 0 evaluates the uncond context and rank 1 the cond one, on
    the rank's whole batch; guidance is one fp32 SUM all-reduce of eps * w a step, w
    = 1 - g on rank 0 and g on rank 1 (JAX :317-345, 428-435).
  * 'model': the adapters fold at the global level, then the weights and folded
    biases are prepared and sliced for the rank (``parallel/tp.py``) and a
    tensor-parallel UNet runs heads / tp heads with all-reduces in its blocks.
The VAE decode replicates over 'cfg' and 'model'. The refusals are JAX :858-876's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from controllora_tpu_torch.models.clip import DualCLIPTextEncoder
from controllora_tpu_torch.models.lora import (
    AdapterStack,
    AttnAdapter,
    is_foldable,
    map_controls,
)
from controllora_tpu_torch.ops.folding import fold_adapters
from controllora_tpu_torch.ops.tome import ToMeConfig
from controllora_tpu_torch.parallel.tp import (
    tp_prepare_biases,
    tp_prepare_params,
    tp_shard_biases,
    tp_shard_params,
    validate_tp,
)
from controllora_tpu_torch.schedulers import DPMSolverMultistepScheduler
from controllora_tpu_torch.utils import spans
from controllora_tpu_torch.utils.image import resize_linear


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


def merge_extra_controls(stacks: Dict[str, AdapterStack],
                         extra_stacks: Dict[str, AdapterStack],
                         where: str = "post") -> Dict[str, AdapterStack]:
    """Compose a second ControlLoRA's adapters (with their control states) with the
    installed stacks: multi-condition control, e.g. canny and pose driving one render
    (JAX :60-76). Each extra control adapter joins the chain at ``where`` as a
    chained adapter, not a second main, so the reference's chain quirks hold for it
    (its value LoRA applies unscaled, its skip flags are honoured)."""
    extra = {name: s.main for name, s in extra_stacks.items() if s.main is not None}
    return merge_extra_loras(stacks, extra, where)


def draw_noise(generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """The render's Gaussian draws, (n, H/8, W/8, C) fp32 on the CPU: the initial
    latents of a text-to-image render, and img2img's noise. Looked up on the module at
    call time, so that a parity test can substitute the JAX package's draws."""
    return torch.randn(shape, generator=generator)


def latent_mask(mask, lh: int, lw: int) -> torch.Tensor:
    """An (H, W) or (H, W, C) repaint mask in [0, 1] -> the (1, 1, lh, lw) latent mask:
    ``utils/image.py::resize_linear``, which equals ``jax.image.resize(m, (lh, lw),
    "linear")`` (JAX :817-821), clipped to [0, 1]."""
    m = np.asarray(mask, np.float32)
    m = m[..., 0] if m.ndim == 3 else m
    return resize_linear(m[None, :, :, None], lh, lw).permute(0, 3, 1, 2).clamp(0.0, 1.0)


def _cast_controls(adapters: Dict[str, AdapterStack], dtype: torch.dtype
                   ) -> Dict[str, AdapterStack]:
    """A threaded stack with its control states in the UNet's compute dtype (the JAX
    package's bf16 hint encoder hands them over so); the factors stay as they are."""
    return {name: map_controls(s, lambda c: c.to(dtype)) for name, s in adapters.items()}


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
                 scheduler=None, device="cuda", mesh=None):
        """``scheduler``: one of the five samplers (default DPM-Solver++). ``mesh``: a
        ``parallel.Mesh`` over the ranks that render together (every rank builds the
        same pipeline and makes the same calls), or None for one process."""
        self.device = torch.device(device)
        self.unet = unet.to(self.device)
        self.vae = vae.to(self.device)
        self.text_encoder = text_encoder.to(self.device)
        self.control_lora = None if control_lora is None else control_lora.to(self.device)
        self.tokenizer = tokenizer
        self.scheduler = scheduler or DPMSolverMultistepScheduler()
        self.mesh = mesh
        self._cfg_split = mesh is not None and "cfg" in mesh.axis_names
        if self._cfg_split and mesh.size("cfg") != 2:
            raise ValueError(f"the 'cfg' mesh axis carries the [uncond ‖ cond] guidance "
                             f"pair and must have size 2, got {mesh.size('cfg')}")
        self._tp = mesh.size("model") if mesh is not None else 1
        if self._tp > 1:
            from controllora_tpu_torch.models.unet import UNet2DConditionModel

            validate_tp(unet.config, self._tp)
            with torch.device("meta"):
                self._unet_tp = UNet2DConditionModel(unet.config, self._tp,
                                                     mesh.group("model"))
            # the rank's slice of the adapter-free weights; a guided render replaces
            # the folded projections
            self._tp_base = self._tp_slice(self.unet.state_dict())

    def _tp_slice(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return tp_shard_params(tp_prepare_params(params, self._tp), self._tp,
                               self.mesh.coord("model"))

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


    # ------------------------------------------------------------------ image

    @torch.inference_mode()
    def encode_image(self, image) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> scaled init latents (B, 4, H/8, W/8), fp32: the
        posterior mean, with no noise (JAX ``_encode_image`` :198), so img2img's only
        randomness is the sampler noise and strength 0 is the exact VAE round trip."""
        return self.vae.encode(_nhwc_to_nchw(image, self.device)).float()

    # ------------------------------------------------------------------ call

    @spans.traced("pipeline.call")
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
        extra_loras_where: str = "pre",
        extra_controls: Optional[Sequence[Tuple[Any, np.ndarray]]] = None,
        extra_controls_where: str = "post",
        image: Optional[np.ndarray] = None,
        strength: float = 0.8,
        mask: Optional[np.ndarray] = None,
        denoising_start: Optional[float] = None,
        denoising_end: Optional[float] = None,
        return_latents: bool = False,
    ) -> List[np.ndarray]:
        """Returns a list of HWC uint8 images (float arrays in [-1, 1] with
        ``return_array``; (H/8, W/8, 4) latents with ``return_latents``). Without
        ``latents=`` the initial noise is drawn from ``generator`` (a CPU generator;
        default seed 0) through ``draw_noise``.

        ``tome_ratio`` (0 = the exact path): before each self-attention on a grid of
        at least ``tome_min_tokens`` tokens (level 0 at 512²), that fraction of the
        tokens merges into their most similar neighbours and the output unmerges;
        the folded per-position biases (or a threaded stack's control states) merge
        with the same map. 0.5 is tomesd's published setting.

        ``deepcache_interval`` (1 = the exact path): the deep UNet levels run on
        every interval-th executed step only (counted from the first, which is
        always full); the steps between run the level-0 modules around the deep
        feature cached by the last full step. Composes with ``tome_ratio``.

        ``aesthetic_score`` / ``negative_aesthetic_score``: the cond / uncond score
        id of a 5-id ``text_time`` UNet (the refiner); other UNets ignore them.

        ``extra_loras``: {processor name: plain LoRA AttnAdapter} composed with the
        ControlLoRA by ``merge_extra_loras`` at ``extra_loras_where`` ("pre" or
        "post"). ``extra_controls``: (control_lora, guide) pairs, more ControlLoRAs
        driving the same render (multi-condition control); each guide is encoded by
        its own hint encoder and its adapters join every layer's chain at
        ``extra_controls_where`` (``merge_extra_controls``). The port's ControlLoRA
        module carries its own parameters, so a pair stands for the JAX package's
        (control_lora, params, guide) triple. Stacks that fold (a main adapter and
        no chain) fold into the UNet weights; a chain runs threaded, each layer
        evaluating its adapters (long self-attention on K2's flash route instead of
        K1's), with the control states cast to the UNet's compute dtype.

        ``image`` + ``strength``: image-to-image (SDEdit). The init image is encoded
        (``encode_image``), noised to grid point ``N - min(int(N * strength), N)`` in
        the sampler's own frame, and only the remaining steps run. ``mask`` (H, W) in
        [0, 1], 1 = repaint: inpainting; the mask is resized to the latent grid
        (antialiased bilinear, as ``jax.image.resize(..., "linear")``) and after
        every update the known region is re-injected at the noise level of the next
        grid point (the clean init after the last).

        ``denoising_end`` / ``denoising_start``: the base -> refiner ensemble split.
        The base runs grid indices [0, round(N * end)), paired with
        ``return_latents=True``; the refiner continues the same trajectory from
        ``latents=`` at [round(N * start), N) without re-noising. Use the same
        sampler type and step count on both so that the grids line up."""
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
        if image is not None:
            image = np.asarray(image, np.float32)
            image = image[None] if image.ndim == 3 else image
            height = height or image.shape[1]
            width = width or image.shape[2]
        if latents is not None:
            latents = np.asarray(latents.cpu() if torch.is_tensor(latents) else latents,
                                 np.float32)
            latents = latents if latents.ndim == 4 else latents[None]
            height = height or latents.shape[1] * 8
            width = width or latents.shape[2] * 8
        height, width = height or 512, width or 512
        lh, lw = height // 8, width // 8
        c_in = self.unet.config.in_channels
        mesh = self.mesh
        if mesh is not None and not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the serving mesh {mesh}")

        # the trajectory window [start, end) of the grid (JAX :735-764)
        steps = num_inference_steps
        if mask is not None and image is None:
            raise ValueError("mask (inpainting) requires an init image")
        if image is not None and latents is not None:
            raise ValueError("image and latents are mutually exclusive: img2img derives "
                             "its start latents from the encoded init image")
        start = 0
        if image is not None:
            s = float(min(max(strength, 0.0), 1.0))
            start = steps - min(int(steps * s), steps)
        if denoising_start is not None:
            if image is not None:
                raise ValueError("denoising_start (latent trajectory continuation) and "
                                 "image (img2img re-noising) are mutually exclusive")
            if latents is None:
                raise ValueError("denoising_start continues a partial trajectory: pass "
                                 "the base pipeline's return_latents output as latents=")
            start = int(round(steps * float(denoising_start)))
        end = steps
        if denoising_end is not None:
            end = int(round(steps * float(denoising_end)))
            if not start < end <= steps:
                raise ValueError(f"denoising window [{start}, {end}) is empty or out of "
                                 f"range for {steps} steps")

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = init = paint = None
        if image is not None:
            init = self.encode_image(image)
            n = num_images
            if init.shape[0] == 1 and n > 1:
                init = init.repeat(n, 1, 1, 1)
            elif init.shape[0] != n and num_images != 1:
                raise ValueError(f"init image batch {init.shape[0]} conflicts with "
                                 f"num_images={num_images}")
            n = init.shape[0]
            noise = _nhwc_to_nchw(draw_noise(generator, (n, lh, lw, c_in)), self.device)
            if mask is not None:
                paint = latent_mask(mask, lh, lw).to(self.device)
        elif latents is not None:
            n = latents.shape[0]
            if num_images not in (1, n):
                raise ValueError(f"explicit latents provide the batch ({n} image(s)); "
                                 f"num_images={num_images} conflicts")
            lat = _nhwc_to_nchw(latents, self.device)
        else:
            n = num_images
            lat = _nhwc_to_nchw(draw_noise(generator, (n, lh, lw, c_in)), self.device)

        encoded = self.encode_prompt(prompt, negative_prompt)
        ctx, pooled = encoded if isinstance(encoded, tuple) else (encoded, None)
        per_image = isinstance(prompt, (list, tuple))
        if per_image and ctx.shape[1] != n:
            raise ValueError(f"{ctx.shape[1]} per-image prompts for a batch of {n}")
        ids = None
        if self.unet.config.addition_embed_type == "text_time":
            ids = self.text_time_ids(pooled, height, width, aesthetic_score,
                                     negative_aesthetic_score)

        def control_adapters(control_lora, g, what):
            g = np.asarray(g, np.float32)
            g = g[None] if g.ndim == 3 else g
            if g.shape[0] not in (1, n):
                raise ValueError(f"{what} batch {g.shape[0]} must be 1 (shared) or match "
                                 f"the image batch {n} (per-image guides)")
            return control_lora.adapters_for(_nhwc_to_nchw(g, self.device), self.unet.config)

        adapters = {}
        if guide is not None and self.control_lora is not None:
            adapters = control_adapters(self.control_lora, guide, "guide")
        if extra_loras:
            adapters = merge_extra_loras(adapters, extra_loras, extra_loras_where)
        for control_lora, g in extra_controls or ():
            adapters = merge_extra_controls(
                adapters, control_adapters(control_lora.to(self.device), g,
                                           "extra_controls guide"),
                extra_controls_where)
        foldable = bool(adapters) and is_foldable(adapters)
        tp = self._tp
        if mesh is not None:
            n_dev = mesh.size("data")
            if n % n_dev:
                raise ValueError(f"data-parallel serving shards the image batch over "
                                 f"{n_dev} devices; num_images={n} must be a multiple of "
                                 "the mesh size")
            if guide is not None and guide.shape[0] != 1:
                raise ValueError("data-parallel serving supports a single (replicated) "
                                 f"guide; got guide batch {guide.shape[0]}")
            if tp > 1 and adapters and not foldable:
                raise ValueError(
                    "tensor-parallel serving (mesh 'model' axis) folds adapters into the "
                    "sharded kernels; pre/post adapter chains (mix / multi-control "
                    "composition) cannot fold — serve those on a ('data', 'cfg') mesh "
                    "instead")
            # this rank's rows of the batch: the draws above were made for all of it
            rows = mesh.rows(n)
            n = rows.stop - rows.start
            if init is not None:
                init, noise = init[rows], noise[rows]
            else:
                lat = lat[rows]
            if per_image:
                ctx = ctx[:, rows]
                pooled = None if pooled is None else pooled[:, rows]
        w_cfg = None
        if self._cfg_split:
            # one guidance branch on the rank's whole batch: uncond on 0, cond on 1
            c = mesh.coord("cfg")
            w_cfg = 1.0 - guidance_scale if c == 0 else guidance_scale

            def branch(pair, per):
                return pair[c] if per else pair[c][None].expand((n,) + pair.shape[1:])

            ctx_n = branch(ctx, per_image)
            added = {} if ids is None else dict(added_text_embeds=branch(pooled, per_image),
                                                added_time_ids=branch(ids, False))
        else:
            ctx_n = _cfg_batch(ctx, n, per_image)
            added = {} if ids is None else dict(
                added_text_embeds=_cfg_batch(pooled, n, per_image),
                added_time_ids=_cfg_batch(ids, n, False))

        dtype = self.unet.conv_in.weight.dtype
        weights, unet_kw = {}, {}
        unet = self.unet
        if foldable:
            weights, biases = fold_adapters(self.unet, adapters, lora_scale)
            if tp > 1:
                biases = tp_shard_biases(tp_prepare_biases(biases, tp), tp,
                                         mesh.coord("model"))
            # cast once: every step adds them in the UNet's compute dtype
            unet_kw["biases"] = {k: b.to(dtype) for k, b in biases.items()}
        elif adapters:
            unet_kw.update(adapters=_cast_controls(adapters, dtype), lora_scale=lora_scale)
        if tp > 1:
            # folded at the global level, then prepared and sliced like the base
            unet, weights = self._unet_tp, dict(self._tp_base, **self._tp_slice(weights))

        sch = self.scheduler
        sch.set_timesteps(steps)
        if init is not None:
            state = sch.prepare_state(init, noise, start)
        elif denoising_start is not None:
            state = sch.wrap_state(lat)
        else:
            state = sch.init_state(lat)
        # DeepCache: the first executed step is a full eval, so the cache is set
        # before any shallow step reads it (the JAX loop's zeros are only the initial
        # lax.cond carry)
        cache = None
        for i in range(start, end):
            with spans.span("pipeline.step", index=i):
                x = sch.model_input(state, i)
                t_i = sch.ts[i]
                kw = dict(added, **unet_kw)
                if tome is not None:
                    kw.update(tome=tome, tome_step=(0, t_i, i))
                x_in = x if w_cfg is not None else torch.cat([x, x])
                args = (x_in, torch.full((x_in.shape[0],), float(t_i), dtype=torch.float32,
                                         device=self.device), ctx_n)
                if deepcache_interval == 1:
                    eps = functional_call(unet, weights, args, kw)
                elif (i - start) % deepcache_interval == 0:
                    eps, cache = functional_call(unet, weights, args,
                                                 dict(kw, deepcache="full"))
                else:
                    eps = functional_call(unet, weights, args,
                                          dict(kw, deepcache="shallow", deepcache_feat=cache))
                if w_cfg is not None:
                    # (1 - g) eps_u + g eps_c: one all-reduce of the ranks' weighted branch
                    eps_g = mesh.all_reduce(eps * w_cfg, "cfg")
                else:
                    eps_u, eps_c = eps.chunk(2)
                    eps_g = eps_u + guidance_scale * (eps_c - eps_u)
                state = sch.step(state, eps_g, i, first_index=start)
                if paint is not None:
                    # re-inject the known region at the noise level of grid point i + 1
                    known = sch.noised_init(init, noise, i + 1)
                    state = sch.set_sample(state, paint * sch.get_sample(state)
                                           + (1.0 - paint) * known)

        sample = sch.get_sample(state)
        if return_latents:
            out = sample.float().permute(0, 2, 3, 1).cpu().numpy()
        else:
            out = self.vae.decode(sample).float().permute(0, 2, 3, 1).cpu().numpy()
        if mesh is not None:
            # every rank's rows, in order (the decode replicates over cfg and model)
            out = np.concatenate(mesh.all_gather_object(out, "data"))
        if return_latents or return_array:
            return list(out)
        return [np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8) for x in out]
