"""VAE latent caching (counterpart of ``controllora_tpu/data/latent_cache.py``):
encode the dataset's images once and drop the per-step VAE encode.

``LatentCachedDataset`` runs the port's ``AutoencoderKL.encode_moments`` over the
dataset in batches, keeps the posterior (mean, logvar) in fp16 host memory, and
serves them in place of ``pixel_values``; the trainer samples
z = mean + std * noise afresh each step, the same training distribution as an
encode every step. The cache file is ``np.savez(path, mean=, logvar=)`` with the
moments in the JAX package's NHWC layout, so a file written by either package is
read by the other. Only datasets whose ``__getitem__`` is a pure function of the
index (``DatasetBase.deterministic``) can be cached.
"""

from __future__ import annotations

import sys
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from controllora_tpu_torch.data.registry import DatasetBase


class LatentCachedDataset(DatasetBase):
    """Wraps a deterministic dataset, replacing pixel_values with cached VAE
    posterior moments (latent_mean, latent_logvar), NHWC fp32 per item."""

    def __init__(self, dataset: DatasetBase, vae, batch_size: int = 16,
                 cache_path: Optional[str] = None, verbose: bool = True):
        if not getattr(dataset, "deterministic", True):
            raise ValueError(
                f"latent caching requires a deterministic dataset; "
                f"{type(dataset).__name__} regenerates samples per access"
            )
        self.dataset = dataset
        self.tokenizer = getattr(dataset, "tokenizer", None)
        if cache_path is not None:
            try:
                z = np.load(cache_path)
                self.mean, self.logvar = z["mean"], z["logvar"]
                if len(self.mean) == len(dataset):
                    if verbose:
                        print(f"latent cache: loaded {cache_path}", file=sys.stderr)
                    return
                print("latent cache: size mismatch; rebuilding", file=sys.stderr)
            except FileNotFoundError:
                pass
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                # a truncated npz or one without mean/logvar is rebuilt
                print(f"latent cache: unreadable ({e!r}); rebuilding", file=sys.stderr)
        self._build(vae, batch_size, verbose)
        if cache_path is not None:
            np.savez(cache_path, mean=self.mean, logvar=self.logvar)
            if verbose:
                print(f"latent cache: saved {cache_path}", file=sys.stderr)

    @torch.no_grad()
    def _build(self, vae, batch_size: int, verbose: bool):
        device = vae.quant_conv.weight.device
        n = len(self.dataset)
        means, logvars = [], []
        t0 = time.time()
        for s in range(0, n, batch_size):
            px = np.stack([self.dataset[i]["pixel_values"]
                           for i in range(s, min(s + batch_size, n))])
            x = torch.from_numpy(px).permute(0, 3, 1, 2).to(device)
            m, lv = vae.encode_moments(x)
            means.append(m.permute(0, 2, 3, 1).float().cpu().numpy().astype(np.float16))
            logvars.append(lv.permute(0, 2, 3, 1).float().cpu().numpy().astype(np.float16))
            if verbose and s and s % (batch_size * 50) == 0:
                rate = (s + batch_size) / (time.time() - t0)
                print(f"latent cache: {s}/{n} ({rate:.0f} img/s)", file=sys.stderr)
        self.mean = np.concatenate(means)
        self.logvar = np.concatenate(logvars)
        if verbose:
            print(f"latent cache: {n} samples in {time.time() - t0:.1f}s "
                  f"({self.mean.nbytes * 2 / 1e9:.2f} GB fp16)", file=sys.stderr)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.dataset[idx]
        return {
            "latent_mean": self.mean[idx].astype(np.float32),
            "latent_logvar": self.logvar[idx].astype(np.float32),
            "guide_values": item["guide_values"],
            "input_ids": item["input_ids"],
        }

    def control_channel(self) -> int:
        return self.dataset.control_channel()
