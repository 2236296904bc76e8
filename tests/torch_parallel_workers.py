"""Rank processes for the port's multi-process CPU tests (``tests/test_torch_parallel_*``).

``Ranks`` starts one interpreter per rank running this file; the ranks meet over
gloo through a ``file://`` store under the test's temporary directory (no port, so
concurrent test workers never collide) and run one job: a pickle holding the kind of
job and its inputs (state dicts, batches, draws), written by the test process. Each
rank writes its results to ``rank<r>.pkl`` beside it. This file imports torch and the
port only, never the JAX package.
"""

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    """``world`` rank processes running one job (pickled into ``job_dir``);
    ``results`` waits for them."""

    def __init__(self, world: int, job_dir: str, job: dict):
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        self.world, self.job_dir = world, job_dir
        store = os.path.join(job_dir, "store")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), job_dir,
             f"file://{store}"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, timeout: float = 240.0) -> list:
        """Each rank's result. A rank that fails (or outlasts ``timeout``) fails the
        call with its output; the others are killed."""
        procs, deadline = self.procs, time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs = [p.communicate()[0] for p in procs]
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError("\n".join(f"rank {r} exited {procs[r].returncode}:\n"
                                           f"{outs[r][-4000:]}" for r in bad))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.job_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------- in a rank


def build_stack(blob, variant):
    """The smoke stack and ControlLoRA of ``blob[variant]`` (state dicts and the
    port's ControlLoRA config), fp32 on the CPU."""
    import torch

    from controllora_tpu_torch.models import zoo

    unet, vae, text = zoo.build_models(variant, torch.float32, "cpu")
    for module, key in ((unet, "unet"), (vae, "vae"), (text, "text")):
        module.load_state_dict(blob[variant][key])
    control = zoo.build_control_lora(blob[variant]["control_cfg"], "cpu")
    control.load_state_dict(blob[variant]["control"])
    return unet, vae, text, control


def render_job(rank, job):
    """Every mesh case on every rank (each rank builds every mesh, as it must); the
    members render. Then a BatchingEngine over ``serve.MeshLeader`` on rank 0 with the
    others following, and ``sample.main`` under ``--serving_mesh``."""
    import numpy as np
    import torch

    from controllora_tpu_torch.data.tokenizer import HashTokenizer
    from controllora_tpu_torch.parallel import make_serving_mesh
    from controllora_tpu_torch.pipelines import StableDiffusionControlLoRAPipeline

    stacks, pipes, out = {}, {}, {}
    for case in job["cases"]:
        mesh = make_serving_mesh(range(case["world"]), cfg=case["cfg"], model=case["model"])
        if not mesh.member:
            continue
        variant = case["variant"]
        if variant not in stacks:
            stacks[variant] = build_stack(job["stacks"], variant)
        unet, vae, text, control = stacks[variant]
        pipe = StableDiffusionControlLoRAPipeline(unet, vae, text, HashTokenizer(), control,
                                                  device="cpu", mesh=mesh)
        images = pipe(case["prompt"], generator=torch.Generator().manual_seed(case["seed"]),
                      **case["kw"])
        out[case["name"]] = dict(images=np.stack(images), coords=mesh.coords)
        pipes[case["name"]] = pipe

    serve = job.get("serve")
    if serve:
        from controllora_tpu_torch import serve as serve_cli
        from controllora_tpu_torch.serving import BatchingEngine

        pipe = pipes[serve["case"]]
        if rank == 0:
            engine = BatchingEngine(serve_cli.MeshLeader(pipe), max_wait_ms=2000,
                                    buckets=(1, 2))
            futures = [engine.submit(p, **serve["kw"], seed=s)
                       for p, s in zip(serve["prompts"], serve["seeds"])]
            out["serve"] = dict(images=[f.result(timeout=120) for f in futures],
                                stats=dict(engine.stats))
            engine.stop()
            engine.pipe.stop()
        else:
            out["serve_calls"] = serve_cli.follow(pipe)

    if job.get("sample_argv"):
        from controllora_tpu_torch import sample

        sample.main([a.format(rank=rank) for a in job["sample_argv"]])
    return out


def train_job(rank, job):
    """A dp step of the ControlLoRA trainer and of the DreamBooth trainer on this
    rank's rows with the global draws injected, then ``train.main`` and
    ``train_dreambooth.main`` on the ranks."""
    import numpy as np
    import torch

    from controllora_tpu_torch.models import lora as tlora
    from controllora_tpu_torch.parallel import make_mesh, shard_batch
    from controllora_tpu_torch.training.dreambooth import DreamBoothLoRATrainer
    from controllora_tpu_torch.training.trainer import (
        ControlLoRATrainer,
        make_optimizer,
        to_device_batch,
    )

    mesh = make_mesh()
    unet, vae, text, control = build_stack(job["stacks"], "smoke")
    out = {"coords": mesh.coords}
    with torch.enable_grad():
        trainer = ControlLoRATrainer(control, unet, vae, text, remat_unet=False, mesh=mesh,
                                     optimizer=make_optimizer(control.parameters()))
        step = trainer.train_step(to_device_batch(shard_batch(job["batch"], mesh), "cpu"),
                                  return_grads=True, **job["draws"])
        out["control"] = dict(
            loss=step["loss"].item(),
            grads={n: g.clone() for (n, _), g in zip(control.named_parameters(),
                                                     step["grads"])},
            params={k: v.clone() for k, v in control.state_dict().items()})

        loras = {name: tlora.AttnAdapter(params={p: {w: t.clone() for w, t in pair.items()}
                                                 for p, pair in tree.items()},
                                         spec=tlora.AdapterSpec(kind="lora"))
                 for name, tree in job["loras"].items()}
        db = DreamBoothLoRATrainer(unet, vae, text, loras=loras, remat_unet=False,
                                   with_prior_preservation=True, prior_loss_weight=0.7,
                                   mesh=mesh)
        db.optimizer = make_optimizer(db.params)
        raw = shard_batch(job["db_batch"], mesh)  # this rank's instance and class rows
        batch = {k: np.concatenate([raw[k], raw[f"class_{k}"]])
                 for k in ("pixel_values", "input_ids")}
        step = db.train_step(to_device_batch(batch, "cpu"), return_grads=True,
                             **job["db_draws"])
        out["dreambooth"] = dict(loss=step["loss"].item(),
                                 grads=[g.clone() for g in step["grads"]],
                                 params=[p.detach().clone() for p in db.params])

    if job.get("train_argv"):
        from controllora_tpu_torch import train, train_dreambooth

        train.main(job["train_argv"])
        train_dreambooth.main(job["db_argv"])
    return out


def main(rank: int, world: int, job_dir: str, init: str) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    from controllora_tpu_torch.parallel.distributed import maybe_initialize_distributed

    assert maybe_initialize_distributed("gloo", init)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    out = {"render": render_job, "train": train_job}[job["kind"]](rank, job)
    with open(os.path.join(job_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
