"""Training launcher: mesh + sharded state + train loop.

Counterpart of the JAX package's ``launch/train.py``, with its flags and
``--model-axis``.  One process a rank: a coordinator (``REPRO_COORD_ADDR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``, read by
``launch.cluster.maybe_init_distributed``) brings up a
``torch.distributed`` process group, ``nccl`` on the card and ``gloo`` on
the CPU; a process group the caller has already started is used as it
is and left up; without either the launcher runs alone.

The ranks form a ("data", "model") mesh of (world / model, model), or
with ``--multi-pod`` a ("pod", "data", "model") mesh of (2, world /
(2 model), model).  The params are initialised whole from the seed, as
at world size 1, and each rank keeps its shard of every leaf by
``param_specs`` (``train.parallel.shard_params``): the d_model
dimensions over "data" (FSDP; the AdamW moments mirror the shards, so
ZeRO), heads, d_ff, experts and the vocabulary over "model", each pod a
replica of the layout (HSDP).  Each rank takes its rows of the batch by
``array_batch_specs`` (over ("pod", "data"): the model ranks of one data
group take the same rows).  The step (``make_train_step`` with the
``train.parallel.Layout``) gathers each layer over "data" before use,
splits the compute over "model" wherever the storage is split (the
vocabulary and its log-softmax, heads, d_ff, experts, SSM heads),
reduces the gradients and clips by the whole gradient's norm, so it
equals the one-process step on the whole batch; at world size 1 every
axis has size 1 and it is ``make_train_step``'s bit for bit.  A model
axis that ``param_specs`` cannot honour (a leaf it would keep whole
there, so computed whole on every rank) is refused, naming the leaf.  ``--checkpoint`` gathers the whole
leaves and rank 0 writes them in the format ``load_checkpoint`` reads
(the JAX package's too): a sharded run's checkpoint loads into a
one-rank run.

Usage:
  python -m repro_torch.launch.train --arch yi-9b --smoke --steps 10 \\
      --device cpu
  REPRO_COORD_ADDR=localhost:29500 REPRO_NUM_PROCESSES=4 \\
      REPRO_PROCESS_ID=<rank> python -m repro_torch.launch.train \\
      --arch yi-9b --batch 8 --seq 1024 --model-axis 2  # a process a card
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.cluster import maybe_init_distributed
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, AdamWState, init_adamw
from repro_torch.train.parallel import Layout, shard_params
from repro_torch.train.sharding_rules import (
    array_batch_specs,
    model_axis_misses,
    param_specs,
)
from repro_torch.train.trainer import TrainHParams, lm_loss, make_train_step
from repro_torch.utils.logging import log
from repro_torch.utils.sharding import placements, set_active_mesh


class TrainRun(NamedTuple):
    """What :func:`run` leaves: this rank's shards of the trained params
    and AdamW state, each step's metrics as floats, the mesh it ran on,
    the layout, each step's seconds on this rank, and on the card the
    peak bytes allocated over the steps (after the whole init was
    freed)."""
    params: Any
    opt: Any
    history: List[Dict[str, float]]
    mesh_dims: Dict[str, int]
    mesh_kind: str  # "DeviceMesh" under a process group, else "LogicalMesh"
    layout: Layout
    step_seconds: List[float]
    peak_bytes: Optional[int] = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, no activation recompute")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks of the mesh's model axis (tensor parallel)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a pod axis of 2 over the world (HSDP)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the kernels' "
                         "plain versions")
    return ap.parse_args(argv)


def hparams(args: argparse.Namespace) -> TrainHParams:
    """The step's hyperparameters from the flags (the dry-run's peak
    estimate of a launcher step reads them too)."""
    return TrainHParams(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=10, clip_norm=1.0),
        n_microbatches=args.n_micro, remat=not args.smoke)


def layout_mesh(world: int, model: int, multi_pod: bool,
                device_type: str):
    """The launcher's mesh over ``world`` ranks: (data, model), or (pod 2,
    data, model) for ``multi_pod``, data taking what is left."""
    pod = 2 if multi_pod else 1
    if model < 1 or world % (pod * model):
        raise ValueError(
            f"{world} rank(s) do not make a mesh of pod {pod} x model "
            f"{model}: the world must be a multiple of {pod * model}")
    return make_local_mesh(model=model, data=world // (pod * model),
                           device_type=device_type,
                           pod=2 if multi_pod else None)


def run(cfg: ModelConfig, args: argparse.Namespace, *,
        addr: Optional[str] = None, num_processes: Optional[int] = None,
        process_id: Optional[int] = None) -> TrainRun:
    """Train ``cfg`` as ``args`` says.  A process group this call brings
    up (``addr`` or the environment) is destroyed before returning; one
    already up is used and left up."""
    import torch.distributed as dist

    device = resolve_device(args.device)
    owned = not (dist.is_available() and dist.is_initialized())
    distributed = (maybe_init_distributed(addr, num_processes, process_id,
                                          device=device)
                   if owned else True)
    try:
        world = dist.get_world_size() if distributed else 1
        rank = dist.get_rank() if distributed else 0
        mesh = layout_mesh(world, args.model_axis, args.multi_pod,
                           device.type)
        set_active_mesh(mesh)
        if rank == 0:
            log("launch", f"arch={cfg.name} mesh={mesh_dims(mesh)} "
                f"world={world} device={device} "
                f"params≈{cfg.param_count() / 1e9:.2f}B")
        hp = hparams(args)
        whole = init_model(torch.Generator(device=device).manual_seed(0),
                           cfg, torch.float32, device)
        layout = Layout(mesh, param_specs(mesh, cfg, whole))
        misses = model_axis_misses(mesh, cfg, whole)
        if misses:
            raise ValueError(
                f"a model axis of {layout.model} cannot split {misses[0]}"
                + (f" (and {len(misses) - 1} more leaves)"
                   if len(misses) > 1 else "")
                + f" of {cfg.name}: param_specs keeps it whole there")
        if cfg.moe is not None and args.batch % layout.row_groups:
            raise ValueError(
                f"an MoE batch of {args.batch} rows must split evenly over "
                f"{layout.row_groups} row groups: the dispatch gathers them")
        params = shard_params(whole, mesh, layout.specs)
        del whole
        opt = init_adamw(params)
        step = make_train_step(cfg, hp, loss_fn=lm_loss, layout=layout)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

        rng = np.random.default_rng(0)
        history: List[Dict[str, float]] = []
        seconds: List[float] = []
        t0 = time.time()
        for i in range(args.steps):
            t_step = time.perf_counter()
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int64))
            batch = {"tokens": tokens.to(device)}
            if layout.row_groups > 1:
                batch = _local_rows(batch, mesh)
            params, opt, metrics = step(params, opt, batch)
            loss = metrics["loss"].detach().reshape(1).float()
            if world > 1:
                dist.all_reduce(loss)
                loss /= world
            history.append({"loss": float(loss),
                            "grad_norm": float(metrics["grad_norm"])})
            seconds.append(time.perf_counter() - t_step)
            if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
                log("train", f"step {i}", loss=f"{history[-1]['loss']:.4f}",
                    gnorm=f"{history[-1]['grad_norm']:.3f}")
        peak = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        tokens_done = args.steps * args.batch * args.seq
        if rank == 0:
            log("done", f"{tokens_done / (time.time() - t0):.0f} tok/s")
        if args.checkpoint:
            tree = {"params": layout.full(params, to_cpu=True),
                    "opt": AdamWState(opt.step,
                                      layout.full(opt.mu, to_cpu=True),
                                      layout.full(opt.nu, to_cpu=True))}
            if rank == 0:
                save_checkpoint(args.checkpoint, tree, step=args.steps,
                                metadata={"arch": cfg.name})
                log("ckpt", f"saved to {args.checkpoint}")
            del tree
        return TrainRun(params, opt, history, mesh_dims(mesh),
                        type(mesh).__name__, layout, seconds, peak)
    finally:
        set_active_mesh(None)
        if owned and distributed:
            dist.destroy_process_group()


def _local_rows(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch every rank holds whole, by
    ``array_batch_specs`` on the mesh (DTensor's even split, pod-major
    over ("pod", "data"); the model ranks take the same rows)."""
    from torch.distributed.tensor import distribute_tensor

    specs = array_batch_specs(mesh, batch)
    return {k: distribute_tensor(v, mesh, placements(mesh, specs[k]),
                                 src_data_rank=None).to_local()
            for k, v in batch.items()}


def mesh_dims(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    sizes = mesh.mesh.shape if hasattr(mesh, "mesh") else mesh.sizes
    return dict(zip(names, (int(s) for s in sizes)))


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    run(cfg, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
