"""Training launcher: mesh + data-parallel batch + train loop.

Counterpart of the JAX package's ``launch/train.py``, with its flags.
One process a rank: a coordinator (``REPRO_COORD_ADDR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``, read by
``launch.cluster.maybe_init_distributed``) brings up a
``torch.distributed`` process group, ``nccl`` on the card and ``gloo`` on
the CPU; without one the launcher runs alone.  The ranks form a
("data", "model") mesh of (world, 1): each rank holds the whole weights,
takes its rows of the batch by ``array_batch_specs`` and all-reduces the
gradients in one flat f32 bucket before the in-place AdamW, so the step
equals the one-process step on the whole batch.  At world size 1 it
runs ``make_train_step`` on the local tensors and reduces nothing.

A "model" axis above 1, the pod axis of ``--multi-pod`` and FSDP
layouts of the weights are not here (ROADMAP.md queue 1, item 14): the
mesh's model axis is 1, and the launcher refuses ``--multi-pod``.  The
sharding rules, the dry-run (``launch/dryrun.py``) and
``comm.resharding.reshard`` cover both axes already.

Usage:
  python -m repro_torch.launch.train --arch yi-9b --smoke --steps 10 \\
      --device cpu
  REPRO_COORD_ADDR=localhost:29500 REPRO_NUM_PROCESSES=2 \\
      REPRO_PROCESS_ID=<rank> python -m repro_torch.launch.train \\
      --arch yi-9b --batch 8 --seq 1024         # one process a card
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
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.sharding_rules import array_batch_specs
from repro_torch.train.trainer import TrainHParams, lm_loss, make_train_step
from repro_torch.utils.logging import log
from repro_torch.utils.sharding import placements, set_active_mesh
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten

UNSUPPORTED = ("ROADMAP.md queue 1, item 14: FSDP and tensor-parallel "
               "layouts at world size > 1")


class TrainRun(NamedTuple):
    """What :func:`run` leaves: the trained params and AdamW state, each
    step's metrics as floats, and the mesh it ran on."""
    params: Any
    opt: Any
    history: List[Dict[str, float]]
    mesh_dims: Dict[str, int]
    mesh_kind: str  # "DeviceMesh" under a process group, else "LogicalMesh"


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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the kernels' "
                         "plain versions")
    return ap.parse_args(argv)


def _allreduce_mean(world: int):
    """Average gradients over the ranks: one flat f32 bucket, one
    all-reduce, each leaf cast back to its type."""
    import torch.distributed as dist

    def reduce(grads):
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1).float() for g in leaves])
        dist.all_reduce(flat)
        flat.div_(world)
        out, off = [], 0
        for g in leaves:
            out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
            off += g.numel()
        return tree_unflatten(grads, out)

    return reduce


def run(cfg: ModelConfig, args: argparse.Namespace, *,
        addr: Optional[str] = None, num_processes: Optional[int] = None,
        process_id: Optional[int] = None) -> TrainRun:
    """Train ``cfg`` as ``args`` says.  The process group, when one comes
    up (``addr`` or the environment), is destroyed before returning."""
    import torch.distributed as dist

    device = resolve_device(args.device)
    distributed = maybe_init_distributed(addr, num_processes, process_id,
                                         device=device)
    try:
        world = dist.get_world_size() if distributed else 1
        rank = dist.get_rank() if distributed else 0
        if args.multi_pod:
            raise NotImplementedError(
                f"--multi-pod over {world} process(es): {UNSUPPORTED}")
        mesh = make_local_mesh(model=1, data=world, device_type=device.type)
        set_active_mesh(mesh)
        if rank == 0:
            log("launch", f"arch={cfg.name} mesh={mesh_dims(mesh)} "
                f"world={world} device={device} "
                f"params≈{cfg.param_count() / 1e9:.2f}B")
        hp = TrainHParams(
            optimizer=AdamWConfig(lr=args.lr, warmup_steps=10, clip_norm=1.0),
            n_microbatches=args.n_micro, remat=not args.smoke)
        params = init_model(torch.Generator(device=device).manual_seed(0),
                            cfg, torch.float32, device)
        opt = init_adamw(params)
        step = make_train_step(
            cfg, hp, loss_fn=lm_loss,
            grad_reduce=_allreduce_mean(world) if world > 1 else None)

        rng = np.random.default_rng(0)
        history: List[Dict[str, float]] = []
        t0 = time.time()
        for i in range(args.steps):
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int64))
            batch = {"tokens": tokens}
            if world > 1:
                batch = _local_rows(batch, mesh)
            batch = {k: v.to(device) for k, v in batch.items()}
            params, opt, metrics = step(params, opt, batch)
            loss = metrics["loss"].detach().reshape(1).float()
            if world > 1:
                dist.all_reduce(loss)
                loss /= world
            history.append({"loss": float(loss),
                            "grad_norm": float(metrics["grad_norm"])})
            if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
                log("train", f"step {i}", loss=f"{history[-1]['loss']:.4f}",
                    gnorm=f"{history[-1]['grad_norm']:.3f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tokens_done = args.steps * args.batch * args.seq
        if rank == 0:
            log("done", f"{tokens_done / (time.time() - t0):.0f} tok/s")
            if args.checkpoint:
                save_checkpoint(args.checkpoint,
                                {"params": params, "opt": opt},
                                step=args.steps,
                                metadata={"arch": cfg.name})
                log("ckpt", f"saved to {args.checkpoint}")
        return TrainRun(params, opt, history, mesh_dims(mesh),
                        type(mesh).__name__)
    finally:
        set_active_mesh(None)
        if distributed:
            dist.destroy_process_group()


def _local_rows(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch every rank holds whole, by
    ``array_batch_specs`` on the mesh (DTensor's even split)."""
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
