"""Multi-pod dry-run: size every (arch x input-shape x mesh) without a card.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each case for 512 placeholder devices and reads XLA's memory
and cost analyses.  The port builds each model at full size on
``torch.device("meta")`` (shapes and types, no storage) under the
logical production mesh (``launch/mesh.py``) and records, for each case:

  * the resident bytes a device: the parameters (bf16), the AdamW
    moments (f32, laid out as the parameters) of a train step and the
    decode state of a decode step, from the sharding rules
    (``train/sharding_rules.py``: the layout the launcher gives its f32
    params and moments, :func:`train_state_bytes`), and the batch's;
    ``fits_resident`` when they fit in the card's 80 GB;
  * JAX's memory analysis, from the step itself (``launch.memory``):
    rank 0 of the mesh runs the train step (``make_train_step`` with
    :func:`hparams_for`'s microbatches and remat, through
    ``train.parallel.Layout``), the prefill step or one decode step on
    meta tensors, and the live bytes give ``argument_bytes``,
    ``output_bytes``, ``alias_bytes`` (the port's AdamW updates in
    place, so a train step's outputs alias its arguments), ``temp_bytes``
    and ``peak_est_bytes`` = argument + temp + output - alias, JAX's
    formula; ``fits`` when that peak fits;
  * FLOPs from ``model_flops`` (6 N D), with ``FlopCounterMode`` over
    one meta forward (or decode step) as a cross-check, each kernel
    launch counted at its plain version's products (``kernels.meta``),
    and the bytes that forward's ops move (each op's tensor operands
    read once and its results written once, views moving nothing: no
    fusion; a kernel launch reads its operands and writes its results
    and scratch, as JAX's cost analysis counts a Pallas call), both x3
    for a train step;
  * each step's collective bytes (``utils.roofline.collective_bytes``);
  * the roofline terms on the H100 (``utils/hardware.py``) from the
    counted FLOPs and bytes, an even share of each a device.

Nothing is set at import: JAX's module sets ``XLA_FLAGS`` first thing,
the port needs no such flag.  The JSON of a case goes where JAX's goes
(``experiments/dryrun/``), named ``<arch>_<shape>_<mesh>_torch.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.meta import FLOP_FORMULAS
from repro_torch.launch.memory import MetaMemo, meta_model, peak_estimate
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.trainer import TrainHParams
from repro_torch.train.sharding_rules import (
    array_batch_specs,
    decode_state_specs,
    param_specs,
)
from repro_torch.utils.hardware import DEFAULT_CHIP
from repro_torch.utils.roofline import (
    RooflineReport,
    collective_bytes,
    model_flops,
    per_device_bytes,
)
from repro_torch.utils.sharding import mesh_shape

ASSIGNED_ARCHS = [
    "granite-moe-3b-a800m",
    "zamba2-2.7b",
    "whisper-large-v3",
    "llama4-scout-17b-a16e",
    "llama-3.2-vision-90b",
    "codeqwen1.5-7b",
    "mamba2-370m",
    "yi-9b",
    "mistral-large-123b",
    "stablelm-12b",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")

META = torch.device("meta")
PARAM_DTYPE = torch.bfloat16  # JAX's dry-run params and caches


def arch_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k uses the sub-quadratic variant: sliding-window (8192) for
    attention archs; SSM/hybrid archs are O(1)-state already."""
    if shape.name == "long_500k" and cfg.num_heads and cfg.kind != "hybrid":
        return cfg.replace(sliding_window=8192)
    return cfg


def hparams_for(cfg: ModelConfig, shape: ShapeConfig,
                mesh: Any) -> TrainHParams:
    """JAX's ``hparams_for``: 4, 8 or 16 microbatches as d_model x depth
    grows, halved until each one's rows split over ("pod", "data"), with
    remat.  Its ``act_spec`` (sequence-parallel activations) has no
    counterpart in ``train.parallel.Layout``: rank 0 holds the whole
    sequence of its rows."""
    act_cost = cfg.d_model * cfg.num_layers
    n_micro = 16 if act_cost >= 500_000 else (
        8 if act_cost >= 120_000 else 4)
    sizes = mesh_shape(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    while n_micro > 1 and (shape.global_batch // n_micro) % dp != 0:
        n_micro //= 2
    return TrainHParams(n_microbatches=max(n_micro, 1), remat=True)


def meta_params(cfg: ModelConfig, dtype=PARAM_DTYPE):
    """The full-size weights as meta tensors."""
    return meta_model(cfg, dtype)


def train_state_bytes(cfg: ModelConfig, mesh: Any,
                      dtype=PARAM_DTYPE) -> Dict[str, int]:
    """Bytes a device holds of ``cfg``'s params (in ``dtype``) and AdamW
    moments (f32) laid out by ``param_specs`` on ``mesh``: at f32, what
    each rank of the launcher keeps (``launch/train.py``)."""
    params = meta_params(cfg, dtype)
    specs = param_specs(mesh, cfg, params)
    opt = init_adamw(params)
    return {"param_bytes": per_device_bytes(mesh, params, specs),
            "opt_bytes": per_device_bytes(mesh, opt.mu, specs)
            + per_device_bytes(mesh, opt.nu, specs)}


def meta_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A train or prefill batch as JAX's ``batch_sds`` shapes it."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.empty((B, S), dtype=torch.float32, device=META)
    if cfg.kind == "vlm":
        batch["image_embeds"] = torch.empty(
            (B, cfg.num_image_tokens, cfg.d_model), dtype=PARAM_DTYPE,
            device=META)
    if cfg.kind == "encdec":
        batch["frame_embeds"] = torch.empty(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=PARAM_DTYPE,
            device=META)
    return batch


class ByteCounter(TorchDispatchMode):
    """Bytes the ops under it move: each op's tensor operands read once
    and its results written once; a view (``_unsafe_view``, the view
    that ends a copying ``reshape``, among them) moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view
                or func is torch.ops.aten._unsafe_view.default):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def counted(cfg: ModelConfig, shape: ShapeConfig, params,
            batch: Optional[Dict[str, Any]] = None,
            state: Optional[M.DecodeState] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one meta forward of the batch (one decode step
    of the state for a decode shape), x3 for a train step:
    ``FlopCounterMode``'s count, the cross-check of :func:`model_flops`
    (each kernel launch at its plain version's products), and
    :class:`ByteCounter`'s (each launch its operands, results and
    scratch)."""
    moved = ByteCounter()
    with MetaMemo(), FlopCounterMode(display=False,
                                     custom_mapping=FLOP_FORMULAS) as fc, \
            moved, torch.no_grad():
        if shape.phase == "decode":
            B = shape.global_batch
            M.decode_step(params, cfg,
                          torch.zeros((B, 1), dtype=torch.long, device=META),
                          state,
                          torch.zeros((B,), dtype=torch.long, device=META))
        else:
            extra = {k: batch[k] for k in ("image_embeds", "frame_embeds")
                     if k in batch} or None
            M.forward(params, cfg, batch["tokens"].long(), extra)
    times = 3.0 if shape.phase == "train" else 1.0
    return float(fc.get_total_flops()) * times, float(moved.bytes) * times


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             cfg_transform=None, save: bool = True, verbose: bool = True,
             tag: str = "") -> Dict[str, Any]:
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = get_shape(shape_name)
    cfg = arch_for_shape(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.size
    t0 = time.time()
    params = meta_params(cfg)
    pspecs = param_specs(mesh, cfg, params)
    mem = {"param_bytes": per_device_bytes(mesh, params, pspecs),
           "opt_bytes": 0, "decode_state_bytes": 0, "batch_bytes": 0}
    batch = state = None
    if shape.phase == "decode":
        state = M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                    PARAM_DTYPE, META)
        mem["decode_state_bytes"] = per_device_bytes(
            mesh, state, decode_state_specs(mesh, cfg, state))
    else:
        batch = meta_batch(cfg, shape)
        mem["batch_bytes"] = per_device_bytes(
            mesh, batch, array_batch_specs(mesh, batch))
    if shape.phase == "train":
        opt = init_adamw(params)
        mem["opt_bytes"] = (per_device_bytes(mesh, opt.mu, pspecs)
                            + per_device_bytes(mesh, opt.nu, pspecs))
    total = sum(mem.values())
    if shape.phase == "decode":
        est = peak_estimate(cfg, mesh, phase="decode",
                            decode_rows=shape.global_batch,
                            cache_len=shape.seq_len)
    else:
        est = peak_estimate(cfg, mesh, phase=shape.phase, batch=batch,
                            hp=hparams_for(cfg, shape, mesh))
    mem.update(resident_bytes=total, hbm_bytes=DEFAULT_CHIP.hbm_bytes,
               fits_resident=total <= DEFAULT_CHIP.hbm_bytes,
               **est.memory())
    mem["fits"] = mem["peak_est_bytes"] <= DEFAULT_CHIP.hbm_bytes
    coll = collective_bytes(mesh, params, pspecs,
                            train=shape.phase == "train")
    mf = model_flops(cfg, shape)
    flops, moved = counted(cfg, shape, params, batch, state)
    build_s = time.time() - t0
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops / chips,
        hlo_bytes=moved / chips,
        collective_bytes=float(sum(coll["bytes"].values())),
        model_flops=mf, arg_bytes=mem["argument_bytes"],
        temp_bytes=mem["temp_bytes"],
        collective_counts=coll["counts"]).finalize()
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "chip": DEFAULT_CHIP.name, "build_s": round(build_s, 2),
        "memory": mem,
        "flops": {"model_flops": mf, "counted_flops": flops,
                  "counted_over_model": flops / mf if mf else 0.0},
        "bytes_moved": {"counted_bytes": moved,
                        "per_device_bytes": moved / chips},
        "collectives": {"counts": coll["counts"],
                        "bytes_by_kind": coll["bytes"],
                        "total_bytes": sum(coll["bytes"].values())},
        "roofline": {
            "compute_s": rep.compute_s, "memory_s": rep.memory_s,
            "collective_s": rep.collective_s, "dominant": rep.dominant,
            "model_flops": rep.model_flops,
            "useful_flops_ratio": rep.useful_flops_ratio,
        },
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}"
              f"  built in {build_s:.1f}s"
              f"  {total / 1e9:.2f} GB/device resident (params "
              f"{mem['param_bytes'] / 1e9:.2f}, opt "
              f"{mem['opt_bytes'] / 1e9:.2f}, state "
              f"{mem['decode_state_bytes'] / 1e9:.2f}) "
              f"fits_resident={mem['fits_resident']}  peak est "
              f"{mem['peak_est_bytes'] / 1e9:.2f} GB (temp "
              f"{mem['temp_bytes'] / 1e9:.2f}) fits={mem['fits']}  "
              f"dom={rep.dominant}")
        print("         " + rep.row())
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(
            OUT_DIR, f"{arch}_{shape_name}_{mesh_name}{suffix}_torch.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", "--multi-pod-only", dest="multi_pod",
                    action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch is None else [args.arch]
    shapes = SHAPE_NAMES if args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_case(arch, shape, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — report every case
                    failures.append((arch, shape, mp, repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CASES PASSED")


if __name__ == "__main__":
    main()
