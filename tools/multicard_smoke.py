#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's multi-device paths on four cards
of one host.

Run from the repository root with four cards visible:

    python3 tools/multicard_smoke.py [--phases layouts,kinds,devices]

It builds the kernels from the checkout's sources (as ``chip_smoke.py``
does), then runs three phases:

  layouts   four rank processes, one a card, in one ``nccl`` group
            (``tcp://localhost``): ``launch.train.run`` on yi-9b at full
            width cut to 2 layers, f32 + AdamW with remat, 3 steps of 4 x
            1024 tokens, at (data, model) = (4, 1), (2, 2), (1, 4) and
            with ``--multi-pod`` at (pod, data, model) = (2, 1, 2), each
            against the one-card step on the whole batch
            (``make_train_step``, which every rank runs on its own card):
            every step's loss and grad norm and every leaf (gathered
            whole, within its norm) within rtol 1e-6 for FSDP and 1e-5
            with a model axis, the CPU tests' bars, or within twice the
            one card's disagreement with itself over the same rows in
            four microbatches (a control printed beside them) where
            that is larger; each rank's params and moments hold the
            dry-run's bytes a device for its mesh; then yi-9b at all 48
            layers, 3 steps, at (4, 1) and (2, 2): each card's peak bytes
            over the steps beside the dry-run's resident bytes and its
            peak estimate (within 10 %), the step seconds and tokens/s;
            then ``reshard`` and ``reshard_params``
            between specs on a (2, 2) mesh of the four cards, bit for
            bit;
  kinds     in the same rank processes: granite-moe, mamba2, zamba2,
            whisper-large-v3 and llama-3.2-vision at full width cut to 2
            layers (``kind_config``), f32, a GRPO batch of 4 x 512 tokens,
            at (data, model) = (2, 2) and (1, 4), the compute split over
            "model" wherever the rules store a leaf split there, against
            the one-card step on the whole batch (``check_kinds``), at
            two seeds of the weights and the batch: loss, grad norm and
            every leaf of the gradient within 1e-5, or twice the larger
            of the one card's own disagreements over four microbatches at
            the two seeds where that is larger (not for the MoE); K3, K6
            and their backwards launched a step on every rank as counted;
  devices   in this process: a reduced yi-9b ``RolloutWorker`` rebound
            from cuda:0 to cuda:1 (the unmoved worker's tokens, every
            byte of its engine freed from cuda:0, K1 and K2 launched as
            counted); ``GRPORunner`` on yi-9b cut to 2 layers over
            ``Cluster(1, device_count)``, collocated and as the scheduler
            plans it, strict (flowlint passes 1-2 before every execute):
            the workers' cards, launches per iteration exact, the weight
            sync's seconds across cards and the plan-vs-actual report;
            kill and recover on the four cards (the rollout killed at
            iteration 1), equal to a fresh resume bit for bit.

Every card's ``nvidia-smi`` name and power limit is printed; the last
line is ``{"ok": true, "device": {...}}``.  A failed check raises and
the script exits non-zero without that line.  Float32 products run
without TF32 throughout.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
SEED = 0
LAYERS = 2  # of yi-9b's 48: the layouts held against one card
RUN = ["--arch", "yi-9b", "--steps", "3", "--batch", "4", "--seq", "1024"]
LAYOUTS = (("fsdp 4x1", ["--model-axis", "1"], 1e-6),
           ("tp 2x2", ["--model-axis", "2"], 1e-5),
           ("tp 1x4", ["--model-axis", "4"], 1e-5),
           ("hsdp 2x1x2", ["--model-axis", "2", "--multi-pod"], 1e-5))
DEEP = (("fsdp 4x1", ["--model-axis", "1"]),
        ("tp 2x2", ["--model-axis", "2"]))
RANK_TIMEOUT = 900


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counters() -> dict:
    """The launch counters of the kernels these runs take, by short name
    (``chip_smoke.py``'s names)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as ks

    return {"K1": pa.paged_attention_bhd, "K2": ks.fused_sample_bv,
            "K3": fa.flash_attention_bhsd, "K3bwd": fa.flash_attention_bwd}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def launches() -> tuple:
    """(K1, K2, K3, K3 backward) launches since :func:`zero_launches`."""
    return tuple(fn.launches for fn in launch_counters().values())


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def card_lines() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


def no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# phase "layouts": one process a card
# ---------------------------------------------------------------------------
def rank_log(rank: int, msg: str) -> None:
    if rank == 0:
        log(f"layouts: {msg}")


def one_card_reference(cfg, args, n_micro: int = 1):
    """The one-card steps on the whole batch, in ``n_micro``
    microbatches: (params after, history)."""
    import numpy as np
    import torch

    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, TrainHParams, make_train_step
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.trainer import lm_loss

    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        torch.float32, "cuda")
    opt = init_adamw(params)
    step = make_train_step(cfg, TrainHParams(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=10, clip_norm=1.0),
        n_microbatches=n_micro, remat=True), loss_fn=lm_loss)
    rng = np.random.default_rng(0)
    hist = []
    for _ in range(args.steps):
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.seq))).cuda()
        params, opt, m = step(params, opt, {"tokens": tok})
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    del opt
    return params, hist


def local_bytes(run) -> int:
    from repro_torch.utils.treeutil import tree_leaves

    return sum(x.numel() * x.element_size()
               for t in (run.params, run.opt.mu, run.opt.nu)
               for x in tree_leaves(t))


def gathered(value, rank_count: int) -> list:
    import torch.distributed as dist

    out = [None] * rank_count
    dist.all_gather_object(out, value)
    return out


def disagreement(hist, got, ref_hist, want) -> dict:
    """Relative errors against the one-card steps: the largest over the
    steps of the loss's and the grad norm's, and the worst leaf after
    the steps (within its norm) with its path."""
    import torch

    norm = torch.linalg.vector_norm
    rel = {key: max(abs(g[key] - w[key]) / abs(w[key])
                    for g, w in zip(hist, ref_hist))
           for key in ("loss", "grad_norm")}
    leaf = max(((p, float(norm(got[p] - want[p]) / norm(want[p])))
                for p in want), key=lambda kv: kv[1])
    return {"loss": rel["loss"], "grad_norm": rel["grad_norm"],
            "leaf": leaf[1], "leaf_path": leaf[0]}


def check_layouts(rank: int) -> list:
    """The four layouts at 2 layers against the one-card steps; returns
    the misses (every layout runs and prints first).

    A layout passes within its bar (the CPU tests': 1e-6 for FSDP, 1e-5
    with a model axis) or, for the grad norm and the leaves, where the
    one card disagrees with itself by more when it takes the same rows
    in four microbatches of one (the order of an FSDP rank's sums),
    within twice that control: f32 sums over a full-width layer's 4096
    tokens round past 1e-6."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.utils.treeutil import tree_paths

    cfg = get_config("yi-9b").replace(num_layers=LAYERS)
    base = T.parse_args(RUN)
    t0 = time.perf_counter()
    ref, ref_hist = one_card_reference(cfg, base)
    want = tree_paths(ref)
    ctl, ctl_hist = one_card_reference(cfg, base, n_micro=base.batch)
    control = disagreement(ctl_hist, tree_paths(ctl), ref_hist, want)
    del ctl
    rank_log(rank, f"one-card reference: yi-9b full width {LAYERS} layers "
             f"f32 + AdamW, {base.steps} steps of {base.batch} x "
             f"{base.seq}, losses {[h['loss'] for h in ref_hist]}, grad "
             f"norms {[h['grad_norm'] for h in ref_hist]}; the control (the "
             f"same steps in {base.batch} microbatches of one row) "
             f"disagrees by grad norm {control['grad_norm']:.3g}, worst leaf "
             f"{control['leaf_path']} {control['leaf']:.3g} of its norm; "
             f"{time.perf_counter() - t0:.2f} s on each card")
    misses = []
    for name, flags, bar in LAYOUTS:
        args = T.parse_args(RUN + flags)
        zero_launches()
        t0 = time.perf_counter()
        run = T.run(cfg, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = launches()
        full = tree_paths(run.layout.full(run.params))
        err = disagreement(run.history, full, ref_hist, want)
        # the control's loss is its last microbatch's, not the batch's
        allowed = {"loss": bar}
        allowed.update({key: max(bar, 2 * control[key])
                        for key in ("grad_norm", "leaf")})
        over = [key for key in allowed if err[key] > allowed[key]]
        if over:
            misses.append((name, {key: (err[key], allowed[key])
                                  for key in over}))
        have = local_bytes(run)
        dry = train_state_bytes(cfg, run.layout.mesh, torch.float32)
        if have != dry["param_bytes"] + dry["opt_bytes"]:
            misses.append((name, "bytes", have, dry))
        steps = gathered(run.step_seconds, WORLD)
        rank_log(rank, f"{name} {run.mesh_dims}: {wall:.2f} s with init; "
                 f"loss rel err {err['loss']:.3g}, grad norm "
                 f"{err['grad_norm']:.3g}, worst leaf {err['leaf_path']} "
                 f"{err['leaf']:.3g} of its norm (bar {bar}, allowed "
                 + ", ".join(f"{key} {v:.3g}" for key, v in allowed.items())
                 + f"): {'MISSED ' + str(over) if over else 'within'}; "
                 f"rank 0 holds {have / 1e9:.4f} GB of params + AdamW, the "
                 f"dry-run's {(dry['param_bytes'] + dry['opt_bytes']) / 1e9:.4f}"
                 f"; step seconds (rank 0) "
                 f"{[round(x, 4) for x in steps[0]]}; launches on rank 0 "
                 f"K3={k[2]} K3bwd={k[3]}")
        del run, full
        gc.collect()
        torch.cuda.empty_cache()
    del ref, want
    gc.collect()
    torch.cuda.empty_cache()
    return misses


KINDS = ("granite-moe-3b-a800m", "mamba2-370m", "zamba2-2.7b",
         "whisper-large-v3", "llama-3.2-vision-90b")
KIND_MESHES = ((2, 2), (1, 4))  # (data, model)
KIND_ROWS = 4
KIND_TOKENS = 512  # whisper's decoder: its 448 positions
KIND_SEEDS = (0, 1)


def kind_config(arch: str):
    """``arch`` at full width cut to 2 layers (whisper 2 + 2, zamba2 one
    group of 6 SSM layers and its shared attention block, llama-vision
    one self and one cross layer)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.kind == "hybrid":
        return cfg.replace(num_layers=cfg.attn_every)
    if cfg.kind == "vlm":
        return cfg.replace(num_layers=2, cross_attn_every=2)
    if cfg.kind == "encdec":
        return cfg.replace(num_layers=2, num_encoder_layers=2)
    return cfg.replace(num_layers=2)


def kind_batch(cfg, seed: int):
    """A GRPO batch of ``KIND_ROWS`` rows from ``seed`` on the card (the
    VLM's image tokens, whisper's frames beside it)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B = KIND_ROWS
    S = min(KIND_TOKENS, cfg.max_seq_len) if cfg.kind == "encdec" \
        else KIND_TOKENS

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).cuda(),
        "old_logprobs": torch.zeros(B, S, device="cuda"),
        "advantages": normal(B, S), "loss_mask": torch.ones(
            B, S, device="cuda")}
    if cfg.kind == "vlm":
        batch["image_embeds"] = normal(B, cfg.num_image_tokens, cfg.d_model)
    if cfg.kind == "encdec":
        batch["frame_embeds"] = normal(B, cfg.encoder_seq_len, cfg.d_model)
    return batch


def kind_launches(cfg) -> dict:
    """K3, K3 backward, K6, K6 backward launched by one remat train step
    on a model rank: the forward and the remat's recompute launch the
    forward kernels once a layer each, the backward once a layer (the
    encoder's layers among them; cross-attention is plain products)."""
    attn = {"dense": cfg.num_layers, "moe": cfg.num_layers, "ssm": 0,
            "hybrid": cfg.num_layers // (cfg.attn_every or 1),
            "vlm": cfg.num_layers - cfg.num_layers // (
                cfg.cross_attn_every or 1),
            "encdec": cfg.num_layers + cfg.num_encoder_layers}[cfg.kind]
    ssm = cfg.num_layers if cfg.kind in ("ssm", "hybrid") else 0
    return {"K3": 2 * attn, "K3bwd": attn, "K6": 2 * ssm, "K6bwd": ssm}


def kind_counters() -> dict:
    from repro_torch.kernels import ssd_scan as ssd

    c = launch_counters()
    return {"K3": c["K3"], "K3bwd": c["K3bwd"], "K6": ssd.ssd_scan_bhcsp,
            "K6bwd": ssd.ssd_scan_bwd}


def loss_and_grads(cfg, hp, params, batch, gather=None, n_micro: int = 1):
    """(loss, the gradient) of ``policy_loss`` on ``batch`` in
    ``n_micro`` microbatches (the gradients averaged)."""
    import torch

    from repro_torch.train.trainer import policy_loss
    from repro_torch.utils.treeutil import (tree_leaves, tree_map,
                                            tree_unflatten)

    n = KIND_ROWS // n_micro
    total, loss = None, 0.0
    for i in range(n_micro):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        kw = {} if gather is None else {"gather": gather}
        with torch.enable_grad():
            out, _ = policy_loss(cfg, hp, live, mb, **kw)
            g = torch.autograd.grad(out, tree_leaves(live))
        loss += float(out.detach()) / n_micro
        if total is None:
            total = [x.div_(n_micro) for x in g]
        else:
            for a, x in zip(total, g):
                a.add_(x, alpha=1.0 / n_micro)
        del live, out, g
    return loss, tree_unflatten(params, total)


def grad_norm_of(tree: dict) -> float:
    """The global norm, its squares summed in f64 (a slice of 2^24
    elements at a time: llama-vision's embedding is 1.05 G of them)."""
    return sum(float(c.double().square().sum())
               for x in tree.values()
               for c in x.reshape(-1).split(1 << 24)) ** 0.5


def grad_gap(got: dict, want: dict) -> tuple:
    """(rel error of the global norm, worst leaf within its norm, its
    path) of gradient ``got`` against ``want`` (path: tensor)."""
    import torch

    norm = torch.linalg.vector_norm
    leaf = max(((p, float(norm(got[p] - want[p]) / norm(want[p])))
                for p in want), key=lambda kv: kv[1])
    ref = grad_norm_of(want)
    return abs(grad_norm_of(got) - ref) / ref, leaf[1], leaf[0]


def conv_parts(cfg, got: dict, want: dict) -> str:
    """A mixer's ``conv_w`` gradient within its norm over its x columns
    and over its B and C columns, for an SSM kind: a split rank computes
    the x columns of its heads alone, while B's and C's are the sum of
    every model rank's part (its heads' share)."""
    import torch

    norm = torch.linalg.vector_norm
    path = next((p for p in want if p.endswith("/mixer/conv_w")), None)
    if path is None:
        return ""
    di = cfg.d_inner
    err = [float(norm(got[path][..., c] - want[path][..., c])
                 / norm(want[path][..., c]))
           for c in (slice(0, di), slice(di, None))]
    return f"; conv_w x {err[0]:.3g}, B and C {err[1]:.3g}"


def check_kinds(rank: int) -> list:
    """Every kind at full width cut to 2 layers (``kind_config``) at
    (data, model) = (2, 2) and (1, 4), its compute split over "model"
    wherever the rules store a leaf split there, against one card on the
    whole batch, which every rank computes on its own card, at each seed
    of ``KIND_SEEDS`` (the weights and the batch): the layout's train
    step (``policy_loss`` with its entropy term, remat, AdamW) in loss
    and grad norm, and its gradient (reduced, gathered whole) in every
    leaf, within 1e-5, or twice the larger of the one card's
    disagreements with itself over the same rows in four microbatches of
    one, at the seeds, where that is larger (not for the MoE, whose
    capacity dispatch depends on the microbatch); K3, K6 and their
    backwards launched exactly as ``kind_launches`` counts them on every
    rank.  Returns the misses."""
    import torch

    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, TrainHParams, make_train_step
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.parallel import Layout, shard_params
    from repro_torch.train.sharding_rules import param_specs
    from repro_torch.train.trainer import policy_loss
    from repro_torch.utils.treeutil import tree_map, tree_paths

    misses = []
    counters = kind_counters()
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5, clip_norm=1.0),
                      remat=True, entropy_coef=0.01)
    for arch in KINDS:
        t0 = time.perf_counter()
        cfg = kind_config(arch)
        expect = kind_launches(cfg)
        controls, readings = [], []
        for seed in KIND_SEEDS:
            whole = init_model(torch.Generator(device="cuda").manual_seed(
                seed), cfg, torch.float32, "cuda")
            if cfg.kind == "vlm":  # open the cross layers (tanh(0) = 0)
                whole["cross_layers"]["gate"].fill_(0.5)
            batch = kind_batch(cfg, seed)
            ref_loss, ref = loss_and_grads(cfg, hp, whole, batch)
            want = tree_paths(ref)
            del ref
            ctl_line = "no control (the dispatch depends on the microbatch)"
            if cfg.moe is None:
                _, ctl = loss_and_grads(cfg, hp, whole, batch,
                                        n_micro=KIND_ROWS)
                ctl = tree_paths(ctl)
                controls.append(grad_gap(ctl, want))
                c_gn, c_leaf, c_path = controls[-1]
                ctl_line = (f"control (4 microbatches of one row): grad norm "
                            f"{c_gn:.3g}, worst leaf {c_path} {c_leaf:.3g}"
                            + conv_parts(cfg, ctl, want))
                del ctl
            rank_log(rank, f"kinds: {arch} ({cfg.kind}) seed {seed}, width "
                     f"{cfg.d_model}, {cfg.num_layers} layers"
                     + (f" + {cfg.num_encoder_layers} encoder"
                        if cfg.kind == "encdec" else "")
                     + f", f32, {tuple(batch['tokens'].shape)} tokens: one "
                     f"card loss {ref_loss:.6f}; {ctl_line}")
            for data, model in KIND_MESHES:
                mesh = make_local_mesh(model=model, data=data)
                layout = Layout(mesh, param_specs(mesh, cfg, whole))
                # a copy: the step updates its params in place, and a leaf
                # that no axis splits is the whole tree's own tensor
                local = tree_map(torch.clone,
                                 shard_params(whole, mesh, layout.specs))
                rows = T._local_rows(batch, mesh)
                _, g = loss_and_grads(cfg, hp, local, rows, layout.gather)
                got = tree_paths(layout.full(layout.reduce(g)))
                del g
                g_gn, g_leaf, g_path = grad_gap(got, want)
                parts = conv_parts(cfg, got, want)
                del got
                for fn in counters.values():
                    fn.launches = 0
                step = make_train_step(cfg, hp, policy_loss, layout=layout)
                local, opt, m = step(local, init_adamw(local), rows)
                torch.cuda.synchronize()
                k = {n: fn.launches for n, fn in counters.items()}
                loss = torch.tensor([float(m["loss"])], dtype=torch.float64,
                                    device="cuda")
                torch.distributed.all_reduce(loss)
                loss = float(loss[0]) / WORLD
                err = {"loss": abs(loss - ref_loss) / abs(ref_loss),
                       "grad_norm": max(g_gn, abs(float(m["grad_norm"])
                                                  - grad_norm_of(want))
                                        / grad_norm_of(want)),
                       "leaf": g_leaf}
                every = gathered(k, WORLD)
                readings.append((seed, (data, model), err, g_path, parts))
                if any(x != expect for x in every):
                    misses.append((arch, seed, (data, model), "launches",
                                   every, expect))
                rank_log(rank, f"kinds: {arch} seed {seed} at (data, model) "
                         f"= ({data}, {model}): launches a step on each rank "
                         f"{every[0]} (predicted {expect}"
                         + ("" if all(x == expect for x in every)
                            else ", MISSED") + ")")
                del local, opt, layout, rows, step
                gc.collect()
                torch.cuda.empty_cache()
            del whole, want, batch
            gc.collect()
            torch.cuda.empty_cache()
        bars = {"loss": 1e-5,
                "grad_norm": max([1e-5] + [2 * c[0] for c in controls]),
                "leaf": max([1e-5] + [2 * c[1] for c in controls])}
        for seed, mesh, err, path, parts in readings:
            over = [key for key in bars if err[key] > bars[key]]
            if over:
                misses.append((arch, seed, mesh, {key: (err[key], bars[key])
                                                  for key in over}))
            rank_log(rank, f"kinds: {arch} seed {seed} at (data, model) = "
                     f"{mesh}: loss rel err {err['loss']:.3g}, grad norm "
                     f"{err['grad_norm']:.3g}, worst gradient leaf {path} "
                     f"{err['leaf']:.3g} of its norm{parts} (allowed "
                     + ", ".join(f"{key} {v:.3g}" for key, v in bars.items())
                     + f"): {'MISSED ' + str(over) if over else 'within'}")
        rank_log(rank, f"kinds: {arch}: {time.perf_counter() - t0:.1f} s")
    return misses


ESTIMATE_TOL = 0.10  # the dry-run's peak estimate against each card's


def deep_estimate(cfg, args, mesh_dims: dict):
    """The dry-run's peak estimate (``launch.memory.peak_estimate``) of
    the launcher's step: rank 0 of ``mesh_dims``, f32 params, the
    launcher's hyperparameters and loss, its (batch, seq) int64 tokens."""
    import torch

    from repro_torch.launch import train as T
    from repro_torch.launch.memory import peak_estimate
    from repro_torch.train.trainer import lm_loss

    tokens = torch.empty((args.batch, args.seq), dtype=torch.int64,
                         device="meta")
    return peak_estimate(cfg, mesh_dims, batch={"tokens": tokens},
                         hp=T.hparams(args), dtype=torch.float32,
                         loss_fn=lm_loss)


def check_deep(rank: int) -> list:
    """yi-9b at all 48 layers over the four cards: peak bytes a card
    beside the dry-run's resident bytes and its peak estimate (rank 0's
    step on the meta device, within ``ESTIMATE_TOL`` of every card's
    peak), step seconds, tokens/s; returns the misses."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.dryrun import train_state_bytes

    cfg = get_config("yi-9b")
    misses = []
    for name, flags in DEEP:
        args = T.parse_args(RUN + flags)
        t0 = time.perf_counter()
        run = T.run(cfg, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in run.history), run.history
        dry = train_state_bytes(cfg, run.layout.mesh, torch.float32)
        resident = dry["param_bytes"] + dry["opt_bytes"]
        have = local_bytes(run)
        assert have == resident, (name, have, resident)
        peaks = gathered(run.peak_bytes, WORLD)
        steps = gathered(run.step_seconds, WORLD)
        slow = [max(s[i] for s in steps) for i in range(args.steps)]
        tok = args.batch * args.seq
        if rank == 0:
            est = deep_estimate(cfg, args, run.mesh_dims)
            gaps = [est.memory()["peak_est_bytes"] / p - 1.0 for p in peaks]
            rank_log(rank, f"48 layers {name} {run.mesh_dims}: peak "
                     f"estimate (launch.memory, rank 0's step on the meta "
                     f"device) {est.memory()['peak_est_bytes'] / 1e9:.3f} "
                     f"GB, its peak at {est.peak_op}, op {est.peak_index} "
                     f"of {est.ops}; against each card's peak "
                     f"{[f'{100 * g:+.1f} %' for g in gaps]} (tolerance "
                     f"{100 * ESTIMATE_TOL:.0f} %)")
            if max(abs(g) for g in gaps) > ESTIMATE_TOL:
                misses.append((name, "peak estimate", est.memory(), peaks))
        rank_log(rank, f"48 layers {name} {run.mesh_dims}: yi-9b "
                 f"{cfg.param_count() / 1e9:.2f} B params f32 + AdamW, "
                 f"{args.steps} steps of {args.batch} x {args.seq} with "
                 f"remat in {wall:.1f} s with init; losses "
                 f"{[round(h['loss'], 5) for h in run.history]}, grad norms "
                 f"{[round(h['grad_norm'], 5) for h in run.history]}; step "
                 f"seconds (slowest rank) {[round(s, 4) for s in slow]} = "
                 f"{tok / slow[-1]:.0f} tok/s at the last; resident a card "
                 f"{resident / 1e9:.3f} GB (dry-run: params "
                 f"{dry['param_bytes'] / 1e9:.3f} + AdamW "
                 f"{dry['opt_bytes'] / 1e9:.3f}), each rank's shards equal "
                 f"to it; peak over the steps a card "
                 f"{[round(p / 1e9, 3) for p in peaks]} GB")
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return misses


def check_reshard(rank: int) -> None:
    """``reshard`` from (data, model) to (model, None) and
    ``reshard_params`` of a tree on a (2, 2) mesh of the four cards,
    values kept bit for bit."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.comm import resharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.utils.sharding import NamedSharding, P, placements

    mesh = make_local_mesh(model=2, data=2)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((4096, 4096), generator=g, device="cuda")
    t0 = time.perf_counter()
    a = distribute_tensor(x, mesh, placements(mesh, P("data", "model")))
    assert tuple(a.to_local().shape) == (2048, 2048)
    out = resharding.reshard({"w": a},
                             {"w": NamedSharding(mesh, P("model", None))})
    w = out["w"]
    assert tuple(w.placements) == (Replicate(), Shard(0)), w.placements
    assert tuple(w.to_local().shape) == (2048, 4096)
    assert torch.equal(w.full_tensor(), x)
    tree = resharding.reshard_params(
        {"b": x.clone(), "c": (x[0].clone(),)}, mesh,
        {"b": P(None, ("data", "model")), "c": (P(),)})
    assert tuple(tree["b"].to_local().shape) == (4096, 1024)
    assert torch.equal(tree["b"].full_tensor(), x)
    assert torch.equal(tree["c"][0].full_tensor(), x[0])
    torch.cuda.synchronize()
    rank_log(rank, f"reshard on a (2, 2) nccl mesh of the four cards: a "
             f"4096 x 4096 f32 from (data, model) to (model, None) and a "
             f"tree through reshard_params, bit for bit, "
             f"{time.perf_counter() - t0:.3f} s")


def rank_main(rank: int, port: int, phases: list) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.cluster import maybe_init_distributed

    no_tf32()
    torch.cuda.set_device(rank)
    _build.library()
    assert maybe_init_distributed(f"tcp://localhost:{port}", WORLD, rank,
                                  device=f"cuda:{rank}")
    misses = []
    try:
        if "layouts" in phases:
            misses += check_layouts(rank)
        if "kinds" in phases:
            misses += check_kinds(rank)
        if "layouts" in phases:
            misses += check_deep(rank)
            check_reshard(rank)
    finally:
        dist.destroy_process_group()
    assert not misses, f"layouts past their bars: {misses}"
    return 0


def layouts(phases: list) -> None:
    """Phases "layouts" and "kinds": the four rank processes, their output
    printed as it comes; any rank failing stops the others."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--port", str(port), "--phases", ",".join(phases)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    texts = ["" for _ in procs]
    try:
        import threading

        def pump(i, p):
            for line in p.stdout:
                texts[i] += line
                if i == 0 and line.startswith("layouts: "):
                    log(line.rstrip())

        pumps = [threading.Thread(target=pump, args=(i, p), daemon=True)
                 for i, p in enumerate(procs)]
        for t in pumps:
            t.start()
        deadline = time.time() + RANK_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                time.sleep(10)  # let the others report, then stop them
                break
            if time.time() > deadline:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in pumps:
            t.join(timeout=10)
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    for r, rc in bad:
        log(f"layouts: rank {r} exited {rc}:\n{texts[r][-4000:]}")
    assert not bad, f"layouts: ranks failed: {bad}"
    log(f"layouts: phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase "devices": one process, the four cards
# ---------------------------------------------------------------------------
def check_rebind() -> None:
    """A reduced f32 yi-9b ``RolloutWorker`` at temperature 0 on cuda:0,
    rebound to cuda:1: its tokens equal an unmoved worker's before and
    after, the move frees every byte of its engine (cache and weights)
    from cuda:0, and each card leg launches K1 once a layer a decode
    batch and K2 once a decode batch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.rl.workers import RolloutWorker
    from repro_torch.utils.treeutil import pytree_leaves

    cfg = get_config("yi-9b").reduced()
    prompts = np.random.default_rng(SEED).integers(
        3, cfg.vocab_size, (4, 16)).astype(np.int32)

    def worker(name):
        w = RolloutWorker(name, cfg=cfg, max_new_tokens=8, temperature=0.0,
                          devices=(0,), engine="paged", device="cuda")
        w.update_weights(init_model(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            torch.float32, "cuda:0"))
        return w

    still, w = worker("rollout/still"), worker("rollout/moved")
    want = [still.generate({"prompt_tokens": prompts})["tokens"]
            for _ in range(2)]

    def leg(tag: str, i: int, card: int) -> int:
        eng = w.engine
        assert eng.device == torch.device("cuda", card), eng.device
        b0 = eng.decode_batches
        zero_launches()
        out = w.generate({"prompt_tokens": prompts})["tokens"]
        torch.cuda.synchronize(card)
        batches = eng.decode_batches - b0
        k = launches()
        assert k[:2] == (cfg.num_layers * batches, batches), (tag, k,
                                                              batches)
        assert np.array_equal(out, want[i]), f"rebind {tag}: tokens differ"
        return batches

    t0 = time.perf_counter()
    n0 = leg("cuda:0", 0, 0)
    engine_bytes = sum(
        x.numel() * x.element_size()
        for x in pytree_leaves(w.engine.cache) + pytree_leaves(
            w.get_state("params")))
    gc.collect()
    before = torch.cuda.memory_allocated(0)
    w.bind_devices((1,), platform="cuda")
    gc.collect()
    freed = before - torch.cuda.memory_allocated(0)
    assert w.device == torch.device("cuda", 1), w.device
    assert w.engine.cache.k.device == torch.device("cuda", 1)
    assert freed >= engine_bytes, (freed, engine_bytes)
    n1 = leg("cuda:1", 1, 1)
    log(f"devices: rebind of a reduced f32 yi-9b rollout worker from "
        f"cuda:0 to cuda:1: tokens equal the unmoved worker's on both "
        f"legs; the move freed {freed / 1e6:.2f} MB of the engine's "
        f"{engine_bytes / 1e6:.2f} MB on cuda:0 "
        f"({100 * freed / engine_bytes:.1f} %); K1 {cfg.num_layers} x {n0} "
        f"and {cfg.num_layers} x {n1}, K2 {n0} and {n1}, exactly; "
        f"{time.perf_counter() - t0:.2f} s")
    still.shutdown()
    w.shutdown()


GRPO_LAYERS = 2  # of yi-9b's 48, full width, f32 + AdamW


def grpo_runner(mode: str, iterations: int, **kw):
    import torch

    from repro_torch.comm.primitives import reset_router
    from repro_torch.configs import get_config
    from repro_torch.core.placement import Cluster
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import AdamWConfig, TrainHParams

    reset_router()
    cfg = get_config("yi-9b").replace(num_layers=GRPO_LAYERS)
    rl = GRPOConfig(batch_size=16, group_size=4, prompt_len=8,
                    max_new_tokens=32, temperature=1.0,
                    iterations=iterations, profile_batches=(8, 16),
                    mode=mode, seed=SEED)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5), entropy_coef=0.01)
    cluster = Cluster(num_nodes=1,
                      devices_per_node=torch.cuda.device_count())
    return GRPORunner(cfg, rl, hp, cluster=cluster, **kw)


def counted_iteration(runner, it: int):
    """One iteration with its launches gated as ``chip_smoke.py``'s grpo
    phase gates them: (K1, K2, K3, K3bwd) = (layers x decode batches,
    decode batches, layers x (recompute passes + train forwards), layers
    x train steps)."""
    import torch

    zero_launches()
    d0 = runner.rollout.engine.decode_batches
    s0 = runner.sync_stats["seconds"]
    st = runner.run_iteration(it)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    k = launches()
    db = runner.rollout.engine.decode_batches - d0
    calls, stage_s = {}, {}
    for name, a, b, _ in runner.controller.last_timeline:
        calls[name] = calls.get(name, 0) + 1
        stage_s[name] = stage_s.get(name, 0.0) + (b - a)
    L = GRPO_LAYERS
    assert k == (L * db, db, L * (calls["inference"] + calls["actor"]),
                 L * calls["actor"]), (it, k, db, calls)
    assert st.metrics and all(math.isfinite(v)
                              for v in st.metrics.values()), st.metrics
    return st, k, db, stage_s, runner.sync_stats["seconds"] - s0


def check_grpo(mode: str) -> None:
    """``GRPORunner`` over the four cards: profile, plan, strict lint, two
    iterations (the auto run traced): each worker's card, launches
    exact, the sync across cards, the plan-vs-actual report."""
    import torch

    from repro_torch.analysis import analyze
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.report import plan_vs_actual

    tag = f"devices: grpo[{mode}]"
    t0 = time.perf_counter()
    runner = grpo_runner(mode, 2)
    runner.profile()
    runner.plan_execution()
    runner.controller.strict = True
    findings = analyze(runner.plan.graph, runner.plan,
                       cluster=runner.cluster,
                       cfg=runner.controller.scheduler_cfg,
                       cycle_specs=runner.cycle_specs())
    assert not [f for f in findings if f.severity == "error"], findings
    log(f"{tag}: yi-9b full width {GRPO_LAYERS} layers f32 + AdamW over "
        f"Cluster(1, {torch.cuda.device_count()}); profiled and planned "
        f"in {time.perf_counter() - t0:.1f} s; strict lint "
        f"{len(findings)} finding(s)")
    for line in runner.plan.pretty().splitlines():
        log(f"{tag}: plan: {line}")
    tracer = obs_trace.install() if mode != "collocated" else None
    cards = {}
    for it in range(runner.rl.iterations):
        st, k, db, stage_s, sync_s = counted_iteration(runner, it)
        for name, w in runner.workers.items():
            cards.setdefault(name, set()).add(str(w.device))
        log(f"{tag}: iteration {it}: wall {st.wall_time:.3f} s (sync "
            f"{sync_s:.4f} s); stages "
            + ", ".join(f"{n} {s:.3f} s" for n, s in stage_s.items())
            + f"; launches K1={k[0]} K2={k[1]} K3={k[2]} K3bwd={k[3]} "
            f"({db} decode batches)")
    placed = {n: (runner.workers[n].devices, sorted(c))
              for n, c in cards.items()}
    log(f"{tag}: placements (device ids, cards): "
        + "; ".join(f"{n} {ids} on {c}" for n, (ids, c) in placed.items()))
    sync = runner.sync_stats
    log(f"{tag}: weight sync {sync['syncs']} x: {sync['seconds']:.4f} s, "
        f"{sync['bytes'] / 1e9:.3f} GB in all")
    if tracer is not None:
        obs_trace.uninstall()
        report = plan_vs_actual(runner.plan, runner.controller.profiles,
                                tracer, runner.rl.batch_size,
                                iterations=runner.rl.iterations)
        for line in report.format().splitlines():
            log(f"{tag}: plan-vs-actual: {line}")
        log(f"{tag}: plan-vs-actual: predicted {report.predicted_wall:.4f}"
            f" s, measured {report.measured_wall:.4f} s (x"
            f"{report.wall_ratio:.3f}), bubble fraction "
            f"{report.bubble_fraction():.4f}")
    runner.teardown()
    del runner
    gc.collect()


def check_recover() -> None:
    """Kill and recover over the four cards: a runner takes one iteration
    (a checkpoint after it), a second resumes from it for three with the
    rollout killed at iteration 1 and recovers, a baseline resumes from
    a copy of the checkpoint: one recovery, equal rewards and the final
    actor params bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.utils.treeutil import pytree_leaves

    tmp = tempfile.mkdtemp(prefix="recover-")
    t0 = time.perf_counter()
    try:
        ck, ck_base = f"{tmp}/ck", f"{tmp}/ck-baseline"
        warm = grpo_runner("collocated", 1, checkpoint_dir=ck,
                           checkpoint_every=1)
        warm.run(verbose=False)
        warm.teardown()
        del warm
        shutil.copytree(ck, ck_base)
        inj = FaultInjector(FaultSpec("rollout", iteration=1))
        faulted = grpo_runner("collocated", 3, checkpoint_dir=ck,
                              checkpoint_every=1, fault_injector=inj)
        faulted.run(verbose=False)
        assert inj.fired and faulted.recoveries == 1, faulted.recoveries
        rec = dict(faulted.recovery_seconds)
        cards = sorted({str(w.device) for w in faulted.workers.values()})
        base = grpo_runner("collocated", 3, checkpoint_dir=ck_base,
                           checkpoint_every=0)
        base.run(verbose=False)
        got = [s for s in faulted.stats if s.iteration >= 1]
        want = [s for s in base.stats if s.iteration >= 1]
        assert [s.iteration for s in got] == [s.iteration for s in want]
        for g, w in zip(got, want):
            for f in ("mean_reward", "accuracy"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=1e-4, atol=1e-5, err_msg=f)
        diff = max((a - b).abs().max().item() for a, b in zip(
            pytree_leaves(faulted.actor.params()),
            pytree_leaves(base.actor.params())))
        assert diff == 0, ("recover: final actor params differ from the "
                           f"baseline's by {diff}")
        for r in (faulted, base):
            r.teardown()
        del faulted, base
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    log(f"devices: recover over Cluster(1, {torch.cuda.device_count()}), "
        f"workers on {cards}: the rollout killed at iteration 1, recovered "
        f"once in {sum(rec.values()):.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in rec.items())
        + "); rewards and accuracy equal the fresh resume's (rtol 1e-4), "
        f"final actor params bit for bit; {time.perf_counter() - t0:.1f} s")


def devices() -> None:
    t0 = time.perf_counter()
    no_tf32()
    check_rebind()
    check_grpo("collocated")
    check_grpo("auto")
    check_recover()
    log(f"devices: phase took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/multicard_smoke.py")
    ap.add_argument("--phases", default="layouts,kinds,devices")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.port, args.phases.split(","))
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        log("multicard_smoke: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        log(f"multicard_smoke: needs {WORLD} CUDA devices; this script "
            "runs only on cards")
        return 1
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        log(f"multicard_smoke: the repro_torch package is missing ({e}); "
            "run from the repository root")
        return 1
    cards = card_lines()
    t0 = time.perf_counter()
    so = _build.build()
    log(f"header: {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; kernels built in "
        f"{time.perf_counter() - t0:.1f} s -> {so.name}")
    phases = args.phases.split(",")
    ranked = [p for p in phases if p in ("layouts", "kinds")]
    if ranked:
        layouts(ranked)
    if "devices" in phases:
        _build.library()
        devices()
    log(f"multicard_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the kernels' build "
        "included")
    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
