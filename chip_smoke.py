#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (more for the kernels):
  1. header     the card's name and power limit, and the kernel build time;
  2. kernels    each hand-written kernel against its plain PyTorch version
                at yi-9b's shapes, with CUDA-event timings: paged attention
                and sampling (decode), flash attention forward and backward
                (checked at B=4 with a tail and a window, then checked and
                timed at the recompute's and the train microbatch's shapes);
  3. ref        a reduced yi-9b served on the card and on the CPU from the
                same weights: the same tokens, at temperature 0 and above;
  4. ref-train  the same reduced yi-9b in f32: recomputed logprobs and one
                train step (two microbatches) on the card against the CPU,
                and the engine's logprobs against the recompute;
  5. serve      yi-9b at full width (48 layers, random bf16 weights) through
                ``PagedEngine``: 16 requests, tokens/s, and the kernels'
                launch counters read around the run;
  6. greedy     the same requests twice at temperature 0: identical tokens;
  7. recompute  16 rollouts of 448 + 64 tokens from the engine, scored by
                ``make_prefill_step`` at full depth: tokens/s (median of
                five passes), flash launches, and the train-inference
                logprob mismatch, gated;
  8. train      yi-9b at full width cut to 8 layers, f32 params and AdamW:
                three GRPO steps of 4 x 1024 tokens in two microbatches,
                step time, peak memory and flash launches per step.

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before it a JSON object with every kernel's numbers, and
the last ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without that line.  Float32 products run
without TF32 throughout.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, n: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``n`` back-to-back calls,
    between two CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / n)
    return statistics.median(means)


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_paged_attention(dtype, results: dict) -> None:
    import torch

    from repro_torch.kernels import paged_attention as pa

    B, H, KV, D, page, nb = 8, 32, 4, 128, 16, 64
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    P = B * nb + 1
    lens = torch.tensor([0, 1, 17, 128, 333, 512, 777, 1024],
                        dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    # rotate over enough pools to exceed the 50 MB L2, as 48 layers do
    pool_bytes = 2 * P * page * KV * D * torch.finfo(dtype).bits // 8
    n_pools = max(1, math.ceil(128e6 / pool_bytes))
    pools = [(torch.randn((P, page, KV, D), generator=g, device=dev)
              .to(dtype),
              torch.randn((P, page, KV, D), generator=g, device=dev)
              .to(dtype)) for _ in range(n_pools)]
    # poison the trash page: it must never reach the output
    for kp, vp in pools:
        kp[0].fill_(1e3)
        vp[0].fill_(1e3)
    kp, vp = pools[0]
    got = pa.paged_attention_bhd(q, kp, vp, tables, lens)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # f32: summation order only; bf16: both round the same f32 result
    # once, so at most a couple of bf16 ulps at |out| <= ~1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(got).all(), "paged attention: non-finite output"
    assert got[0].abs().max().item() == 0.0, "empty context must give zeros"
    assert err <= tol, f"paged attention {dtype}: max |err| {err} > {tol}"
    it = iter(range(1 << 30))

    def kernel():
        kp_, vp_ = pools[next(it) % n_pools]
        pa.paged_attention_bhd(q, kp_, vp_, tables, lens)

    def plain():
        kp_, vp_ = pools[next(it) % n_pools]
        pa.paged_attention_plain(q, kp_, vp_, tables, lens)

    ms, plain_ms = time_ms(kernel), time_ms(plain)
    ctx = int(lens.sum())
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * ctx * KV * D * elem + 2 * B * H * D * elem
              + B * 4 * (1 + -(-1024 // page)))
    ops = 4 * ctx * H * D
    bms, by = bound_ms(nbytes, ops, str(dtype).split(".")[-1])
    name = str(dtype).split(".")[-1]
    log(f"kernels: paged_attention {name} B={B} H={H} KV={KV} D={D} "
        f"page={page} ctx={lens.tolist()} max|err|={err:.3g} (tol {tol}) "
        f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms bound={bms:.4f} ms "
        f"({by})")
    if dtype == torch.bfloat16:  # the main path's type
        results["paged_attention"] = dict(
            name="paged_attention_bhd", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:79",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None)


def check_fused_sample(results: dict) -> None:
    import torch

    from repro_torch.kernels import sampling as ks
    from repro_torch.serve.sampling import request_noise

    B, V, vocab = 8, 65536, 64000
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
    seeds = torch.arange(B, device=dev) * 7919
    positions = torch.arange(B, device=dev) + 300
    gumbel = request_noise(seeds, positions, V)
    for temp, k, p in ((0.0, 0, 1.0), (1.0, 50, 0.9)):
        kw = dict(temperature=temp, top_k=k, top_p=p, vocab_size=vocab)
        tok, lp = ks.fused_sample_bv(logits, gumbel, **kw)
        want_tok, want_lp = ks.fused_sample_plain(logits, gumbel, **kw)
        torch.cuda.synchronize()
        assert torch.equal(tok, want_tok), (
            f"fused sample T={temp}: tokens {tok.tolist()} != "
            f"{want_tok.tolist()}")
        assert bool((tok < vocab).all()), "sampled a padded-vocab token"
        err = (lp - want_lp).abs().max().item()
        # |logprob| ~ 10-20: f32 sums over 65536 entries in another order
        tol = 1e-4
        assert err <= tol, f"fused sample T={temp}: |lp err| {err} > {tol}"
        ms = time_ms(lambda: ks.fused_sample_bv(logits, gumbel, **kw))
        plain_ms = time_ms(lambda: ks.fused_sample_plain(logits, gumbel,
                                                         **kw), n=5)
        nbytes = B * V * 4 * (2 if temp > 0 else 1) + B * 8
        # ~10 f32 operations per vocab entry: mask, max, exp, sum, scale,
        # compare, noise add, argmax
        bms, by = bound_ms(nbytes, 10 * B * V, "float32")
        log(f"kernels: fused_sample B={B} V={V} T={temp} top_k={k} "
            f"top_p={p} tokens equal, max|lp err|={err:.3g} (tol {tol}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"bound={bms:.5f} ms ({by})")
        if temp > 0:  # the main path's configuration
            results["fused_sample"] = dict(
                name="fused_sample_bv", route="cuda",
                source="src/repro_torch/kernels/csrc/sampling.cu",
                replaces="src/repro/kernels/sampling.py:125",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# grads, relative to the largest |grad|: f32 summation order; bf16 rounds
# inputs and outputs, and delta = rowsum(dO * O) reads the bf16 O
FLASH_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


FLASH_H, FLASH_KV, FLASH_D = 32, 4, 128  # yi-9b's heads


def flash_case(g, dtype, B: int, S: int, window: int, backward: bool):
    """K3 at yi-9b's heads, causal, against its plain version, on
    (B, H, S, D) views of model-layout (B, S, H, D) tensors as
    ``ops.flash_attention`` passes them; with ``backward`` also dq, dk and
    dv against autograd of the plain version for a random output
    gradient.  Returns the inputs and outputs of both and the log line."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    H, KV, D = FLASH_H, FLASH_KV, FLASH_D
    name = str(dtype).split(".")[-1]
    q, k, v, dout = (torch.randn((B, S, h, D), generator=g, device="cuda")
                     .to(dtype).transpose(1, 2) for h in (H, KV, KV, H))
    kw = dict(causal=True, window=window)
    out, lse = fa.flash_attention_bhsd(q, k, v, **kw)
    leaves = [t.detach().requires_grad_(backward) for t in (q, k, v)]
    want, want_lse = fa.flash_attention_plain(*leaves, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    tol = FLASH_TOL[name]
    tag = f"flash {name} B={B} S={S} w={window}"
    assert err <= tol, f"{tag} fwd: max|err| {err} > {tol}"
    assert lse_err <= 1e-4, f"{tag} lse: max|err| {lse_err}"
    case = dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse, leaves=leaves,
                want=want, err=err, line=(
                    f"kernels: flash_attention {name} B={B} H={H} KV={KV} "
                    f"S={S} D={D} causal window={window} (model layout): "
                    f"fwd max|err|={err:.3g} (tol {tol}), lse "
                    f"{lse_err:.3g}"))
    if not backward:
        return case
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want_grads = torch.autograd.grad(want, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    rel = []
    for gname, got, ref in zip("qkv", grads, want_grads):
        assert torch.isfinite(got).all(), f"{tag} d{gname} non-finite"
        scale = ref.float().abs().max().item()
        rel.append((got.float() - ref.float()).abs().max().item() / scale)
        assert rel[-1] <= FLASH_GRAD_RTOL[name], (
            f"{tag} bwd d{gname}: max|err| / max|grad| = {rel[-1]} > "
            f"{FLASH_GRAD_RTOL[name]}")
    case["grad_err"] = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(grads, want_grads))
    case["line"] += (f"; bwd max|err|/max|grad| dq {rel[0]:.3g} dk "
                     f"{rel[1]:.3g} dv {rel[2]:.3g} "
                     f"(tol {FLASH_GRAD_RTOL[name]})")
    return case


def flash_bounds(dtype, B: int, S: int):
    """(forward, backward) bounds of causal K3 at yi-9b's heads: each a
    (ms, 'bytes' or 'operations') pair."""
    import torch

    H, KV, D = FLASH_H, FLASH_KV, FLASH_D
    name = str(dtype).split(".")[-1]
    elem = torch.finfo(dtype).bits // 8
    # live (query, key) pairs of this mask; 2 * D flops per pair and
    # product: forward QK^T and PV, backward S, dP, dV, dK and dQ
    pairs = S * (S + 1) // 2
    act = B * H * S * D * elem
    kv_bytes = 2 * B * KV * S * D * elem
    # forward: reads q, k, v; writes out, lse.  Backward: reads q, out,
    # dO, k, v, lse; writes dq, dk, dv
    return (bound_ms(2 * act + kv_bytes + 4 * B * H * S,
                     4 * B * H * D * pairs, name),
            bound_ms(4 * act + 2 * kv_bytes + 4 * B * H * S,
                     10 * B * H * D * pairs, name))


def check_flash_attention(results: dict) -> None:
    """K3 forward and backward against the plain version: at B=4, S=1024,
    S=1000 (a tail) and S=1024 with window 256, in f32 and bf16; then at
    the main paths' own shapes, where it is also timed beside the plain
    version and ``scaled_dot_product_attention``: the recompute's forward
    (B=16, S=512, bf16) and the train microbatch's forward and backward
    (B=2, S=1024, f32)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for dtype in (torch.float32, torch.bfloat16):
        for S, window in ((1024, 0), (1000, 0), (1024, 256)):
            log(flash_case(g, dtype, 4, S, window, backward=True)["line"])
    torch.cuda.empty_cache()
    common = dict(route="cuda", launches=0,
                  replaces="src/repro/kernels/flash_attention.py:79")
    for dtype, B, S, backward in ((torch.bfloat16, 16, 512, False),
                                  (torch.float32, 2, 1024, True)):
        c = flash_case(g, dtype, B, S, 0, backward)
        q, k, v, dout, out, lse = (c[n] for n in ("q", "k", "v", "dout",
                                                  "out", "lse"))
        # the library call on contiguous copies of the same inputs
        lib = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*lib, is_causal=True,
                                                  enable_gqa=True)

        ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=True))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=True), n=5)
        with torch.no_grad():
            lib_ms = time_ms(sdpa)
        (fwd_bound, fwd_by), (bwd_bound, bwd_by) = flash_bounds(dtype, B, S)
        line = (f"{c['line']}; fwd kernel={ms:.4f} ms plain={plain_ms:.4f} "
                f"ms sdpa={lib_ms:.4f} ms bound={fwd_bound:.4f} ms "
                f"({fwd_by})")
        if not backward:  # the recompute's shape and type
            log(line)
            results["flash_fwd"] = dict(
                common, name="flash_attention_bhsd",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                max_abs_err=c["err"], ms=ms, plain_ms=plain_ms,
                bound_ms=fwd_bound, bound_by=fwd_by, library_ms=lib_ms)
            del c, lib
            torch.cuda.empty_cache()
            continue
        bwd_ms = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=True))
        want, leaves = c["want"], c["leaves"]
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            want, leaves, dout, retain_graph=True), n=5)
        lib_out = sdpa()
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, lib, dout, retain_graph=True))
        lib_both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), lib, dout))
        log(f"{line}; bwd kernel={bwd_ms:.4f} ms plain={plain_bwd_ms:.4f} "
            f"ms sdpa bwd={lib_bwd_ms:.4f} ms sdpa fwd+bwd="
            f"{lib_both_ms:.4f} ms bound={bwd_bound:.4f} ms ({bwd_by})")
        results["flash_bwd"] = dict(  # the train microbatch's shape and type
            common, name="flash_attention_bwd",
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            max_abs_err=c["grad_err"], ms=bwd_ms, plain_ms=plain_bwd_ms,
            bound_ms=bwd_bound, bound_by=bwd_by, library_ms=lib_bwd_ms)
        del c, lib, lib_out, want, leaves
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the CPU
# ---------------------------------------------------------------------------
def check_reference() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.utils.treeutil import tree_map
    from repro_torch.serve import PagedEngine

    cfg = get_config("yi-9b").reduced()
    cpu_params = init_model(torch.Generator().manual_seed(SEED), cfg,
                            torch.float32, "cpu")
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(3, cfg.vocab_size, size=(6, 23))
    for temp, k, p in ((0.0, 0, 1.0), (1.0, 8, 0.9)):
        out = {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = PagedEngine(cfg, max_batch=4, page_size=4, max_new_tokens=12,
                              temperature=temp, top_k=k, top_p=p,
                              prefill_chunk=8, device=dev)
            out[dev] = eng.generate(params, prompts, seed=SEED)
        a, b = out["cuda"], out["cpu"]
        assert torch.equal(a.tokens, b.tokens), "card and CPU tokens differ"
        err = (a.logprobs - b.logprobs).abs().max().item()
        assert err <= 1e-3, f"card and CPU logprobs differ by {err}"
        log(f"ref: reduced yi-9b f32 T={temp} top_k={k} top_p={p}: card "
            f"tokens == CPU tokens, max|lp diff|={err:.3g} (tol 1e-3)")


def grpo_batch(rng, tokens, prompt_len: int, group_size: int):
    """A GRPO batch around ``tokens`` (B, S) on their device: loss mask on
    the response, group-relative advantages from seeded rewards, behaviour
    and reference logprobs filled in by the caller."""
    import numpy as np
    import torch

    from repro_torch.rl.advantage import broadcast_to_tokens, grpo_advantages

    B, S = tokens.shape
    mask = np.zeros((B, S), np.float32)
    mask[:, prompt_len:] = 1.0
    adv = grpo_advantages(rng.random(B).astype(np.float32), group_size)
    dev = tokens.device
    return {"tokens": tokens,
            "loss_mask": torch.from_numpy(mask).to(dev),
            "advantages": torch.from_numpy(
                broadcast_to_tokens(adv, mask)).to(dev)}


def check_ref_train() -> None:
    """Reduced yi-9b in f32 from the same weights on the card and the CPU:
    recomputed logprobs, and one train step with two microbatches (clip,
    entropy and KL terms on).  Then, on the card, the engine's behaviour
    logprobs against the recompute of the same tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import PagedEngine
    from repro_torch.train import (AdamWConfig, TrainHParams, init_adamw,
                                   make_prefill_step, make_train_step)
    from repro_torch.utils.treeutil import tree_leaves, tree_map

    cfg = get_config("yi-9b").reduced()
    cpu_params = init_model(torch.Generator().manual_seed(SEED + 1), cfg,
                            torch.float32, "cpu")
    rng = np.random.default_rng(SEED + 1)
    B, S, P = 4, 100, 40  # S is no multiple of the kernels' 64-row tiles
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    prefill = make_prefill_step(cfg)
    lp_cpu = prefill(cpu_params, {"tokens": tokens})
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    lp_gpu = prefill(gpu_params, {"tokens": tokens.cuda()}).cpu()
    lp_err = (lp_gpu - lp_cpu).abs().max().item()
    # f32 both sides: cuBLAS and the CPU sum in other orders
    assert lp_err <= 1e-4, f"recompute: card vs CPU logprobs differ {lp_err}"

    batch = grpo_batch(rng, tokens, P, group_size=4)
    noise = torch.from_numpy(0.2 * rng.standard_normal((B, S))).float()
    batch["old_logprobs"] = lp_cpu + noise  # clipping becomes active
    batch["ref_logprobs"] = lp_cpu - noise
    lr = 1e-3
    hp = TrainHParams(optimizer=AdamWConfig(lr=lr, weight_decay=0.01),
                      n_microbatches=2, entropy_coef=0.01, kl_coef=0.1)
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        opt = init_adamw(params)
        params, opt, m = make_train_step(cfg, hp)(
            params, opt, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (tree_map(lambda t: t.cpu(), params),
                    tree_map(lambda t: t.cpu(), opt.mu),
                    {k: float(v) for k, v in m.items()})
    (gp, gmu, gm), (cp, cmu, cm) = out["cuda"], out["cpu"]
    for k in cm:
        assert math.isfinite(gm[k]), (k, gm[k])
        assert abs(gm[k] - cm[k]) <= 1e-6 + 1e-4 * abs(cm[k]), (k, gm[k],
                                                                 cm[k])
    # first Adam step ~ lr * sign(g): params may flip by 2 lr where g ~ 0;
    # the first moment is (1 - b1) * clipped g and is compared tightly
    p_err = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(gp), tree_leaves(cp)))
    mu_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
                 .item() for a, b in zip(tree_leaves(gmu), tree_leaves(cmu)))
    assert p_err <= 2 * lr, f"train step: params differ by {p_err}"
    assert mu_err <= 1e-3, f"train step: first moments differ by {mu_err}"

    eng = PagedEngine(cfg, max_batch=4, page_size=4, max_new_tokens=12,
                      temperature=1.0, top_k=8, top_p=0.9, eos_token=-1,
                      prefill_chunk=8, device="cuda")
    res = eng.generate(gpu_params, rng.integers(3, cfg.vocab_size, (4, 23)),
                       seed=SEED)
    lp = prefill(gpu_params, {"tokens": res.tokens.cuda()}).cpu()
    mis = (lp[:, 23:] - res.logprobs[:, 23:]).abs().max().item()
    assert mis <= 2e-4, f"engine vs recompute logprobs differ by {mis}"
    log(f"ref-train: reduced yi-9b f32 B={B} S={S}: recompute card vs CPU "
        f"max|lp diff|={lp_err:.3g} (tol 1e-4); train step (2 microbatches, "
        f"clip+entropy+KL) loss {gm['loss']:.6f} vs {cm['loss']:.6f}, "
        f"grad_norm {gm['grad_norm']:.6f} vs {cm['grad_norm']:.6f} "
        f"(rtol 1e-4), params max|diff|={p_err:.3g} (tol 2 lr = {2 * lr}), "
        f"mu max rel diff={mu_err:.3g} (tol 1e-3); engine vs recompute on "
        f"the card max|lp diff|={mis:.3g} (tol 2e-4)")


# ---------------------------------------------------------------------------
# phases 5-6: yi-9b at full width
# ---------------------------------------------------------------------------
def serve_once(cfg, params, prompts, *, temperature, top_k, top_p):
    import torch

    from repro_torch.serve import PagedEngine

    eng = PagedEngine(cfg, max_batch=8, page_size=16, prefill_chunk=256,
                      max_new_tokens=64, max_seq_len=1024,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_token=-1, dtype=torch.bfloat16, device="cuda")
    eng.set_params(params)
    eng.submit(prompts[0][:64], max_new_tokens=4, seed=99)  # warm-up
    eng.run()
    torch.cuda.synchronize()
    return eng


def serve(cfg, params, prompts, results: dict) -> None:
    import torch

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as ks

    eng = serve_once(cfg, params, prompts, temperature=1.0, top_k=50,
                     top_p=0.9)
    reqs = [eng.submit(p, seed=SEED + i) for i, p in enumerate(prompts)]
    b0 = eng.decode_batches
    pa.paged_attention_bhd.launches = 0
    ks.fused_sample_bv.launches = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = pa.paged_attention_bhd.launches, ks.fused_sample_bv.launches
    batches = eng.decode_batches - b0
    for r in reqs:
        assert len(r.generated) == 64, (r.rid, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated), r.rid
        assert all(math.isfinite(x) and x <= 1e-3 for x in r.logprobs), r.rid
    assert batches > 0
    assert k1 == cfg.num_layers * batches, (k1, batches)
    assert k2 == batches, (k2, batches)
    n_tok = sum(len(r.generated) for r in reqs)
    n_prompt = sum(len(p) for p in prompts)
    log(f"serve: yi-9b full width ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"bf16) {len(reqs)} requests, {n_prompt} prompt + {n_tok} generated "
        f"tokens in {wall:.3f} s = {n_tok / wall:.1f} generated tok/s; "
        f"{batches} decode batches; launches paged_attention={k1} "
        f"(= {cfg.num_layers} x {batches}), fused_sample={k2}; "
        f"card: {card_line()}")
    results["paged_attention"]["launches"] = k1
    results["fused_sample"]["launches"] = k2
    breakdown(eng, prompts)
    del eng


def profiled(fn, reps: int = 1):
    """(kernel name, device s per call, launches per call) for every CUDA
    kernel of ``reps`` calls of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / reps / 1e6, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def log_breakdown(tag: str, what: str, wall: float, rows, kernels) -> None:
    """The device's busy and idle share of ``wall`` seconds, the time of
    each of ``kernels`` (substrings of kernel names) and the eight
    kernels that take the most of it."""
    busy = sum(t for _, t, _ in rows)
    if not busy:
        log(f"{tag}: the profiler saw no device time (not measured)")
        return
    share = ", ".join(
        f"{name} {sum(t for k, t, _ in rows if name in k) * 1e3:.3f} ms"
        for name in kernels)
    log(f"{tag}: {what}: {wall * 1e3:.2f} ms host wall; device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% busy, "
        f"{100 - 100 * busy / wall:.1f}% idle) in "
        f"{sum(c for *_, c in rows):.0f} kernels; {share}")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"{tag}:   {t * 1e3:8.3f} ms {100 * t / busy:5.1f}% "
            f"x{count:<4.0f} {key[:90]}")


FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel", "flash_bwd_delta_kernel")


def breakdown(eng, prompts, steps: int = 8) -> None:
    """Where a decode batch's time goes, at full batch (8 requests
    mid-generation, decode only): host wall per step over ``steps``
    unprofiled steps, then ``torch.profiler`` over as many more for the
    device time of every CUDA kernel, the busy and idle share of the
    device, and the kernels that take the most of it."""
    import torch

    for i, p in enumerate(prompts[:eng.max_batch]):
        eng.submit(p[:64], max_new_tokens=2 * steps + 4, seed=1000 + i)
    while any(r.num_cached < r.prompt_len
              for r in eng.scheduler.active_requests()) \
            or eng.scheduler.waiting:
        eng.step()  # admission and prefill, outside the windows
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    rows = profiled(eng.step, steps)
    eng.run()
    log_breakdown("breakdown", f"decode step at batch {eng.max_batch}", wall,
                  rows, ("paged_attention_kernel", "fused_sample_kernel"))


def greedy_repeat(cfg, params, prompts) -> None:
    import torch

    runs = []
    for _ in range(2):
        eng = serve_once(cfg, params, prompts, temperature=0.0, top_k=0,
                         top_p=1.0)
        reqs = [eng.submit(p, seed=SEED + i) for i, p in enumerate(prompts)]
        eng.run()
        runs.append([r.generated for r in reqs])
        del eng
        torch.cuda.empty_cache()
    assert runs[0] == runs[1], "greedy repeat gave different tokens"
    log(f"greedy: {len(prompts)} requests x 64 tokens, two runs at "
        f"temperature 0: identical tokens")


# ---------------------------------------------------------------------------
# phases 7-8: logprob recompute and training at full width
# ---------------------------------------------------------------------------
# engine vs recompute logprobs in bf16, over the generated tokens: the
# decode path (paged, one token at a time) and the full-sequence path
# round the bf16 activations of 48 layers differently, and one bf16
# rounding is already 2**-9 relative, so a limit near 1e-3 cannot hold.
# On an H100 the reading is mean 0.0074, max 0.031; the limits leave
# about 3x room and still fail on a wrong attention or logprob.
MISMATCH_MEAN_TOL, MISMATCH_MAX_TOL = 0.02, 0.1


def recompute(cfg, params, results: dict, passes: int = 5) -> None:
    """Step 2 of a GRPO iteration: the engine generates 16 rollouts
    (448-token prompts + 64 new tokens, S = 512) and ``make_prefill_step``
    scores them at full depth in bf16: one warm-up pass, then ``passes``
    timed passes, each with 48 K3 launches; the median is reported."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import PagedEngine
    from repro_torch.train import make_prefill_step

    B, P, N = 16, 448, 64
    prompts = np.random.default_rng(SEED + 3).integers(3, cfg.vocab_size,
                                                       (B, P))
    eng = PagedEngine(cfg, max_batch=B, page_size=16, prefill_chunk=512,
                      max_new_tokens=N, max_seq_len=P + N, temperature=1.0,
                      top_k=50, top_p=0.9, eos_token=-1,
                      dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    res = eng.generate(params, prompts, seed=SEED)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    tokens = res.tokens.cuda()
    assert tokens.shape == (B, P + N)
    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens}
    prefill(params, batch)  # warm-up at the timed shape
    torch.cuda.synchronize()
    walls, k3 = [], 0
    for _ in range(passes):
        fa.flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        lp = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        n = fa.flash_attention_bhsd.launches
        assert n == cfg.num_layers, (n, cfg.num_layers)
        k3 += n
    wall = statistics.median(walls)
    assert lp.shape == (B, P + N)
    assert torch.isfinite(lp).all(), "recompute: non-finite logprobs"
    gap = (lp[:, P:].cpu() - res.logprobs[:, P:]).abs()
    mean_gap, max_gap = gap.mean().item(), gap.max().item()
    assert mean_gap <= MISMATCH_MEAN_TOL, (
        f"engine vs recompute: mean|diff| {mean_gap} > {MISMATCH_MEAN_TOL}")
    assert max_gap <= MISMATCH_MAX_TOL, (
        f"engine vs recompute: max|diff| {max_gap} > {MISMATCH_MAX_TOL}")
    log(f"recompute: yi-9b full width ({cfg.num_layers} layers, bf16) "
        f"{B} x {P + N} tokens ({B} rollouts generated in {gen_s:.2f} s) "
        f"scored in {wall * 1e3:.1f} ms (median of {passes} passes: "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f" ms) = {B * (P + N) / wall:.0f} tok/s; flash_attention_bhsd "
        f"launches={k3} (= {cfg.num_layers} layers x {passes} passes); "
        f"engine vs recompute logprobs on the {B * N} generated tokens: "
        f"mean|diff|={mean_gap:.4g} (tol {MISMATCH_MEAN_TOL}) "
        f"max|diff|={max_gap:.4g} (tol {MISMATCH_MAX_TOL}); card: "
        f"{card_line()}")
    results["flash_fwd"]["launches"] += k3
    log_breakdown("recompute", f"one scoring pass of {B} x {P + N} tokens",
                  wall, profiled(lambda: prefill(params, batch)),
                  FLASH_KERNELS[:1])


def train(cfg_full, results: dict, layers: int = 8, steps: int = 3) -> None:
    """Step 4 of a GRPO iteration at full width: f32 params with AdamW, as
    the actor holds them, 4 sequences x 1024 tokens (512 prompt + 512
    response) in two microbatches, GRPO advantages from seeded rewards in
    groups of 4.  Depth is cut: the f32 params, two moments, the gradient
    and its accumulator take 20 bytes per parameter, and 48 layers (8.8 B
    parameters) would need 176 GB."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_model
    from repro_torch.train import (AdamWConfig, TrainHParams, init_adamw,
                                   make_prefill_step, make_train_step)
    from repro_torch.utils.treeutil import tree_leaves

    cfg = cfg_full.replace(num_layers=layers)
    B, P, R = 4, 512, 512
    params = init_model(torch.Generator(device="cuda").manual_seed(SEED + 4),
                        cfg, torch.float32, "cuda")
    opt = init_adamw(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (B, P + R))).cuda()
    batch = grpo_batch(rng, tokens, P, group_size=4)
    batch["old_logprobs"] = make_prefill_step(cfg)(params,
                                                   {"tokens": tokens})
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5), n_microbatches=2)
    step = make_train_step(cfg, hp)
    before = params["layers"]["attn"]["wq"][0, :64, 0].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, fwd, bwd = [], 0, 0
    for i in range(steps):
        fa.flash_attention_bhsd.launches = 0
        fa.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        f, b = fa.flash_attention_bhsd.launches, fa.flash_attention_bwd.launches
        assert f == layers * hp.n_microbatches, (f, layers)
        assert b == layers * hp.n_microbatches, (b, layers)
        fwd, bwd = fwd + f, bwd + b
        m = {k: float(v) for k, v in m.items()}
        assert all(math.isfinite(x) for x in m.values()), m
        log(f"train: step {i}: {times[-1] * 1e3:.1f} ms = "
            f"{B * (P + R) / times[-1]:.0f} tok/s; flash launches fwd={f} "
            f"bwd={b} (= {layers} layers x {hp.n_microbatches} "
            f"microbatches); " + ", ".join(f"{k}={v:.5g}"
                                           for k, v in sorted(m.items())))
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = params["layers"]["attn"]["wq"][0, :64, 0]
    assert not torch.equal(before, after), "train: params did not change"
    log(f"train: yi-9b full width cut to {layers} of {cfg_full.num_layers} "
        f"layers ({n_params / 1e9:.3f} B params, f32 + AdamW), {B} x "
        f"{P + R} tokens in {hp.n_microbatches} microbatches: median step "
        f"{statistics.median(times) * 1e3:.1f} ms = "
        f"{B * (P + R) / statistics.median(times):.0f} tok/s; peak memory "
        f"{peak:.2f} GB (max_memory_allocated); card: {card_line()}")
    results["flash_fwd"]["launches"] += fwd
    results["flash_bwd"]["launches"] += bwd
    log_breakdown("train", "one step (a fourth, profiled)",
                  statistics.median(times),
                  profiled(lambda: step(params, opt, batch)), FLASH_KERNELS)


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 1
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.models import init_model
        from repro_torch.utils.treeutil import tree_leaves
    except ImportError as e:
        log(f"chip_smoke: the repro_torch package is missing ({e}); run "
            "from the repository root")
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    so = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log(f"header: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; kernels "
        f"built in {build_s:.1f} s -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"header: ptxas {line.strip()}")

    results: dict = {}
    check_paged_attention(torch.float32, results)
    check_paged_attention(torch.bfloat16, results)
    check_fused_sample(results)
    check_flash_attention(results)
    check_reference()
    check_ref_train()

    cfg = get_config("yi-9b")
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(SEED),
                        cfg, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    log(f"serve: init_model yi-9b bf16 {gb:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(64, 513, size=16)]
    serve(cfg, params, prompts, results)
    greedy_repeat(cfg, params, prompts)
    recompute(cfg, params, results)
    del params  # free the 17.7 GB of serve weights before training
    torch.cuda.empty_cache()
    train(cfg, results)

    kernels = [results[k] for k in ("paged_attention", "fused_sample",
                                    "flash_fwd", "flash_bwd")]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
