#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (more for the kernels):
  1. header     the card's name and power limit, the kernel build time,
                every kernel's registers and spills, that the bf16
                kernels of K3's forward and K4, both K6 forwards, K6's
                backward and K3's backward run their products on the
                tensor cores (HGMMA, HMMA in every instance's SASS), and
                that they spill nothing;
  2. kernels    each hand-written kernel against its plain PyTorch version
                at the four models' shapes, with CUDA-event timings (the
                profiler's device time for the kernels that run shorter
                than their launch takes the host, and beside the events
                for K2 and K6): paged attention and sampling (decode;
                sampling at all four vocabularies), flash attention forward and
                backward (checked at B=4 with a tail and a window, then
                checked and timed at the recompute's and the train
                microbatch's shapes, zamba2's D=80 heads and window and
                stablelm-12b's D=160 heads among them), the grouped
                expert matmul and the drop-free MoE
                decode (granite-moe's decode and prefill shapes, batch
                invariance bitwise), the SSD chunked scan forward and
                backward (mamba2's and zamba2's recompute and train
                microbatch shapes, a ragged length) and the one-token SSD
                state update (their decode shapes); sampling also at
                stablelm-12b's vocabulary (100352), paged attention at
                its D=160 heads (also at the rlhf phase's decode batch)
                and flash attention at the f32 shapes of the rlhf and
                embodied phases; sampling at whisper-large-v3's and
                llama-3.2-vision-90b's vocabularies, and flash attention
                bidirectional at whisper's encoder heads over its 1500
                frames (forward in bf16, forward and backward in f32),
                and causal at the encdec and vlm phases' own shapes
                (whisper's decoder, 8 x 448 bf16 and 2 x 448 f32 with
                the backward; llama-3.2-vision's 64 / 8 heads of 128,
                8 x 512 bf16); K3's backward with its bound at 3xTF32
                and at the CUDA cores and its workspace, and failing the
                run unless it beats its plain version at whisper's
                encoder shape;
  3. ref        reduced yi-9b, granite-moe, mamba2 and zamba2 served on the
                card and on the CPU from the same weights: the same tokens;
                the static ``Engine`` on reduced yi-9b (also with a window
                of 8), granite-moe, mamba2, zamba2, llama-3.2-vision and
                whisper, card against CPU, and at temperature 0 against
                the card's paged engine;
  4. ref-train  the same reduced models in f32 (and llama-3.2-vision and
                whisper with their embeddings): recomputed logprobs and one
                train step (two microbatches) on the card against the CPU,
                and (the dense and SSM ones) the engine's logprobs against
                the recompute;
then for yi-9b (48 layers, 8 trained), granite-moe-3b-a800m (32 layers, 16
trained), mamba2-370m (48 SSM layers, all trained) and zamba2-2.7b (54 SSM
layers in 9 groups with a shared attention block, 24 trained), each from
random weights:
  5. serve      the model at full width in bf16 through ``PagedEngine``
                (paged KV, or the state cache for SSM and hybrid): 16
                requests, tokens/s, and the kernels' launch counters set
                to 0 before the run and gated exactly after it;
  6. greedy     the same requests twice at temperature 0: identical tokens
                (the SSM and hybrid models on 4 of them, cut to 64
                prompt tokens, with 16 new tokens: their prompts go
                through the decode batch a token a step);
     static     (yi-9b and granite-moe) the static ``Engine`` on 8 prompts
                of 64 tokens with 32 new: tokens/s, launches gated exactly
                (K2 once a round; granite's K5 a layer a decode step), and
                its rollouts' recomputed logprobs against its own at the
                paged engine's bars;
  7. recompute  16 rollouts of 448 + 64 tokens from the engine, scored by
                ``make_prefill_step`` at full depth: tokens/s (median of
                five passes), flash and SSD-scan launches, and the
                train-inference logprob mismatch, gated;
  8. train      the model at full width, depth cut where needed, f32 params
                and AdamW: three GRPO steps of 4 x 1024 tokens in two
                microbatches, step time, peak memory and kernel launches
                per step;
then the kinds only the static engine serves:
  encdec        whisper-large-v3 at full size: recompute of 8 x 448
                tokens with 1500 random frames (K3 64 a pass), a static
                generate (K2 only), three f32 + AdamW train steps with
                frames;
  vlm           llama-3.2-vision-90b at full width cut to one group (4 self
                + 1 cross layer): recompute of 8 x 512 tokens with 1024
                random image tokens (K3 4 a pass), a static generate;
and last the runtime end to end:
  9. grpo       ``GRPORunner`` on yi-9b at full width cut to 8 layers (f32
                params and AdamW in the actor, copies synced into the
                rollout and inference workers): profile, plan and three
                RL iterations of 16 rollouts of 8 + 64 tokens, once
                collocated and once as the scheduler plans it ("auto"):
                the profiled cost models, the plan, each iteration's wall
                and stage times, launches per iteration gated exactly,
                the weight sync's seconds and bytes, the actor's offload
                against its state bytes, peak memory; both runs strict
                (flowlint passes 1-2 before every execute; the findings
                and the lint's time printed), the auto run (two
                iterations) traced and its plan-vs-actual report
                printed;
 10. rlhf       ``RLHFRunner`` (actor, critic, reference, reward, rollout,
                inference: the paper's PPO diamond) on stablelm-12b at
                full width cut to 2 of 40 layers, f32: profile, plan
                (collocated; the "auto" plan from the same profiles
                logged) and two iterations of 16 rollouts of 8 + 32
                tokens; launches per iteration gated exactly, the KL to
                the reference live, actor and critic changed, the
                reference unchanged bit for bit, the actor's and the
                critic's offloads against their state bytes;
 11. embodied   ``EmbodiedPPORunner`` with the policy at stablelm-12b's
                full width cut to 2 layers (the embodied token space):
                64 envs, 16 cycle steps, two iterations, once forced
                collocated and once forced hybrid; the two trajectories
                equal, the forced realization recorded, launches per
                iteration gated exactly (K3 per act call and train
                forward, no K1 or K2);
 12. recover    ``GRPORunner`` on yi-9b at full width cut to 2 layers,
                f32 + AdamW, a checkpoint every iteration: the rollout
                killed at iteration 1 and the run recovered once, equal
                to a fresh resume from a copy of the checkpoint (rewards
                within rtol 1e-4, final params bit for bit), launches
                per iteration exact, the dead run's state freed before
                the rebuild; checkpoint save and load GB/s and the
                recovery's seconds by step.

After the phases one line a kernel gives its time against its bound.
The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before it a JSON object with every kernel's numbers, and
the last ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without that line.  Float32 products run
without TF32 throughout.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type;
# "3xtf32" is f32 products on the tensor cores as three TF32 products each
# (495 TFLOP/s of TF32 work), the rate of K6's f32 kernels
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
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


def device_ms(fn, n: int = 20, key: str = "") -> float:
    """Device time of one call of ``fn``: the sum over its CUDA kernels
    (those whose name holds ``key``) under ``torch.profiler``, the mean of
    ``n`` calls after a warm-up.  A profile now and then comes back
    without device events, or with only some of them (a kernel seen a
    fractional number of times a call: K1 once read a quarter of its
    time so); it is taken again, three times at most."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = 0.0
    for _ in range(3):
        rows = [(t, c) for k, t, c in profiled(fn, n) if key in k]
        ms = sum(t for t, _ in rows) * 1e3
        if rows and all(c >= 1 and abs(c - round(c)) < 1e-6
                        for _, c in rows):
            return ms
        if rows:
            log(f"device_ms: a profile saw {[round(c * n) for _, c in rows]}"
                f" launches of its kernels in {n} calls; taken again")
    if ms > 0:
        log(f"device_ms: no whole profile in three; {ms:.4f} ms is the "
            "last, from an incomplete one")
        return ms
    raise RuntimeError("the profiler saw no device time in three profiles")


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the kernels whose products run on the tensor cores, and the SASS
# instruction of their products: K3's bf16 forward (wgmma), K4's bf16 (also
# inside K5), K6's forward in bf16 and in f32 (3xTF32), K6's backward and
# K3's backward product launches (3xTF32, every instance), all mma.sync
TC_KERNELS = {"flash_fwd_wgmma_kernel": "HGMMA", "gmm_mma_kernel": "HMMA",
              "ssd_fwd_mma_kernel": "HMMA", "ssd_fwd_tf32_kernel": "HMMA",
              "ssd_bwd_tf32_kernel": "HMMA", "flash_bwd_dkdv_kernel": "HMMA",
              "flash_bwd_dq_kernel": "HMMA"}
# kernels that must spill nothing: those, whose accumulators live in
# registers
NO_SPILL = tuple(TC_KERNELS)


def kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel<128>`` or ``ssd_bwd_tf32_kernel<bf16>``
    from an Itanium-mangled kernel name."""
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    for m in re.finditer(r"(?=(\d+))", mangled):  # every digit run's tails
        end = m.start() + len(m.group(1))
        ident = mangled[end:end + int(m.group(1))]
        if ident.endswith("_kernel") and ident.isidentifier():
            rest = mangled[end + len(ident):]
            head = rest[1:].split("EEv")[0] if rest.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", head) or (
                [types[head]] if head in types else [])
            return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def check_build(so: Path) -> None:
    """Every kernel's registers and spills from the build's ``-Xptxas -v``
    log; the tensor-core kernels and K3's backward must spill nothing,
    and the SASS of every tensor-core instance
    (``cuobjdump -sass`` of the built library) must hold its product:
    HGMMA (wgmma) or HMMA (mma.sync)."""
    from repro_torch.kernels import _build

    name, spills = "", {}
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Function properties for" in line:
            name = line.split("for ")[-1].strip()
        elif "spill stores" in line:
            spills[name] = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            log(f"header: ptxas {kernel_name(name)}: {regs} registers, "
                f"{spills.get(name, '')}")
    for key in NO_SPILL:
        found = [n for n in spills if key in n]
        assert found, f"{key}: not in the build log"
        for n in found:
            assert "0 bytes spill stores, 0 bytes spill loads" in spills[n], (
                f"{kernel_name(n)} spills: {spills[n]}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for key, op in TC_KERNELS.items():
        counts = {kernel_name(f.split("\n", 1)[0].strip()): f.count(op)
                  for f in sass.split("Function : ")[1:] if key in f[:300]}
        assert counts and all(counts.values()), f"{key}: no {op} in {counts}"
        log(f"header: SASS of {key}: {op} in every instance ("
            + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
            + ")")
    log(f"header: no spills in {', '.join(NO_SPILL)}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_paged_attention(dtype, results: dict, heads=(32, 4, 128),
                          arch: str = "yi-9b",
                          ctx=(0, 1, 17, 128, 333, 512, 777, 1024)) -> None:
    """K1 at ``arch``'s (H, KV, D) over 8 rows of contexts ``ctx`` (the
    first empty) in 64-page tables of 16 tokens, the serving engines'
    1024-token cap; yi-9b's bf16 case is the JSON entry."""
    import torch

    from repro_torch.kernels import paged_attention as pa

    (H, KV, D), B, page, nb = heads, len(ctx), 16, 64
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    P = B * nb + 1
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
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

    # a launch takes the host about as long as the card takes to run it,
    # so back-to-back calls between two events time the host; the
    # profiler's device time is the kernel's own
    call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
    ms, plain_ms = device_ms(kernel), device_ms(plain)
    ctx = int(lens.sum())
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * ctx * KV * D * elem + 2 * B * H * D * elem
              + B * 4 * (1 + -(-1024 // page)))
    ops = 4 * ctx * H * D
    bms, by = bound_ms(nbytes, ops, str(dtype).split(".")[-1])
    name = str(dtype).split(".")[-1]
    log(f"kernels: paged_attention {arch} {name} B={B} H={H} KV={KV} D={D} "
        f"page={page} ctx={lens.tolist()} max|err|={err:.3g} (tol {tol}) "
        f"device time: kernel={ms:.4f} ms plain={plain_ms:.4f} ms; "
        f"event-timed calls: kernel={call_ms:.4f} ms plain="
        f"{plain_call_ms:.4f} ms; bound={bms:.4f} ms ({by})")
    if dtype == torch.bfloat16 and arch == "yi-9b":  # the JSON entry
        results["paged_attention"] = dict(
            name="paged_attention_bhd", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:79", launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None)


def check_fused_sample(results: dict, V: int = 65536, vocab: int = 64000,
                       arch: str = "yi-9b") -> None:
    """K2 over ``arch``'s padded (V) and real (vocab) vocabulary; yi-9b's
    T=1 case is the JSON entry."""
    import torch

    from repro_torch.kernels import sampling as ks
    from repro_torch.serve.sampling import request_noise

    B = 8
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
        # a launch takes the host about as long as the card: the
        # profiler's device time is the kernel's, the events' the host's
        event_ms = time_ms(lambda: ks.fused_sample_bv(logits, gumbel, **kw))
        ms = device_ms(lambda: ks.fused_sample_bv(logits, gumbel, **kw))
        plain_ms = device_ms(lambda: ks.fused_sample_plain(logits, gumbel,
                                                           **kw), n=5)
        nbytes = B * V * 4 * (2 if temp > 0 else 1) + B * 8
        # ~10 f32 operations per vocab entry: mask, max, exp, sum, scale,
        # compare, noise add, argmax
        bms, by = bound_ms(nbytes, 10 * B * V, "float32")
        log(f"kernels: fused_sample {arch} B={B} V={V} vocab={vocab} "
            f"T={temp} top_k={k} "
            f"top_p={p} tokens equal, max|lp err|={err:.3g} (tol {tol}) "
            f"kernel={ms:.4f} ms device ({event_ms:.4f} between events) "
            f"plain={plain_ms:.4f} ms device bound={bms:.5f} ms ({by})")
        if temp > 0 and arch == "yi-9b":  # the JSON entry
            results["fused_sample"] = dict(
                name="fused_sample_bv", route="cuda",
                source="src/repro_torch/kernels/csrc/sampling.cu",
                replaces="src/repro/kernels/sampling.py:125", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# grads, relative to the largest |grad|: f32 summation order; bf16 rounds
# inputs and outputs, and delta = rowsum(dO * O) reads the bf16 O
FLASH_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


YI_HEADS = (32, 4, 128)  # (H, KV, head_dim)
GRANITE_HEADS = (24, 8, 64)


def flash_case(g, dtype, B: int, S: int, window: int, backward: bool,
               heads=YI_HEADS, causal: bool = True):
    """K3 at ``heads`` = (H, KV, D), causal unless ``causal`` is False,
    against its plain version, on
    (B, H, S, D) views of model-layout (B, S, H, D) tensors as
    ``ops.flash_attention`` passes them; with ``backward`` also dq, dk and
    dv against autograd of the plain version for a random output
    gradient.  Returns the inputs and outputs of both and the log line."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    H, KV, D = heads
    name = str(dtype).split(".")[-1]
    q, k, v, dout = (torch.randn((B, S, h, D), generator=g, device="cuda")
                     .to(dtype).transpose(1, 2) for h in (H, KV, KV, H))
    kw = dict(causal=causal, window=window)
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
                    f"S={S} D={D} {'causal' if causal else 'bidirectional'} "
                    f"window={window} (model layout): "
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


def flash_pairs(S: int, causal: bool = True) -> int:
    """Live (query, key) pairs of one head: S(S+1)/2 under the causal
    mask, S^2 bidirectional."""
    return S * (S + 1) // 2 if causal else S * S


def flash_flops(B: int, S: int, heads, causal: bool = True) -> float:
    """Operations of K3's forward: 4 * D flops per live (query, key) pair
    (QK^T and PV)."""
    H, _, D = heads
    return 4.0 * B * H * D * flash_pairs(S, causal)


def flash_bounds(dtype, B: int, S: int, heads=YI_HEADS, causal: bool = True,
                 bwd_rate: str = "3xtf32"):
    """(forward, backward) bounds of K3 at ``heads``: each a (ms, 'bytes'
    or 'operations') pair.  The backward's f32 products run as 3xTF32 on
    the tensor cores (``bwd_rate``; "float32" gives the CUDA cores'
    bound beside it)."""
    import torch

    H, KV, D = heads
    name = str(dtype).split(".")[-1]
    elem = torch.finfo(dtype).bits // 8
    # live (query, key) pairs of this mask; 2 * D flops per pair and
    # product: forward QK^T and PV, backward S, dP, dV, dK and dQ
    pairs = flash_pairs(S, causal)
    act = B * H * S * D * elem
    kv_bytes = 2 * B * KV * S * D * elem
    # forward: reads q, k, v; writes out, lse.  Backward: reads q, out,
    # dO, k, v, lse; writes dq, dk, dv
    return (bound_ms(2 * act + kv_bytes + 4 * B * H * S,
                     4 * B * H * D * pairs, name),
            bound_ms(4 * act + 2 * kv_bytes + 4 * B * H * S,
                     10 * B * H * D * pairs,
                     bwd_rate if dtype == torch.float32 else name))


def flash_bwd_extra(dtype, B: int, S: int, heads, causal: bool = True,
                    window: int = 0) -> str:
    """The backward's bound at the CUDA cores' f32 rate (beside the
    3xTF32 one) and its f32 workspace bytes, for a log line."""
    from repro_torch.kernels import _build

    H, KV, D = heads
    cc, by = flash_bounds(dtype, B, S, heads, causal, "float32")[1]
    ws = 4 * _build.library().flash_attention_bwd_workspace(
        B, H, KV, S, D, int(causal), window)
    return (f" ({cc:.4f} ms at the CUDA cores' f32 rate, {by}); f32 "
            f"workspace {ws / 1e6:.2f} MB")


def check_flash_attention(results: dict) -> None:
    """K3 forward and backward against the plain version: at B=4, S=1024,
    S=1000 (a tail) and S=1024 with window 256, in f32 and bf16, at
    yi-9b's heads; then at the main paths' own shapes, where it is also
    timed beside the plain version and ``scaled_dot_product_attention``:
    the recompute's forward (B=16, S=512, bf16) and the train
    microbatch's forward and backward (B=2, S=1024, f32), at yi-9b's heads
    (the JSON entries) and granite-moe's."""
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
    for heads, dtype, B, S, backward in (
            (YI_HEADS, torch.bfloat16, 16, 512, False),
            (YI_HEADS, torch.float32, 2, 1024, True),
            (GRANITE_HEADS, torch.bfloat16, 16, 512, False),
            (GRANITE_HEADS, torch.float32, 2, 1024, True)):
        record = heads == YI_HEADS
        c = flash_case(g, dtype, B, S, 0, backward, heads)
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
        (fwd_bound, fwd_by), (bwd_bound, bwd_by) = flash_bounds(dtype, B, S,
                                                                heads)
        tf = flash_flops(B, S, heads) / 1e9
        line = (f"{c['line']}; fwd kernel={ms:.4f} ms ({tf / ms:.1f} "
                f"TFLOP/s) plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms "
                f"({tf / lib_ms:.1f} TFLOP/s) bound={fwd_bound:.4f} ms "
                f"({fwd_by}; kernel at {100 * fwd_bound / ms:.1f} % of it)")
        if not backward:  # the recompute's shape and type
            log(line)
            if record:
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
            f"{lib_both_ms:.4f} ms bound={bwd_bound:.4f} ms ({bwd_by}, "
            f"3xtf32){flash_bwd_extra(dtype, B, S, heads)}")
        if record:  # the train microbatch's shape and type
            results["flash_bwd"] = dict(
                common, name="flash_attention_bwd",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                max_abs_err=c["grad_err"], ms=bwd_ms, plain_ms=plain_bwd_ms,
                bound_ms=bwd_bound, bound_by=bwd_by, library_ms=lib_bwd_ms)
        del c, lib, lib_out, want, leaves
        torch.cuda.empty_cache()


# K4 and K5 against their plain versions, relative to the largest |out|.
# f32: summation order only.  bf16: both round f32 sums that differ only
# in order to bf16 (2**-8 relative), and K5's rounded intermediates
# (g, u, silu(g) * u) can carry such an ulp into the down product.
GMM_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRANITE_MOE = (40, 8, 1536, 512)  # experts, top-k, d_model, expert d_ff


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def check_grouped_matmul(results: dict) -> None:
    """K4 against its plain version in f32 and bf16 at granite-moe's
    shapes: the decode step's (40 experts x 8 rows, 1536 -> 512 and
    512 -> 1536), a prefill chunk's (256 rows, with per-expert row counts
    and without) and a ragged one; then timed in bf16 at the decode
    gate/up shape beside its bound, its plain version and ``torch.bmm``,
    in f32 at the same shape, and in bf16 at a prefill chunk's."""
    import torch

    from repro_torch.kernels import moe_gmm as gmm

    E, _, d, f = GRANITE_MOE
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for C, D, F, ragged in ((8, d, f, False), (8, f, d, False),
                                (256, d, f, False), (256, d, f, True),
                                (256, f, d, True), (13, 100, 70, True)):
            buf = torch.randn((E, C, D), generator=g, device=dev).to(dtype)
            w = (torch.randn((E, D, F), generator=g, device=dev)
                 / math.sqrt(D)).to(dtype)
            rows = None
            live = torch.ones((E, C), dtype=torch.bool, device=dev)
            if ragged:  # expert 0 empty, the last full, the rest between
                rows = torch.randint(0, C + 1, (E,), generator=g, device=dev,
                                     dtype=torch.int32)
                rows[0], rows[-1] = 0, C
                live = torch.arange(C, device=dev)[None] < rows[:, None]
            got = gmm.grouped_matmul(buf, w, rows)
            want = gmm.grouped_matmul_plain(buf, w, rows)
            torch.cuda.synchronize()
            assert torch.isfinite(got[live]).all(), "grouped_matmul: non-finite"
            err = rel_err(got[live], want[live])
            tol = GMM_RTOL[name]
            tag = f"grouped_matmul {name} E={E} C={C} D={D} F={F}" + (
                " ragged rows" if ragged else "")
            assert err <= tol, f"{tag}: max|err|/max|out| {err} > {tol}"
            log(f"kernels: {tag}: max|err|/max|out|={err:.3g} (tol {tol})")
    # timed in bf16 at the decode step's gate/up shape (no row counts: the
    # TPU kernel's function), rotating over two weight sets (126 MB, over
    # the 50 MB L2) as 32 layers do
    C, D, F = 8, d, f
    bf = torch.bfloat16
    buf = torch.randn((E, C, D), generator=g, device=dev).to(bf)
    ws = [(torch.randn((E, D, F), generator=g, device=dev)
           / math.sqrt(D)).to(bf) for _ in range(2)]
    got = gmm.grouped_matmul(buf, ws[0])
    want = gmm.grouped_matmul_plain(buf, ws[0])
    err = (got.float() - want.float()).abs().max().item()
    # device time under the profiler: a launch costs the host more than
    # the card takes, so back-to-back calls between events time the host
    it = iter(range(1 << 30))
    event_ms = time_ms(lambda: gmm.grouped_matmul(buf, ws[next(it) % 2]))
    ms = device_ms(lambda: gmm.grouped_matmul(buf, ws[next(it) % 2]))
    plain_ms = time_ms(lambda: gmm.grouped_matmul_plain(buf, ws[next(it) % 2]),
                       n=5)
    lib_ms = device_ms(lambda: torch.bmm(buf, ws[next(it) % 2]))
    bms, by = bound_ms(2 * (E * C * D + E * D * F + E * C * F),
                       2 * E * C * D * F, "bfloat16")
    log(f"kernels: grouped_matmul bf16 E={E} C={C} D={D} F={F} (decode "
        f"gate/up) max|err|={err:.3g} kernel={ms:.4f} ms device "
        f"({event_ms:.4f} ms a call between events) plain={plain_ms:.4f} ms "
        f"bmm={lib_ms:.4f} ms device bound={bms:.4f} ms ({by}; kernel at "
        f"{100 * bms / ms:.1f} % of it)")
    # f32 keeps the CUDA-core kernel (its 1e-5 gate leaves no room for
    # TF32): the same shape in f32, device time
    buf32, ws32 = buf.float(), [w.float() for w in ws]
    f32_ms = device_ms(lambda: gmm.grouped_matmul(buf32, ws32[next(it) % 2]))
    b32, by32 = bound_ms(4 * (E * C * D + E * D * F + E * C * F),
                         2 * E * C * D * F, "float32")
    log(f"kernels: grouped_matmul f32 E={E} C={C} D={D} F={F} (decode "
        f"gate/up, CUDA cores) kernel={f32_ms:.4f} ms device bound="
        f"{b32:.4f} ms ({by32})")
    del buf32, ws32
    results["grouped_matmul"] = dict(
        name="grouped_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:93", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    # the prefill chunk's gate/up shape with granite-like row counts
    C = 256
    buf = torch.randn((E, C, D), generator=g, device=dev).to(bf)
    rows = torch.full((E,), C * 8 // E, dtype=torch.int32, device=dev)
    ms = device_ms(lambda: gmm.grouped_matmul(buf, ws[0], rows))
    lib_ms = device_ms(lambda: torch.bmm(buf[:, :C * 8 // E], ws[0]))
    n = E * (C * 8 // E)  # live rows
    bms, by = bound_ms(2 * (n * D + E * D * F + n * F), 2 * n * D * F,
                       "bfloat16")
    log(f"kernels: grouped_matmul bf16 E={E} C={C} D={D} F={F} rows "
        f"{C * 8 // E} each (prefill chunk gate/up): kernel={ms:.4f} ms "
        f"device, bmm on the live rows={lib_ms:.4f} ms device, bound="
        f"{bms:.4f} ms ({by})")


def moe_case(g, dtype, T: int, router, weights, same: bool = False):
    """Inputs of K5 at granite-moe's routing: ``T`` tokens routed by
    ``models.moe``'s own top-8 of a random f32 router, or with ``same``
    all to experts 0-7 (the capacity-free case)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    E, k, d, _ = GRANITE_MOE
    cfg = get_config("granite-moe-3b-a800m")
    x = torch.randn((T, d), generator=g, device="cuda").to(dtype)
    _, gate, idx = moe_mod._route({"router": router}, cfg, x)
    if same:
        idx = torch.arange(k, device="cuda").expand(T, k).contiguous()
    return (x, idx, gate, *weights)


def check_moe_decode(results: dict) -> None:
    """K5 against its plain version and against ``ref.moe_decode_ref`` in
    f32 and bf16 at granite-moe's shapes: a decode step (T=8), a prefill
    chunk (T=256), every token on the same 8 experts; each token alone
    against the same token in its batch, bitwise; then timed in bf16 at
    T=8 and T=256 beside its bound and its plain version."""
    import torch

    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref

    E, k, d, f = GRANITE_MOE
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    router = torch.randn((d, E), generator=g, device=dev) / math.sqrt(d)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        weights = [(torch.randn(s, generator=g, device=dev)
                    / math.sqrt(s[1])).to(dtype)
                   for s in ((E, d, f), (E, d, f), (E, f, d))]
        for T, same in ((8, False), (256, False), (8, True)):
            args = moe_case(g, dtype, T, router, weights, same)
            got = gmm.moe_decode_gmm(*args)
            want = gmm.moe_decode_gmm_plain(*args)
            oracle = ref.moe_decode_ref(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "moe_decode: non-finite"
            err, err_ref = rel_err(got, want), rel_err(got, oracle)
            tol = GMM_RTOL[name]
            tag = f"moe_decode {name} T={T}" + (
                " all tokens on experts 0-7" if same else "")
            assert err <= tol, f"{tag}: max|err|/max|out| {err} > {tol}"
            assert err_ref <= tol, f"{tag}: vs oracle {err_ref} > {tol}"
            same_bits = sum(
                torch.equal(gmm.moe_decode_gmm(
                    *(a[i:i + 1] for a in args[:3]), *weights)[0], got[i])
                for i in range(8))
            assert same_bits == 8, (
                f"{tag}: {8 - same_bits} of 8 tokens differ alone")
            log(f"kernels: {tag}: max|err|/max|out| vs plain={err:.3g}, vs "
                f"moe_decode_ref={err_ref:.3g} (tol {tol}); tokens 0-7 "
                f"alone == in the batch of {T}, bitwise")
    # timed in bf16 at granite-moe's routing (the last weights are bf16)
    for T in (8, 256):
        args = moe_case(g, torch.bfloat16, T, router, weights)
        x, idx = args[0], args[1]
        got = gmm.moe_decode_gmm(*args)
        err = (got.float() - gmm.moe_decode_gmm_plain(*args).float()
               ).abs().max().item()
        event_ms = time_ms(lambda: gmm.moe_decode_gmm(*args))
        ms = device_ms(lambda: gmm.moe_decode_gmm(*args))
        plain_ms = time_ms(lambda: gmm.moe_decode_gmm_plain(*args), n=5)
        # this routing's data: the touched experts' weights, x, y, idx,
        # gate; 2 flops per weight element per routed row, 3 products
        touched = int(torch.unique(idx).numel())
        nbytes = touched * 3 * d * f * 2 + 2 * T * d * 2 + T * k * 12
        bms, by = bound_ms(nbytes, 6 * T * k * d * f, "bfloat16")
        log(f"kernels: moe_decode bf16 T={T} k={k} E={E} d={d} f={f} "
            f"({touched} experts touched) kernel={ms:.4f} ms device (its "
            f"four launches; {event_ms:.4f} ms a call between events) "
            f"plain={plain_ms:.4f} ms "
            f"bound={bms:.4f} ms ({by}); library: none (no single PyTorch "
            f"call)")
        if T == 8:  # the decode step: the JSON entry
            results["moe_decode"] = dict(
                name="moe_decode_gmm", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                replaces="src/repro/kernels/moe_gmm.py:50", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


MAMBA2_SSD = (32, 64, 128)  # SSD heads, head_dim, state size
ZAMBA2_SSD = (80, 64, 64)
ZAMBA2_HEADS = (32, 32, 80)  # the shared attention block's (H, KV, D)
# K6 and K7 against their plain versions, relative to the largest |value|.
# K6 f32: the kernel and the plain version take the same prefix sums (f64,
# rounded per position) and exps and sum the products in other orders;
# bf16: y rounded once from those f32 sums; grads the same way.  K7: f32
# arithmetic on both sides, one FMA apart.
SSD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSU_RTOL = 1e-5


def ssd_inputs(g, B, L, heads, dtype):
    """Model-layout K6 inputs at ``heads`` = (H, P, N): x and B, C in
    ``dtype``, dt a softplus of a standard normal, A as ``init_mamba2``
    makes it (-1 .. -16 across the heads), D near 1."""
    import torch
    import torch.nn.functional as F

    H, P, N = heads

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    return (r(B, L, H, P).to(dtype), F.softplus(r(B, L, H)),
            -torch.linspace(1.0, 16.0, H, device="cuda"),
            (0.5 * r(B, L, N)).to(dtype), (0.5 * r(B, L, N)).to(dtype),
            1.0 + 0.1 * r(H))


def ssd_plain(x, dt, A, Bm, Cm, D, chunk):
    """``ops.ssd_scan``'s padding and layout change around the plain
    version (what the ops wrapper does on a CPU tensor)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ssd

    B, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                     for t in (x, dt, Bm, Cm))
    nc = (L + pad) // chunk
    y = ssd.ssd_scan_plain(
        x.reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4),
        dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2), A.expand(B, H),
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N),
        D.expand(B, H))
    return y.permute(0, 2, 3, 1, 4).reshape(B, L + pad, H, P)[:, :L]


def ssd_work(B, L, heads, chunk, dtype):
    """(bytes, flops) of K6 forward and backward at one shape: each input
    read once and each output written once; the products the function
    needs (C B^T once per batch row and chunk, shared by the heads; the
    causal half of the (s, s) products; the (s, P, N) state products)."""
    import torch

    H, P, N = heads
    elem = torch.finfo(dtype).bits // 8
    nc = -(-L // chunk)
    tri = chunk * (chunk + 1) // 2
    x_b, bc_b, dt_b = B * L * H * P * elem, 2 * B * L * N * elem, B * L * H * 4
    cb = 2 * B * nc * chunk * chunk * N
    per = B * H * nc
    fwd = (2 * x_b + bc_b + dt_b,
           cb + per * (2 * tri * P + 4 * chunk * P * N))
    # backward: reads x, dt, B, C, dy; writes dx, ddt, dB, dC.  Products:
    # C B^T, the forward's state recurrence, dM = g x^T and M^T g (causal),
    # dCB B and dCB^T C (causal), and four (s, P, N) state products
    bwd = (2 * (2 * x_b + bc_b + dt_b),
           cb + per * (4 * tri * P + 4 * tri * N + 10 * chunk * P * N))
    return fwd, bwd


def check_ssd_scan(results: dict) -> None:
    """K6 forward against its plain version through ``ops.ssd_scan`` on
    model-layout views: at each model's recompute shape (16 x 512, bf16),
    the train microbatch's (2 x 1024, f32) and a ragged length (300,
    padded to 384); the backward at the train microbatch's shape, every
    gradient against autograd of the plain version.  Timed beside the
    plain version and the bound; no single PyTorch call computes the
    scan."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    chunk = 128
    common = dict(route="cuda", launches=0, library_ms=None,
                  replaces="src/repro/kernels/ssd_scan.py:74")
    for arch, heads in (("mamba2-370m", MAMBA2_SSD),
                        ("zamba2-2.7b", ZAMBA2_SSD)):
        for dtype, B, L, timed in ((torch.bfloat16, 16, 512, True),
                                   (torch.float32, 2, 1024, True),
                                   (torch.bfloat16, 2, 300, False),
                                   (torch.float32, 2, 300, False)):
            name = str(dtype).split(".")[-1]
            args = ssd_inputs(g, B, L, heads, dtype)
            with torch.no_grad():
                got = ops.ssd_scan(*args, chunk)
                want = ssd_plain(*args, chunk)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"ssd_scan {arch}: non-finite"
            err, rel = (got.float() - want.float()).abs().max().item(), \
                rel_err(got, want)
            tol = SSD_RTOL[name]
            tag = (f"ssd_scan {arch} {name} B={B} L={L} H={heads[0]} "
                   f"P={heads[1]} N={heads[2]} chunk={chunk}")
            assert rel <= tol, f"{tag}: max|err|/max|y| {rel} > {tol}"
            line = f"kernels: {tag}: fwd max|err|/max|y|={rel:.3g} (tol {tol})"
            if not timed:
                log(line + " (padded to a chunk multiple)")
                continue
            with torch.no_grad():
                ms = time_ms(lambda: ops.ssd_scan(*args, chunk))
                dev_ms = device_ms(lambda: ops.ssd_scan(*args, chunk))
                plain_ms = time_ms(lambda: ssd_plain(*args, chunk), n=5)
            (fb, fo), (bb, bo) = ssd_work(B, L, heads, chunk, dtype)
            # f32 runs in 3xTF32 on the tensor cores: bound at that rate,
            # the CUDA cores' f32 rate beside it
            rate = "3xtf32" if dtype == torch.float32 else name
            fwd_bound, fwd_by = bound_ms(fb, fo, rate)
            cuda_cores = (f", {bound_ms(fb, fo, name)[0]:.4f} ms at the CUDA "
                          "cores' f32 rate" if rate != name else "")
            line += (f"; fwd kernel={ms:.4f} ms ({dev_ms:.4f} device) "
                     f"plain={plain_ms:.4f} ms bound={fwd_bound:.4f} ms "
                     f"({fwd_by}, {rate}{cuda_cores}); library: none")
            if dtype == torch.bfloat16:  # the recompute's shape and type
                log(line)
                if arch == "mamba2-370m":
                    results["ssd_scan"] = dict(
                        common, name="ssd_scan_bhcsp",
                        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=fwd_bound, bound_by=fwd_by)
                continue
            # the train microbatch: the backward, every gradient
            dy = torch.randn(args[0].shape, generator=g, device="cuda")
            grads = []
            for fn in (ops.ssd_scan, ssd_plain):
                leaves = [t.detach().clone().requires_grad_() for t in args]
                y = fn(*leaves, chunk)
                grads.append((y, leaves,
                              torch.autograd.grad(y, leaves, dy,
                                                  retain_graph=True)))
            torch.cuda.synchronize()
            rels = []
            for gname, a, b in zip(("x", "dt", "A", "Bm", "Cm", "D"),
                                   grads[0][2], grads[1][2]):
                assert torch.isfinite(a).all(), f"{tag} d{gname} non-finite"
                rels.append(rel_err(a, b))
                assert rels[-1] <= tol, (
                    f"{tag} bwd d{gname}: max|err|/max|grad| {rels[-1]} > "
                    f"{tol}")
            gerr = max((a - b).abs().max().item()
                       for a, b in zip(grads[0][2], grads[1][2]))
            (ky, kl, _), (py, pl, _) = grads
            # the kernel alone, and the whole call (the head sums of the
            # dB, dC, dA, dD partials and the layout changes around it)
            def bwd():
                return torch.autograd.grad(ky, kl, dy, retain_graph=True)
            bwd_ms = time_ms(bwd)
            bwd_dev, bwd_call = device_ms(bwd, key="ssd_bwd"), device_ms(bwd)
            plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
                py, pl, dy, retain_graph=True), n=5)
            bwd_bound, bwd_by = bound_ms(bb, bo, "3xtf32")
            log(f"{line}; bwd max|err|/max|grad| "
                + " ".join(f"d{n} {r:.3g}" for n, r in
                           zip(("x", "dt", "A", "Bm", "Cm", "D"), rels))
                + f" (tol {tol}); bwd kernel={bwd_ms:.4f} ms ({bwd_dev:.4f} "
                f"device, the call {bwd_call:.4f}) plain={plain_bwd_ms:.4f} "
                f"ms bound={bwd_bound:.4f} ms ({bwd_by}, 3xtf32, "
                f"{bound_ms(bb, bo, name)[0]:.4f} ms at the CUDA cores' f32 "
                f"rate); library: none")
            if arch == "mamba2-370m":
                results["ssd_scan_bwd"] = dict(
                    common, name="ssd_scan_bwd",
                    source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                    max_abs_err=gerr, ms=bwd_ms, plain_ms=plain_bwd_ms,
                    bound_ms=bwd_bound, bound_by=bwd_by)
            del grads, ky, kl, py, pl, bwd
            torch.cuda.empty_cache()


def check_ssm_update(results: dict) -> None:
    """K7 against its plain version at mamba2's and zamba2's decode shapes
    (B=8), f32 state, with f32 inputs (as ``mamba2_decode`` passes them:
    the JSON entry is mamba2's) and bf16 ones; timed over enough states to
    exceed the 50 MB L2, as 48 layers' states do."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_update as ssu

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    B = 8
    for arch, (H, P, N) in (("mamba2-370m", MAMBA2_SSD),
                            ("zamba2-2.7b", ZAMBA2_SSD)):
        n_states = max(1, math.ceil(128e6 / (B * H * P * N * 4)))
        states = [torch.randn((B, H, P, N), generator=g, device="cuda")
                  for _ in range(n_states)]
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        D = torch.ones(H, device="cuda")
        dt = F.softplus(torch.randn((B, H), generator=g, device="cuda"))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn((B, H, P), generator=g, device="cuda").to(dtype)
            Bm, Cm = ((0.5 * torch.randn((B, N), generator=g, device="cuda"))
                      .to(dtype) for _ in range(2))
            y, new = ops.ssm_state_update(states[0], x, dt, A, Bm, Cm, D)
            wy, ws = ssu.ssm_state_update_plain(
                states[0], x, dt, A.expand(B, H), Bm, Cm, D.expand(B, H))
            torch.cuda.synchronize()
            rel = max(rel_err(y, wy), rel_err(new, ws))
            err = max((y - wy).abs().max().item(),
                      (new - ws).abs().max().item())
            tag = f"ssm_state_update {arch} {name} B={B} H={H} P={P} N={N}"
            assert rel <= SSU_RTOL, f"{tag}: max|err|/max|out| {rel}"
            it = iter(range(1 << 30))

            def kernel():
                ops.ssm_state_update(states[next(it) % n_states], x, dt, A,
                                     Bm, Cm, D)

            def plain():
                ssu.ssm_state_update_plain(
                    states[next(it) % n_states], x, dt, A.expand(B, H), Bm,
                    Cm, D.expand(B, H))

            # the kernel runs for less time than its Python wrapper takes
            # to launch it, so back-to-back calls between two events time
            # the host; the profiler's device time is the kernel's own
            call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            elem = torch.finfo(dtype).bits // 8
            nbytes = (2 * B * H * P * N * 4 + B * H * P * (elem + 4)
                      + 2 * B * N * elem + 3 * B * H * 4)
            bms, by = bound_ms(nbytes, 4 * B * H * P * N, "float32")
            log(f"kernels: {tag} (state f32): max|err|/max|out|={rel:.3g} "
                f"(tol {SSU_RTOL}) device time: kernel={ms:.4f} ms plain="
                f"{plain_ms:.4f} ms; event-timed calls: kernel={call_ms:.4f} "
                f"ms plain={plain_call_ms:.4f} ms; bound={bms:.4f} ms ({by}); "
                f"library: none")
            if arch == "mamba2-370m" and dtype == torch.float32:
                results["ssm_update"] = dict(
                    name="ssm_state_update_bh", route="cuda",
                    source="src/repro_torch/kernels/csrc/ssm_update.cu",
                    replaces="src/repro/kernels/ssm_update.py:50",
                    launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None)
        del states
        torch.cuda.empty_cache()


def check_flash_zamba2() -> None:
    """K3 at zamba2's shared attention heads (MHA, D 80) with its window
    4096: the recompute's forward (16 x 512, bf16) and the train
    microbatch's forward and backward (2 x 1024, f32), timed beside
    ``scaled_dot_product_attention``, causal, which the window does not cut
    at these lengths."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for dtype, B, S, backward in ((torch.bfloat16, 16, 512, False),
                                  (torch.float32, 2, 1024, True)):
        c = flash_case(g, dtype, B, S, 4096, backward, ZAMBA2_HEADS)
        q, k, v = c["q"], c["k"], c["v"]
        kw = dict(causal=True, window=4096)
        ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
        tf = flash_flops(B, S, ZAMBA2_HEADS) / 1e9
        line = f"{c['line']}; fwd kernel={ms:.4f} ms ({tf / ms:.1f} TFLOP/s)"
        if backward:
            bms = time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, c["out"], c["lse"], c["dout"], **kw))
            lib = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
            lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib, c["dout"], retain_graph=True))
            bound, by = flash_bounds(dtype, B, S, ZAMBA2_HEADS)[1]
            line += (f"; bwd kernel={bms:.4f} ms sdpa bwd={lib_bwd_ms:.4f} "
                     f"ms bound={bound:.4f} ms ({by}, 3xtf32)"
                     + flash_bwd_extra(dtype, B, S, ZAMBA2_HEADS,
                                       window=4096))
            del lib, lib_out
        else:
            lib = [t.contiguous() for t in (q, k, v)]
            with torch.no_grad():
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    *lib, is_causal=True))
            bound, by = flash_bounds(dtype, B, S, ZAMBA2_HEADS)[0]
            line += (f" sdpa={lib_ms:.4f} ms ({tf / lib_ms:.1f} TFLOP/s) "
                     f"bound={bound:.4f} ms ({by}; kernel at "
                     f"{100 * bound / ms:.1f} % of it)")
            del lib
        log(line + " (zamba2-2.7b shared attention)")
        del c
        torch.cuda.empty_cache()


def flash_timed(c: dict, dtype, B: int, S: int, heads,
                causal: bool = True) -> str:
    """K3 on a :func:`flash_case`'s inputs timed beside its plain version
    and ``scaled_dot_product_attention``, with the bound (over S(S+1)/2
    or S^2 pairs by the mask); with the case's backward also the
    backward beside the plain one's and SDPA's, both its bounds and its
    workspace.  Returns the log line; the backward's times land in
    ``c["bwd_ms"]`` (kernel, plain, SDPA)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    H, KV, _ = heads
    q, k, v, dout = (c[n] for n in ("q", "k", "v", "dout"))
    lib = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*lib, is_causal=causal,
                                              enable_gqa=KV != H)

    ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=causal))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=causal), n=5)
    with torch.no_grad():
        lib_ms = time_ms(sdpa)
    (fb, fby), (bb, bby) = flash_bounds(dtype, B, S, heads, causal)
    tf = flash_flops(B, S, heads, causal) / 1e9
    pairs = "S(S+1)/2" if causal else "S^2"
    line = (f"{c['line']}; fwd kernel={ms:.4f} ms ({tf / ms:.1f} "
            f"TFLOP/s) plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms "
            f"({tf / lib_ms:.1f} TFLOP/s) bound={fb:.4f} ms ({fby}, {pairs} "
            f"pairs; kernel at {100 * fb / ms:.1f} % of it)")
    if "grad_err" in c:
        bms = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, c["out"], c["lse"], dout, causal=causal))
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            c["want"], c["leaves"], dout, retain_graph=True), n=5)
        lib_out = sdpa()
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, lib, dout, retain_graph=True))
        c["bwd_ms"] = (bms, plain_bwd_ms, lib_bwd_ms)
        line += (f"; bwd kernel={bms:.4f} ms plain={plain_bwd_ms:.4f} ms "
                 f"sdpa bwd={lib_bwd_ms:.4f} ms bound={bb:.4f} ms ({bby}, "
                 f"3xtf32){flash_bwd_extra(dtype, B, S, heads, causal)}")
    return line


def fold_flash_errors(results: dict, c: dict) -> None:
    """A :func:`flash_case`'s errors into K3's entries (the largest over
    the shapes checked)."""
    results["flash_fwd"]["max_abs_err"] = max(
        results["flash_fwd"]["max_abs_err"], c["err"])
    if "grad_err" in c:
        results["flash_bwd"]["max_abs_err"] = max(
            results["flash_bwd"]["max_abs_err"], c["grad_err"])


STABLELM_HEADS = (32, 8, 160)  # stablelm-12b's (H, KV, D): d 5120 / 32
# contexts of the rlhf phase's decode batch (one slot idle)
RLHF_DECODE_CTX = (0, 9, 12, 17, 24, 31, 39, 40)


def check_flash_stablelm(results: dict) -> None:
    """K3 at stablelm-12b's heads (32 / 8 KV of D 160: three 64-column TMA
    boxes, the last half fill, and P V as two products), causal: the
    recompute's forward (16 x 512, bf16) and the train microbatch's
    forward and backward (2 x 1024, f32), against the plain versions and
    timed (:func:`flash_timed`); then the f32 shapes of the rlhf and
    embodied phases.  Its errors count in K3's entries."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    heads = STABLELM_HEADS
    for dtype, B, S, backward in ((torch.bfloat16, 16, 512, False),
                                  (torch.float32, 2, 1024, True)):
        c = flash_case(g, dtype, B, S, 0, backward, heads)
        fold_flash_errors(results, c)
        log(flash_timed(c, dtype, B, S, heads) + f" (stablelm-12b; "
            f"head_dim limits: forward {fa.MAX_HEAD_DIM}, backward "
            f"{fa.MAX_HEAD_DIM_BWD})")
        del c
        torch.cuda.empty_cache()
    # the f32 shapes the rlhf and embodied phases give K3: the RLHF
    # passes and train step (16 x 40), the embodied act (64 x 5, 32 x 5
    # a hybrid chunk) and train step (1024 x 6)
    for B, S, backward in ((16, 40, True), (64, 5, False), (32, 5, False),
                           (1024, 6, True)):
        c = flash_case(g, torch.float32, B, S, 0, backward, heads)
        fold_flash_errors(results, c)
        log(c["line"] + " (stablelm-12b, a shape of the rlhf or embodied "
            "phase)")
        del c
    torch.cuda.empty_cache()


WHISPER_HEADS = (20, 20, 64)  # whisper-large-v3's (H, KV, D): d 1280 / 20
WHISPER_FRAMES = 1500  # its encoder's sequence (the stub frontend's frames)
WHISPER_RECOMPUTE = (8, 448)  # rollouts x tokens (whisper's max_seq_len)
WHISPER_TRAIN = (4, 224, 224)  # sequences, prompt and response tokens
VLM_HEADS = (64, 8, 128)  # llama-3.2-vision-90b's self layers: d 8192 / 64
VLM_RECOMPUTE = (8, 512)  # rollouts x tokens


def check_flash_whisper(results: dict) -> None:
    """K3 at whisper-large-v3's encoder heads (20 / 20 of D 64),
    bidirectional over its 1500 frames (a 28-row tail on 64-row tiles):
    the recompute's forward (8 x 1500, bf16) and the train microbatch's
    forward and backward (2 x 1500, f32), against the plain versions and
    timed (:func:`flash_timed`, the bound over all S^2 pairs), with the
    backward's f32 workspace.  Its errors count in K3's entries.  Fails
    the run if the backward kernel is not faster than its plain version
    at this shape (a fault ROADMAP.md once listed)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    heads, S = WHISPER_HEADS, WHISPER_FRAMES
    for dtype, B, backward in ((torch.bfloat16, 8, False),
                               (torch.float32, 2, True)):
        c = flash_case(g, dtype, B, S, 0, backward, heads, causal=False)
        fold_flash_errors(results, c)
        log(flash_timed(c, dtype, B, S, heads, causal=False)
            + " (whisper-large-v3 encoder)")
        if backward:
            kernel, plain, sdpa = c["bwd_ms"]
            assert kernel < plain, (
                f"K3 backward at whisper's encoder shape: {kernel:.4f} ms, "
                f"not faster than its plain version ({plain:.4f} ms)")
            log(f"kernels: K3 backward at whisper's encoder shape "
                f"{kernel:.4f} ms < plain {plain:.4f} ms (SDPA backward "
                f"{sdpa:.4f} ms)")
        del c
        torch.cuda.empty_cache()


def check_flash_phases(results: dict) -> None:
    """K3 at the causal shapes the encdec and vlm phases give it: the
    whisper-large-v3 decoder's self-attention (20 / 20 of D 64) in the
    recompute (8 x 448, bf16) and the train microbatch (2 x 448, f32,
    forward and backward), and llama-3.2-vision-90b's self layers (64 / 8
    KV of D 128) in the recompute (8 x 512, bf16); against the plain
    versions and timed (:func:`flash_timed`).  Its errors count in K3's
    entries."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    n, p, r = WHISPER_TRAIN
    for heads, dtype, (B, S), backward, where in (
            (WHISPER_HEADS, torch.bfloat16, WHISPER_RECOMPUTE, False,
             "whisper-large-v3 decoder, the encdec recompute"),
            (WHISPER_HEADS, torch.float32, (n // 2, p + r), True,
             "whisper-large-v3 decoder, the encdec train microbatch"),
            (VLM_HEADS, torch.bfloat16, VLM_RECOMPUTE, False,
             "llama-3.2-vision-90b self layers, the vlm recompute")):
        c = flash_case(g, dtype, B, S, 0, backward, heads)
        fold_flash_errors(results, c)
        log(flash_timed(c, dtype, B, S, heads) + f" ({where})")
        del c
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the CPU
# ---------------------------------------------------------------------------
def check_reference(arch: str = "yi-9b", sampling=((0.0, 0, 1.0),
                                                  (1.0, 8, 0.9))) -> None:
    """Reduced ``arch`` served on the card and on the CPU from the same
    f32 weights, at each (temperature, top_k, top_p) of ``sampling``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.utils.treeutil import tree_map
    from repro_torch.serve import PagedEngine

    cfg = get_config(arch).reduced()
    cpu_params = init_model(torch.Generator().manual_seed(SEED), cfg,
                            torch.float32, "cpu")
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(3, cfg.vocab_size, size=(6, 23))
    for temp, k, p in sampling:
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
        log(f"ref: reduced {arch} f32 T={temp} top_k={k} top_p={p}: card "
            f"tokens == CPU tokens, max|lp diff|={err:.3g} (tol 1e-3)")


def open_gates(params):
    """A VLM's cross gates at 0.5: ``init_model`` zeros them, as JAX's
    does, and tanh(0) would make every cross layer the identity."""
    if "cross_layers" in params:
        params["cross_layers"]["gate"].fill_(0.5)
    return params


def embeddings(cfg, B: int, g, dtype, device):
    """The stub frontend's output as a batch's entries: (B, 1024, d) image
    tokens for a VLM, (B, 1500, d) audio frames for an encoder-decoder
    (the reduced configs' 16 and 32), from the generator ``g``; nothing
    for the other kinds."""
    import torch

    if cfg.kind == "vlm":
        key, n = "image_embeds", cfg.num_image_tokens
    elif cfg.kind == "encdec":
        key, n = "frame_embeds", cfg.encoder_seq_len
    else:
        return {}
    x = torch.randn((B, n, cfg.d_model), generator=g, device=g.device)
    return {key: x.to(device, dtype)}


STATIC_REF = (("yi-9b", 0), ("yi-9b", 8), ("granite-moe-3b-a800m", 0),
              ("mamba2-370m", 0), ("zamba2-2.7b", 0),
              ("llama-3.2-vision-90b", 0), ("whisper-large-v3", 0))


def check_static_reference(arch: str, window: int = 0) -> None:
    """Reduced ``arch`` (``window`` its sliding window) in f32 from the
    same weights through the static ``Engine`` on the card and on the
    CPU, at T 0 and (but the MoE) at T 1, top-k 8, top-p 0.9: the same
    tokens, logprobs within 1e-3, K2 once a round on the card; at T 0 the
    card's static tokens equal its ``PagedEngine``'s where a layout covers
    the arch.  Prompts of 23 tokens, one row left-padded by 7; 12 new."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import sampling as ks
    from repro_torch.models import init_model
    from repro_torch.serve import Engine, PagedEngine, covers
    from repro_torch.utils.treeutil import tree_map

    cfg = get_config(arch).reduced().replace(sliding_window=window)
    cpu_params = open_gates(init_model(torch.Generator().manual_seed(SEED),
                                       cfg, torch.float32, "cpu"))
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    prompts = np.random.default_rng(SEED).integers(3, cfg.vocab_size,
                                                   size=(6, 23))
    prompts[1, :7] = 0
    for temp, k, p in ((0.0, 0, 1.0),) if cfg.moe is not None else (
            (0.0, 0, 1.0), (1.0, 8, 0.9)):
        kw = dict(max_new_tokens=12, temperature=temp, top_k=k, top_p=p)
        ks.fused_sample_bv.launches = 0
        a = Engine(cfg, device="cuda", **kw).generate(gpu_params, prompts,
                                                      seed=SEED)
        assert ks.fused_sample_bv.launches == 12, ks.fused_sample_bv.launches
        b = Engine(cfg, device="cpu", **kw).generate(cpu_params, prompts,
                                                     seed=SEED)
        assert torch.equal(a.tokens, b.tokens), \
            f"static {arch} w={window} T={temp}: card and CPU tokens differ"
        err = (a.logprobs - b.logprobs).abs().max().item()
        assert err <= 1e-3, f"card and CPU logprobs differ by {err}"
        paged = ""
        if temp == 0.0 and covers(cfg):
            c = PagedEngine(cfg, max_batch=4, page_size=4, max_new_tokens=12,
                            temperature=0.0, prefill_chunk=8,
                            device="cuda").generate(gpu_params, prompts,
                                                    seed=SEED)
            assert torch.equal(c.tokens, a.tokens), \
                f"static {arch} T=0: static and paged tokens differ on the card"
            paged = "; == the card's PagedEngine tokens"
        log(f"ref: reduced {arch} window={window} f32 static Engine T={temp} "
            f"top_k={k} top_p={p}: card tokens == CPU tokens, max|lp diff|="
            f"{err:.3g} (tol 1e-3), fused_sample launches 12 (one a round)"
            f"{paged}")


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


def check_ref_train(arch: str = "yi-9b") -> None:
    """Reduced ``arch`` in f32 from the same weights on the card and the
    CPU: recomputed logprobs, and one train step with two microbatches
    (clip, entropy and KL terms on; an MoE's aux loss among the metrics).
    Then, for a dense stack, the engine's behaviour logprobs against the
    recompute of the same tokens on the card (an MoE recompute drops
    tokens at capacity by design, the engine never does)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import PagedEngine
    from repro_torch.train import (AdamWConfig, TrainHParams, init_adamw,
                                   make_prefill_step, make_train_step)
    from repro_torch.utils.treeutil import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    cpu_params = open_gates(init_model(torch.Generator().manual_seed(SEED + 1),
                                       cfg, torch.float32, "cpu"))
    rng = np.random.default_rng(SEED + 1)
    B, S, P = 4, 100, 40  # S is no multiple of the kernels' 64-row tiles
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    emb = embeddings(cfg, B, torch.Generator().manual_seed(SEED + 1),
                     torch.float32, "cpu")
    prefill = make_prefill_step(cfg)
    lp_cpu = prefill(cpu_params, {"tokens": tokens, **emb})
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    lp_gpu = prefill(gpu_params, {"tokens": tokens.cuda(), **{
        k: v.cuda() for k, v in emb.items()}}).cpu()
    lp_err = (lp_gpu - lp_cpu).abs().max().item()
    # f32 both sides: cuBLAS and the CPU sum in other orders
    assert lp_err <= 1e-4, f"recompute: card vs CPU logprobs differ {lp_err}"

    batch = grpo_batch(rng, tokens, P, group_size=4)
    batch.update(emb)
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
    line = (f"ref-train: reduced {arch} f32 B={B} S={S}: recompute card vs "
            f"CPU max|lp diff|={lp_err:.3g} (tol 1e-4); train step (2 "
            f"microbatches, clip+entropy+KL) every metric within rtol 1e-4: "
            f"loss {gm['loss']:.6f} vs {cm['loss']:.6f}, grad_norm "
            f"{gm['grad_norm']:.6f} vs {cm['grad_norm']:.6f}, aux_loss "
            f"{gm['aux_loss']:.6g} vs {cm['aux_loss']:.6g}; params "
            f"max|diff|={p_err:.3g} (tol 2 lr = {2 * lr}), mu max rel "
            f"diff={mu_err:.3g} (tol 1e-3)")
    if cfg.moe is not None:
        assert cm["aux_loss"] > 0, cm
    if cfg.moe is not None or emb:
        # the static engine decodes a VLM or encoder-decoder against zero
        # cross caches (JAX's passes no embeddings), so its logprobs are
        # not the recompute's
        log(line + (f" (with {', '.join(emb)})" if emb else ""))
        return

    eng = PagedEngine(cfg, max_batch=4, page_size=4, max_new_tokens=12,
                      temperature=1.0, top_k=8, top_p=0.9, eos_token=-1,
                      prefill_chunk=8, device="cuda")
    res = eng.generate(gpu_params, rng.integers(3, cfg.vocab_size, (4, 23)),
                       seed=SEED)
    lp = prefill(gpu_params, {"tokens": res.tokens.cuda()}).cpu()
    mis = (lp[:, 23:] - res.logprobs[:, 23:]).abs().max().item()
    assert mis <= 2e-4, f"engine vs recompute logprobs differ by {mis}"
    log(f"{line}; engine vs recompute on the card max|lp diff|={mis:.3g} "
        f"(tol 2e-4)")


# ---------------------------------------------------------------------------
# phases 5-6: yi-9b at full width
# ---------------------------------------------------------------------------
def serve_once(cfg, params, prompts, *, temperature, top_k, top_p,
               warm: bool = True, max_new_tokens: int = 64):
    import torch

    from repro_torch.serve import PagedEngine

    eng = PagedEngine(cfg, max_batch=8, page_size=16, prefill_chunk=256,
                      max_new_tokens=max_new_tokens, max_seq_len=1024,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_token=-1, dtype=torch.bfloat16, device="cuda")
    eng.set_params(params)
    if warm:  # before a timed run
        eng.submit(prompts[0][:64], max_new_tokens=4, seed=99)
        eng.run()
        torch.cuda.synchronize()
    return eng


def serve(cfg, params, prompts, results: dict) -> None:
    """The serve workload through ``PagedEngine.run``, with the kernels'
    launch counters set to 0 just before and read just after, and gated
    exactly: K2 once per decode batch; on a paged layout K1 once per layer
    per decode batch, and for an MoE stack K5 once per layer per decode
    batch and per prefill chunk, and K4 twice per K5 call; on the state
    layout (SSM, hybrid) K7 once per SSM layer per engine step, which is
    one decode batch (prompts go through it a token a step), and K1, K4,
    K5 never."""
    import torch

    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import ssm_update as ssu
    from repro_torch.utils.treeutil import tree_leaves

    eng = serve_once(cfg, params, prompts, temperature=1.0, top_k=50,
                     top_p=0.9)
    reqs = [eng.submit(p, seed=SEED + i) for i, p in enumerate(prompts)]
    b0, c0, s0 = eng.decode_batches, eng.prefill_chunks, eng.decode_steps
    pa.paged_attention_bhd.launches = 0
    ks.fused_sample_bv.launches = 0
    gmm.grouped_matmul.launches = 0
    gmm.moe_decode_gmm.launches = 0
    ssu.ssm_state_update_bh.launches = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = pa.paged_attention_bhd.launches, ks.fused_sample_bv.launches
    k4, k5 = gmm.grouped_matmul.launches, gmm.moe_decode_gmm.launches
    k7 = ssu.ssm_state_update_bh.launches
    batches = eng.decode_batches - b0
    chunks = eng.prefill_chunks - c0
    steps = eng.decode_steps - s0
    for r in reqs:
        assert len(r.generated) == 64, (r.rid, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated), r.rid
        assert all(math.isfinite(x) and x <= 1e-3 for x in r.logprobs), r.rid
    L = cfg.num_layers
    n_tok = sum(len(r.generated) for r in reqs)
    n_prompt = sum(len(p) for p in prompts)
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    head = (f"serve: {cfg.name} full width ({L} layers, d={cfg.d_model}, "
            f"bf16, {gb:.2f} GB) {len(reqs)} requests, {n_prompt} prompt + "
            f"{n_tok} generated tokens in {wall:.3f} s = {n_tok / wall:.1f} "
            f"generated tok/s; ")
    assert k2 == batches, (k2, batches)
    results["fused_sample"]["launches"] += k2
    if cfg.ssm is not None:  # the state cache layout
        assert batches == steps > 0 and chunks == 0, (batches, steps, chunks)
        assert k7 == L * steps, (k7, steps)
        assert k1 == k4 == k5 == 0, (k1, k4, k5)
        layout = eng.layout
        log(f"{head}{steps} engine steps (one decode batch each, no prefill "
            f"chunks); launches ssm_state_update={k7} (= {L} SSM layers x "
            f"{steps} steps), fused_sample={k2}, paged_attention=0, "
            f"grouped_matmul=0, moe_decode=0; exact-prefix hits "
            f"{layout.exact_prefix_hits}, {len(layout._exact)} prompt "
            f"snapshots + {len(layout._suspended)} preemption snapshots "
            f"held = {layout.snapshot_bytes() / 1e9:.3f} GB (one slot row "
            f"{slot_row_bytes(layout) / 1e6:.1f} MB); card: {card_line()}")
        results["ssm_update"]["launches"] += k7
        breakdown(eng, prompts, SSM_DECODE_KERNELS)
        del eng
        return
    assert k7 == 0, k7
    assert batches > 0 and chunks > 0
    assert k1 == L * batches, (k1, batches)
    moe = ""
    if cfg.moe is not None:
        assert k5 == L * (batches + chunks), (k5, batches, chunks)
        assert k4 == 2 * k5, (k4, k5)
        moe = (f", moe_decode={k5} (= {L} x ({batches} decode batches + "
               f"{chunks} prefill chunks)), grouped_matmul={k4} (= 2 x "
               f"moe_decode)")
        results["grouped_matmul"]["launches"] += k4
        results["moe_decode"]["launches"] += k5
    else:
        assert k4 == k5 == 0, (k4, k5)
    log(f"{head}{batches} decode batches, {chunks} prefill chunks; "
        f"launches paged_attention={k1} (= {L} x {batches}), "
        f"fused_sample={k2}{moe}, ssm_state_update=0; card: {card_line()}")
    results["paged_attention"]["launches"] += k1
    breakdown(eng, prompts, MOE_KERNELS if cfg.moe is not None
              else DECODE_KERNELS)
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


# K3's bf16 forward (the recompute's) first, then its f32 forward and
# backward (the train step's)
FLASH_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                 "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_delta_kernel", "flash_bwd_sum_kernel")


# K1 splits a context over a cluster and merges the splits in the same
# launch: one kernel name holds all of its time
DECODE_KERNELS = ("paged_attention_kernel", "fused_sample_kernel")
SSM_DECODE_KERNELS = ("ssm_update_kernel", "fused_sample_kernel")
# K6's bf16 forward (the recompute's) first, then its f32 forward and
# backward (the train step's)
SSD_KERNELS = ("ssd_fwd_mma_kernel", "ssd_fwd_tf32_kernel",
               "ssd_bwd_tf32_kernel")


def slot_row_bytes(layout) -> int:
    """Bytes of one slot's row of the state cache: what one snapshot
    holds."""
    from repro_torch.serve.layouts import _leaves

    return sum(t.numel() * t.element_size()
               for t in _leaves(layout._zero_row))
MOE_KERNELS = DECODE_KERNELS + ("gmm_mma_kernel", "moe_dispatch_kernel",
                                "moe_combine_kernel")


def breakdown(eng, prompts, kernels, steps: int = 8) -> None:
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
    log_breakdown("breakdown", f"{eng.cfg.name} decode step at batch "
                  f"{eng.max_batch}", wall, rows, kernels)


def greedy_repeat(cfg, params, prompts) -> None:
    """The requests twice at temperature 0: identical tokens.  On the
    state layout (SSM, hybrid), whose prompts go through the decode batch
    a token a step (four 918-step serves took ~220 s of host-bound wall),
    4 of them cut to 64 prompt tokens with 16 new tokens each."""
    import torch

    new = 64
    if cfg.ssm is not None:
        prompts, new = [p[:64] for p in prompts[:4]], 16
    runs = []
    for _ in range(2):
        eng = serve_once(cfg, params, prompts, temperature=0.0, top_k=0,
                         top_p=1.0, warm=False, max_new_tokens=new)
        reqs = [eng.submit(p, seed=SEED + i) for i, p in enumerate(prompts)]
        eng.run()
        runs.append([r.generated for r in reqs])
        del eng
        torch.cuda.empty_cache()
    assert all(len(g) == new for g in runs[0]), runs[0]
    assert runs[0] == runs[1], "greedy repeat gave different tokens"
    log(f"greedy: {cfg.name} {len(prompts)} requests of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens x "
        f"{new} new tokens, two runs at temperature 0: identical tokens")


# ---------------------------------------------------------------------------
# phases 7-8: logprob recompute and training at full width
# ---------------------------------------------------------------------------
# (mean, max) of the engine vs recompute logprobs in bf16, over the
# generated tokens.  yi-9b: the decode path (paged, one token at a time)
# and the full-sequence path round the bf16 activations of 48 layers
# differently, and one bf16 rounding is already 2**-9 relative, so a
# limit near 1e-3 cannot hold; on an H100 the reading is mean 0.0074, max
# 0.031.  granite-moe: besides the roundings, a near-tie in the router
# can pick another expert on the two paths, and the recompute's capacity
# dispatch may drop assignments that the engine's exact combine keeps;
# on an H100 the reading is mean 0.776, max 4.43 (0.02 % dropped).
# mamba2 and zamba2: the two paths round bf16 at other points (the JAX
# package's): the engine's mamba2_decode sums the conv window in f32 and
# rounds once after SiLU, where the recompute's mamba2_block rounds the
# conv to bf16 and adds the bias and applies SiLU in bf16; and one token's
# products are tiled unlike a sequence's.  Each SSM layer's recurrent
# state carries such differences on to every later token.  In f32 the two
# paths agree within 3e-6 on the reduced models (ref-train).  On an H100
# the reading is mean 0.2349, max 1.587 for mamba2 (48 SSM layers) and
# mean 0.02084, max 0.1092 for zamba2.
# The limits leave about 3x room over the readings and still fail on a
# wrong attention, expert product, scan or logprob.
MISMATCH_TOL = {"yi-9b": (0.02, 0.1), "granite-moe-3b-a800m": (2.5, 15.0),
                "mamba2-370m": (0.7, 5.0), "zamba2-2.7b": (0.07, 0.35)}


def moe_recompute_report(params, batch, prefill):
    """Two more scoring passes of an MoE recompute, each with
    ``moe_block`` swapped for a moment: (the share of routed assignments
    that its capacity dispatch drops, from each layer's own routing;
    the logprobs with the serve path's drop-free ``moe_decode_exact`` in
    its place, so the drops and the two paths' roundings can be told
    apart)."""
    import torch

    from repro_torch.models import moe as moe_mod

    block, counts = moe_mod.moe_block, [0, 0]

    def counting(p, cfg, x):
        T = x.shape[0] * x.shape[1]
        _, _, idx = moe_mod._route(p, cfg, x.reshape(T, -1))
        per_expert = torch.bincount(idx.reshape(-1),
                                    minlength=cfg.moe.num_experts)
        C = moe_mod._capacity(T, cfg)
        counts[0] += int((per_expert - C).clamp(min=0).sum())
        counts[1] += idx.numel()
        return block(p, cfg, x)

    def drop_free(p, cfg, x):
        return moe_mod.moe_decode_exact(p, cfg, x), torch.zeros(
            (), device=x.device)

    try:
        moe_mod.moe_block = counting
        prefill(params, batch)
        moe_mod.moe_block = drop_free
        lp_exact = prefill(params, batch)
    finally:
        moe_mod.moe_block = block
    return counts[0] / counts[1], lp_exact


ROLLOUTS = (16, 448, 64)  # requests, prompt tokens, new tokens


def rollouts(cfg, params, dtype):
    """The recompute's input: 16 engine rollouts of 448 + 64 tokens."""
    import numpy as np
    import torch

    from repro_torch.serve import PagedEngine

    B, P, N = ROLLOUTS
    prompts = np.random.default_rng(SEED + 3).integers(3, cfg.vocab_size,
                                                       (B, P))
    eng = PagedEngine(cfg, max_batch=B, page_size=16, prefill_chunk=512,
                      max_new_tokens=N, max_seq_len=P + N, temperature=1.0,
                      top_k=50, top_p=0.9, eos_token=-1, dtype=dtype,
                      device="cuda")
    res = eng.generate(params, prompts, seed=SEED)
    torch.cuda.synchronize()
    del eng
    torch.cuda.empty_cache()
    return res


# (median, mean, max) of the engine vs the drop-free recompute of its
# rollouts in f32 at full depth: the serve and recompute paths of
# granite-moe with f32 roundings.  Most tokens agree to f32 precision; a
# router near-tie that the two paths break differently moves a few.  On
# an H100 the reading is median 2.48e-5, mean 0.00357, max 0.887; the
# limits leave about 3x room.
F32_PATHS_TOL = (1e-4, 0.01, 2.5)


def moe_f32_paths(cfg) -> None:
    """granite-moe at full depth in f32 (the serve weights before their
    bf16 rounding): the engine's rollouts against their recompute, with
    the drop-free combine and with ``moe_block``.  What is left of the
    bf16 gap once both paths round as f32 does."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.train import make_prefill_step

    _, P, _ = ROLLOUTS
    params = init_model(torch.Generator(device="cuda").manual_seed(SEED),
                        cfg, torch.float32, "cuda")
    res = rollouts(cfg, params, torch.float32)
    batch = {"tokens": res.tokens.cuda()}
    prefill = make_prefill_step(cfg)
    lp = prefill(params, batch)[:, P:].cpu()
    share, lp_exact = moe_recompute_report(params, batch, prefill)
    exact = (lp_exact[:, P:].cpu() - res.logprobs[:, P:]).abs()
    gap = (lp - res.logprobs[:, P:]).abs()
    readings = (exact.median().item(), exact.mean().item(),
                exact.max().item())
    assert all(r <= t for r, t in zip(readings, F32_PATHS_TOL)), (
        f"f32 engine vs drop-free recompute: (median, mean, max) |diff| "
        f"{readings} > {F32_PATHS_TOL}")
    log(f"recompute-f32: {cfg.name} full width ({cfg.num_layers} layers, "
        f"f32) engine vs drop-free recompute of its {res.tokens.shape[0]} "
        f"rollouts: median|diff|={readings[0]:.4g} mean={readings[1]:.4g} "
        f"max={readings[2]:.4g} (tol {F32_PATHS_TOL}); engine vs moe_block "
        f"recompute mean|diff|="
        f"{gap.mean():.4g} max={gap.max():.4g} ({100 * share:.4f}% of the "
        f"routed assignments dropped)")
    del params
    torch.cuda.empty_cache()


def kernel_layers(cfg):
    """(K3 launches, K6 launches) of one forward of ``cfg``: one K3 per
    self-attention layer (a hybrid stack's shared block once per group, a
    VLM's self layers but not its cross layers, an encoder-decoder's
    encoder and decoder layers), one K6 per SSM layer."""
    if cfg.kind == "ssm":
        return 0, cfg.num_layers
    if cfg.kind == "hybrid":
        return cfg.num_layers // cfg.attn_every, cfg.num_layers
    if cfg.kind == "vlm":
        return cfg.num_layers - cfg.num_layers // cfg.cross_attn_every, 0
    return cfg.num_layers + cfg.num_encoder_layers, 0


def recompute(cfg, params, results: dict, passes: int = 5) -> None:
    """Step 2 of a GRPO iteration: the engine generates 16 rollouts
    (448-token prompts + 64 new tokens, S = 512) and ``make_prefill_step``
    scores them at full depth in bf16: one warm-up pass, then ``passes``
    timed passes, each with one K3 launch per attention layer and one K6
    launch per SSM layer; the median is reported."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.train import make_prefill_step

    B, P, N = ROLLOUTS
    t0 = time.perf_counter()
    res = rollouts(cfg, params, torch.bfloat16)
    gen_s = time.perf_counter() - t0
    tokens = res.tokens.cuda()
    assert tokens.shape == (B, P + N)
    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens}
    prefill(params, batch)  # warm-up at the timed shape
    torch.cuda.synchronize()
    walls, k3, k6 = [], 0, 0
    want3, want6 = kernel_layers(cfg)
    for _ in range(passes):
        fa.flash_attention_bhsd.launches = 0
        ssd.ssd_scan_bhcsp.launches = 0
        t0 = time.perf_counter()
        lp = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        n3, n6 = fa.flash_attention_bhsd.launches, ssd.ssd_scan_bhcsp.launches
        assert (n3, n6) == (want3, want6), (n3, n6, want3, want6)
        k3, k6 = k3 + n3, k6 + n6
    wall = statistics.median(walls)
    assert lp.shape == (B, P + N)
    assert torch.isfinite(lp).all(), "recompute: non-finite logprobs"
    gap = (lp[:, P:].cpu() - res.logprobs[:, P:]).abs()
    mean_gap, max_gap = gap.mean().item(), gap.max().item()
    mean_tol, max_tol = MISMATCH_TOL[cfg.name]
    assert mean_gap <= mean_tol, (
        f"engine vs recompute: mean|diff| {mean_gap} > {mean_tol}")
    assert max_gap <= max_tol, (
        f"engine vs recompute: max|diff| {max_gap} > {max_tol}")
    drops = ""
    if cfg.moe is not None:
        from repro_torch.models.moe import _capacity

        share, lp_exact = moe_recompute_report(params, batch, prefill)
        exact = (lp_exact[:, P:].cpu() - res.logprobs[:, P:]).abs()
        paths = (lp_exact[:, P:] - lp[:, P:]).abs()
        drops = (f"; moe_block's capacity of {_capacity(B * (P + N), cfg)} "
                 f"rows per expert drops {100 * share:.4f}% of the routed "
                 f"assignments; with the drop-free moe_decode_exact in the "
                 f"recompute: engine vs it mean|diff|={exact.mean():.4g} "
                 f"median={exact.median():.4g} max={exact.max():.4g}, it vs "
                 f"moe_block mean|diff|={paths.mean():.4g} max="
                 f"{paths.max():.4g}; engine vs recompute median|diff|="
                 f"{gap.median():.4g}")
    log(f"recompute: {cfg.name} full width ({cfg.num_layers} layers, bf16) "
        f"{B} x {P + N} tokens ({B} rollouts generated in {gen_s:.2f} s) "
        f"scored in {wall * 1e3:.1f} ms (median of {passes} passes: "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f" ms) = {B * (P + N) / wall:.0f} tok/s; flash_attention_bhsd "
        f"launches={k3} (= {want3} x {passes} passes), ssd_scan_bhcsp "
        f"launches={k6} (= {want6} x {passes} passes); "
        f"engine vs recompute logprobs on the {B * N} generated tokens: "
        f"mean|diff|={mean_gap:.4g} (tol {mean_tol}) "
        f"max|diff|={max_gap:.4g} (tol {max_tol}){drops}; card: "
        f"{card_line()}")
    results["flash_fwd"]["launches"] += k3
    if k6:
        results["ssd_scan"]["launches"] += k6
    log_breakdown("recompute", f"{cfg.name} one scoring pass of {B} x "
                  f"{P + N} tokens",
                  wall, profiled(lambda: prefill(params, batch)),
                  FLASH_KERNELS[:1] + SSD_KERNELS[:1])


def train(cfg_full, results: dict, layers: int, steps: int = 3,
          shape=(4, 512, 512)) -> None:
    """Step 4 of a GRPO iteration at full width: f32 params with AdamW, as
    the actor holds them, ``shape`` = 4 sequences x (512 prompt + 512
    response) tokens in two microbatches, GRPO advantages from seeded
    rewards in groups of 4; an encoder-decoder's batch also holds its
    (4, 1500, d) f32 frames.  Depth is cut to ``layers``: the f32 params,
    two moments, the gradient and its accumulator take 20 bytes per
    parameter (yi-9b's 48 layers, 8.8 B parameters, would need 176 GB;
    granite-moe's 32, 3.3 B, 66 GB before activations)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import init_model
    from repro_torch.train import (AdamWConfig, TrainHParams, init_adamw,
                                   make_prefill_step, make_train_step)
    from repro_torch.utils.treeutil import tree_leaves

    cfg = cfg_full.replace(num_layers=layers)
    B, P, R = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = open_gates(init_model(g, cfg, torch.float32, "cuda"))
    opt = init_adamw(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (B, P + R))).cuda()
    batch = grpo_batch(rng, tokens, P, group_size=4)
    emb = embeddings(cfg, B, g, torch.float32, "cuda")
    batch.update(emb)
    batch["old_logprobs"] = make_prefill_step(cfg)(params,
                                                   {"tokens": tokens, **emb})
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5), n_microbatches=2)
    step = make_train_step(cfg, hp)
    def probe():  # an attention weight, an expert's, an SSM layer's A_log
        if cfg.ssm is not None:
            mixer = params["layers"]["mixer"]
            ws = [mixer["A_log"].reshape(-1, mixer["A_log"].shape[-1])[-1],
                  mixer["in_proj"].reshape(-1, *mixer["in_proj"].shape[-2:])
                  [-1, :64, 0]]
            if "shared_attn" in params:
                ws.append(params["shared_attn"]["attn"]["wq"][:64, 0, 0])
        else:
            ws = [params["layers"]["attn"]["wq"][0, :64, 0]]
        if cfg.moe is not None:
            ws.append(params["layers"]["moe"]["gate"][0, -1, :64, 0])
        return [w.clone() for w in ws]

    before = probe()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, fwd, bwd, sfwd, sbwd = [], 0, 0, 0, 0
    n_attn, n_ssm = (n * hp.n_microbatches for n in kernel_layers(cfg))
    for i in range(steps):
        fa.flash_attention_bhsd.launches = 0
        fa.flash_attention_bwd.launches = 0
        ssd.ssd_scan_bhcsp.launches = 0
        ssd.ssd_scan_bwd.launches = 0
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        f, b = fa.flash_attention_bhsd.launches, fa.flash_attention_bwd.launches
        sf, sb = ssd.ssd_scan_bhcsp.launches, ssd.ssd_scan_bwd.launches
        assert f == b == n_attn, (f, b, n_attn)
        assert sf == sb == n_ssm, (sf, sb, n_ssm)
        fwd, bwd, sfwd, sbwd = fwd + f, bwd + b, sfwd + sf, sbwd + sb
        m = {k: float(v) for k, v in m.items()}
        assert all(math.isfinite(x) for x in m.values()), m
        if cfg.moe is not None:
            assert m["aux_loss"] > 0, m
        log(f"train: step {i}: {times[-1] * 1e3:.1f} ms = "
            f"{B * (P + R) / times[-1]:.0f} tok/s; flash launches fwd={f} "
            f"bwd={b}, ssd_scan launches fwd={sf} bwd={sb} (= layers x "
            f"{hp.n_microbatches} microbatches); "
            + ", ".join(f"{k}={v:.5g}" for k, v in sorted(m.items())))
    peak = torch.cuda.max_memory_allocated() / 1e9
    for a, b in zip(before, probe()):
        assert not torch.equal(a, b), "train: params did not change"
    log(f"train: {cfg.name} full width cut to {layers} of "
        f"{cfg_full.num_layers} "
        f"layers ({n_params / 1e9:.3f} B params, f32 + AdamW), {B} x "
        f"{P + R} tokens"
        + "".join(f" with {k} {tuple(v.shape)}" for k, v in emb.items())
        + f" in {hp.n_microbatches} microbatches: median step "
        f"{statistics.median(times) * 1e3:.1f} ms = "
        f"{B * (P + R) / statistics.median(times):.0f} tok/s; peak memory "
        f"{peak:.2f} GB (max_memory_allocated); card: {card_line()}")
    results["flash_fwd"]["launches"] += fwd
    results["flash_bwd"]["launches"] += bwd
    if sfwd:
        results["ssd_scan"]["launches"] += sfwd
        results["ssd_scan_bwd"]["launches"] += sbwd
    log_breakdown("train", f"{cfg.name} one step (a fourth, profiled)",
                  statistics.median(times),
                  profiled(lambda: step(params, opt, batch)),
                  FLASH_KERNELS + SSD_KERNELS)


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter holder, by the kernel's short
    name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssm_update as ssu

    return {"K1": pa.paged_attention_bhd, "K2": ks.fused_sample_bv,
            "K3": fa.flash_attention_bhsd, "K3bwd": fa.flash_attention_bwd,
            "K4": gmm.grouped_matmul, "K5": gmm.moe_decode_gmm,
            "K6": ssd.ssd_scan_bhcsp, "K6bwd": ssd.ssd_scan_bwd,
            "K7": ssu.ssm_state_update_bh}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def gate_launches(want: dict, tag: str) -> None:
    """Every kernel's launches since :func:`zero_launches` equal
    ``want[kernel]``, 0 for a kernel not named."""
    got = {k: fn.launches for k, fn in launch_counters().items()}
    assert got == {k: want.get(k, 0) for k in got}, f"{tag}: {got} != {want}"


STATIC = (8, 64, 32)  # prompts, prompt tokens, new tokens


def static_generate(cfg, params, prompts, want: dict, tag: str):
    """``Engine.generate`` of ``prompts`` on the card, 32 new tokens at T 1,
    top-k 50, top-p 0.9, no EOS, after a short warm-up call; the launch
    counters set to 0 just before and gated to ``want`` just after.
    Returns (the result, wall seconds)."""
    import torch

    from repro_torch.serve import Engine

    kw = dict(temperature=1.0, top_k=50, top_p=0.9, eos_token=-1,
              device="cuda")
    Engine(cfg, max_new_tokens=2, **kw).generate(params, prompts[:, :4],
                                                 seed=99)
    eng = Engine(cfg, max_new_tokens=STATIC[2], **kw)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = eng.generate(params, prompts, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gate_launches(want, tag)
    S = prompts.shape[1]
    gen, lp = res.tokens[:, S:], res.logprobs[:, S:]
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), tag
    assert bool((torch.isfinite(lp) & (lp <= 1e-3)).all()), tag
    return res, wall


def static_step(cfg, params, results: dict) -> None:
    """The static engine on the full-depth bf16 serve weights:
    ``Engine.generate`` of 8 prompts of 64 tokens (equal lengths, so no
    left padding) with 32 new tokens: the prompts decoded a position at a
    time (64 decode steps), then 32 rounds of one K2 launch for the batch
    and a decode step.  Launches gated exactly: K2 = 32, K1 = K3 = 0, and
    for an MoE stack K5 = layers x 96 decode steps, K4 = 2 x K5.  Then
    ``make_prefill_step`` scores the rollouts (K3 once a layer) and the
    engine-vs-recompute mismatch is gated at the paged engine's bars."""
    import numpy as np

    from repro_torch.train import make_prefill_step

    B, P, N = STATIC
    L, steps = cfg.num_layers, P + N
    prompts = np.random.default_rng(SEED + 5).integers(3, cfg.vocab_size,
                                                       (B, P))
    want = {"K2": N}
    moe = ""
    if cfg.moe is not None:
        want.update(K5=L * steps, K4=2 * L * steps)
        moe = (f", moe_decode={L * steps} (= {L} layers x {steps} decode "
               f"steps), grouped_matmul={2 * L * steps}")
    res, wall = static_generate(cfg, params, prompts, want, "static")
    zero_launches()
    lp = make_prefill_step(cfg)(params, {"tokens": res.tokens.cuda()})
    gate_launches({"K3": L}, "static recompute")
    gap = (lp[:, P:].cpu() - res.logprobs[:, P:]).abs()
    mean_gap, max_gap = gap.mean().item(), gap.max().item()
    mean_tol, max_tol = MISMATCH_TOL[cfg.name]
    assert mean_gap <= mean_tol and max_gap <= max_tol, (
        f"static engine vs recompute: mean|diff| {mean_gap}, max {max_gap} "
        f"past ({mean_tol}, {max_tol})")
    log(f"static: {cfg.name} full depth ({L} layers, bf16 weights, f32 "
        f"decode state) Engine.generate of {B} prompts x {P} tokens + {N} "
        f"new (T 1.0, top-k 50, top-p 0.9) in {wall:.3f} s = "
        f"{B * N / wall:.1f} generated tok/s; {steps} decode steps at "
        f"{1e3 * wall / steps:.2f} ms host wall each (sampling included); "
        f"launches fused_sample={N} (one a round){moe}, paged_attention=0, "
        f"flash_attention=0; make_prefill_step of the rollouts "
        f"(flash_attention={L}): engine vs recompute mean|diff|="
        f"{mean_gap:.4g} (tol {mean_tol}) max|diff|={max_gap:.4g} (tol "
        f"{max_tol}); card: {card_line()}")
    results["fused_sample"]["launches"] += N
    results["flash_fwd"]["launches"] += L
    if cfg.moe is not None:
        results["moe_decode"]["launches"] += L * steps
        results["grouped_matmul"]["launches"] += 2 * L * steps


def score(tag: str, cfg, params, batch: dict, results: dict,
          passes: int = 5) -> None:
    """``make_prefill_step`` over ``batch`` (tokens and the stub
    frontend's embeddings) on the card: a warm-up, then ``passes`` timed
    passes with the launches gated exactly (K3 once a self-attention
    layer, nothing else); the median and a profiled pass reported."""
    import torch

    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(cfg)
    prefill(params, batch)
    torch.cuda.synchronize()
    n3 = kernel_layers(cfg)[0]
    walls = []
    for _ in range(passes):
        zero_launches()
        t0 = time.perf_counter()
        lp = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        gate_launches({"K3": n3}, tag)
    B, S = batch["tokens"].shape
    assert lp.shape == (B, S) and bool(torch.isfinite(lp).all()), tag
    wall = statistics.median(walls)
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()
                       if k != "tokens")
    log(f"{tag}: {cfg.name} make_prefill_step of {B} x {S} tokens with "
        f"{inputs} (bf16) in {wall * 1e3:.1f} ms (median of {passes}: "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f" ms) = {B * S / wall:.0f} tok/s; flash_attention launches "
        f"{n3} a pass, nothing else (gated exactly); card: {card_line()}")
    results["flash_fwd"]["launches"] += n3 * passes
    log_breakdown(tag, f"{cfg.name} one scoring pass", wall,
                  profiled(lambda: prefill(params, batch)), FLASH_KERNELS[:1])


def encdec(results: dict) -> None:
    """whisper-large-v3 at full size (32 encoder + 32 decoder layers, d
    1280, 20 heads of 64, vocab 51866; 2.02 B params), random weights and
    random frames for the stub frontend:
      - ``make_prefill_step`` on 8 x 448 tokens with (8, 1500, 1280)
        frames in bf16 (``score``): K3 = 64 a pass (32 bidirectional in
        the encoder, 32 causal in the decoder);
      - a static ``Engine.generate`` of 8 prompts of 16 tokens with 32 new
        tokens: K2 = 32 and nothing else, no K3 (the JAX engine passes no
        frames: the decoder reads zero cross caches, the encoder never
        runs);
      - the bf16 weights freed, three GRPO steps in f32 + AdamW (40.5 GB
        of state) of 4 x 448 tokens with (4, 1500, 1280) f32 frames in two
        microbatches (``train``): K3 and its backward 64 x 2 a step."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.utils.treeutil import tree_leaves

    cfg = get_config("whisper-large-v3")
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t0 = time.perf_counter()
    params = init_model(g, cfg, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"encdec: init_model {cfg.name} bf16 {n / 1e9:.3f} B params, "
        f"{2 * n / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 6)
    B, S = WHISPER_RECOMPUTE
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))).cuda(),
             **embeddings(cfg, B, g, torch.bfloat16, "cuda")}
    score("encdec", cfg, params, batch, results)
    del batch
    prompts = rng.integers(3, cfg.vocab_size, (8, 16))
    _, wall = static_generate(cfg, params, prompts, {"K2": STATIC[2]},
                              "encdec static")
    log(f"encdec: static Engine.generate of 8 prompts x 16 tokens + "
        f"{STATIC[2]} new (T 1.0, top-k 50, top-p 0.9) in {wall:.3f} s = "
        f"{8 * STATIC[2] / wall:.1f} generated tok/s ({wall * 1e3 / 48:.2f} "
        f"ms host wall a decode step); launches fused_sample={STATIC[2]}, "
        f"flash_attention=0 (zero cross caches, no encoder pass)")
    results["fused_sample"]["launches"] += STATIC[2]
    del params
    torch.cuda.empty_cache()
    train(cfg, results, cfg.num_layers, shape=WHISPER_TRAIN)
    torch.cuda.empty_cache()


VLM_GROUPS = 1  # of llama-3.2-vision-90b's 20 (4 self + 1 cross layer each)


def vlm(results: dict) -> None:
    """llama-3.2-vision-90b at full width (d 8192, 64 heads / 8 KV of 128,
    d_ff 28672, vocab 128256) cut to one group of 4 self-attention layers
    and a cross layer (6.39 B params), random weights with the cross gate
    at 0.5, random image tokens for the stub frontend:
      - ``make_prefill_step`` on 8 x 512 tokens with (8, 1024, 8192)
        image tokens in bf16 (``score``): K3 = 4 a pass;
      - a static ``Engine.generate`` of 8 prompts of 64 tokens with 32 new
        tokens: K2 = 32 and nothing else."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.utils.treeutil import tree_leaves

    full = get_config("llama-3.2-vision-90b")
    cfg = full.replace(num_layers=VLM_GROUPS * full.cross_attn_every)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    t0 = time.perf_counter()
    params = open_gates(init_model(g, cfg, torch.bfloat16, "cuda"))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"vlm: init_model {cfg.name} cut to {cfg.num_layers} of "
        f"{full.num_layers} layers, bf16 {n / 1e9:.3f} B params, "
        f"{2 * n / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 7)
    B, S = VLM_RECOMPUTE
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))).cuda(),
             **embeddings(cfg, B, g, torch.bfloat16, "cuda")}
    score("vlm", cfg, params, batch, results)
    del batch
    B, P, N = STATIC
    prompts = rng.integers(3, cfg.vocab_size, (B, P))
    _, wall = static_generate(cfg, params, prompts, {"K2": N}, "vlm static")
    log(f"vlm: static Engine.generate of {B} prompts x {P} tokens + {N} new "
        f"(T 1.0, top-k 50, top-p 0.9) in {wall:.3f} s = "
        f"{B * N / wall:.1f} generated tok/s ({wall * 1e3 / (P + N):.2f} ms "
        f"host wall a decode step); launches fused_sample={N}, "
        f"flash_attention=0")
    results["fused_sample"]["launches"] += N
    del params
    torch.cuda.empty_cache()


GRPO_LAYERS = 8  # of yi-9b's 48: the train phase's cut (f32 + AdamW)


def grpo_launches():
    """(K1, K2, K3, K3 backward) launches since :func:`zero_launches`: the
    kernels of the runners' paths."""
    counters = launch_counters()
    return tuple(counters[k].launches for k in ("K1", "K2", "K3", "K3bwd"))


def check_sync_copies(runner) -> None:
    """After a sync the rollout's and the inference worker's params equal
    the actor's bit for bit in storage of their own, and the actor's next
    in-place train step leaves them alone.  (A function of its own, so no
    reference to the actor's tensors outlives it.)"""
    import numpy as np
    import torch

    from repro_torch.utils.treeutil import pytree_leaves

    rl = getattr(runner, "rl", None) or runner.ppo
    runner._sync_weights()
    actor = pytree_leaves(runner.actor.params())
    copies = {n: pytree_leaves(runner.workers[n].get_state("params"))
              for n in runner.weight_sync_workers}
    for n, ls in copies.items():
        assert all(torch.equal(a, c) for a, c in zip(actor, ls)), n
        assert all(a.data_ptr() != c.data_ptr()
                   for a, c in zip(actor, ls)), n
    kept = [c[..., :8].clone() for c in copies["rollout"]]
    shape = (rl.batch_size, rl.prompt_len + rl.max_new_tokens)
    runner.actor.train({"tokens": np.full(shape, 7, np.int64),
                        "old_logprobs": np.zeros(shape, np.float32),
                        "advantages": np.ones(shape, np.float32),
                        "loss_mask": np.ones(shape, np.float32)})
    assert not all(torch.equal(a[..., :8], k) for a, k in zip(actor, kept)), \
        "grpo: the extra train step changed nothing"
    for n, ls in copies.items():
        assert all(torch.equal(c[..., :8], k) for c, k in zip(ls, kept)), n


def _offload_probe(worker, freed: list):
    """Wrap ``worker.offload`` so each call records (bytes freed on the
    card, state bytes moved); returns the original method."""
    import torch

    orig = worker.offload

    def offload(keys=None):
        torch.cuda.synchronize()
        m0, sb = torch.cuda.memory_allocated(), worker.state_bytes()
        moved = orig(keys)
        freed.append((m0 - torch.cuda.memory_allocated(),
                      sb - worker.state_bytes()))
        return moved

    worker.offload = offload
    return orig


def grpo(results: dict, mode: str) -> None:
    """One RL run end to end through the runtime: ``GRPORunner`` on yi-9b
    at full width cut to 8 layers, f32 params with AdamW in the actor,
    synced as they are (copies) into the rollout's paged engine and the
    inference worker; profile -> plan -> 3 iterations of rollout (K1, K2),
    logprob recompute (K3), reward and a train step (K3 and its
    backward).  Gates: every worker on the card; launches per iteration
    exact (K1 = layers x decode batches, K2 = decode batches, K3 = layers
    per recompute pass and per train forward, its backward = layers per
    train step; a wrapper given a CUDA tensor launches its kernel or
    raises, so exact counts also show that no plain version ran);
    finite metrics and changed params; the synced weights equal to the actor's bit for
    bit after a sync and left alone by the next train step; the
    profile's offload of the actor frees >= 90 % of its state bytes on
    the card; in collocated mode the plan's first switch cost is the
    profiled on/offload seconds; after the teardown the run holds
    nothing on the card.
    (The async horizon, ``async_depth=1``, runs in the CPU tests and at a
    reduced size in ``tests/test_torch_cuda.py``: its run here would not
    fit the phase's time.)"""
    import torch

    from repro_torch.comm.primitives import reset_router
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import Temporal
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import AdamWConfig, TrainHParams
    from repro_torch.utils.treeutil import pytree_leaves

    from repro_torch.analysis import analyze, format_findings
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.report import plan_vs_actual

    L = GRPO_LAYERS
    tag = f"grpo[{mode}]"
    reset_router()
    cfg = get_config("yi-9b").replace(num_layers=L)
    # the auto run takes two iterations (the phase's time goes to recover)
    rl = GRPOConfig(batch_size=16, group_size=4, prompt_len=8,
                    max_new_tokens=64, temperature=1.0,
                    iterations=2 if mode == "auto" else 3,
                    profile_batches=(8, 16), mode=mode, seed=SEED)
    # the entropy bonus keeps the gradient alive while every reward of a
    # group is equal (random weights rarely answer right)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5), entropy_coef=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = GRPORunner(cfg, rl, hp)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert all(w.device.type == "cuda" for w in runner.workers.values()), \
        {n: w.device for n, w in runner.workers.items()}
    assert runner.rollout.engine.cache.k.is_cuda
    probe = [t[..., :8].clone() if t.dim() else t.clone()
             for t in pytree_leaves(runner.actor.params())]
    eng = runner.rollout.engine
    # the profile's own offload of the actor (measure_onoffload), against
    # its state bytes: an offload frees the card only when nothing else
    # holds the tensors
    freed = []
    actor_offload = _offload_probe(runner.actor, freed)
    t0 = time.perf_counter()
    runner.profile()
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    # the wrapper and the bound method it calls hold the actor: left
    # in place they would keep its state on the card after the run
    del runner.actor.offload, actor_offload
    runner.plan_execution()
    # strict: every execute() lints the plan (flowlint passes 1-2) before
    # binding a worker; a finding of severity error raises
    runner.controller.strict = True
    t0 = time.perf_counter()
    findings = analyze(runner.plan.graph, runner.plan,
                       cluster=runner.cluster,
                       cfg=runner.controller.scheduler_cfg,
                       cycle_specs=runner.cycle_specs())
    lint_s = time.perf_counter() - t0
    for line in format_findings(findings).splitlines():
        log(f"{tag}: lint: {line}")
    log(f"{tag}: strict lint of the plan (passes 1-2): {len(findings)} "
        f"finding(s) in {lint_s * 1e3:.2f} ms; every iteration lints again")
    priced = {n: (cm.onload_time, cm.offload_time, cm.sync_time)
              for n, cm in runner.controller.profiles.items()}
    log(f"{tag}: yi-9b full width cut to {L} of 48 layers, f32 + AdamW "
        f"(state {runner.actor.state_bytes() / 1e9:.2f} GB), batch "
        f"{rl.batch_size} = {rl.batch_size // rl.group_size} prompts x "
        f"{rl.group_size}, {rl.prompt_len} + {rl.max_new_tokens} tokens,"
        f" T {rl.temperature}; runner built in {build_s:.1f} s, "
        f"profiled in {profile_s:.1f} s")
    for name, cm in runner.controller.profiles.items():
        log(f"{tag}: profile {name}: base_time={cm.base_time:.6g} s "
            f"slope_time={cm.slope_time:.6g} s/item "
            f"onload_time={cm.onload_time:.6g} s "
            f"offload_time={cm.offload_time:.6g} s "
            f"sync_time={cm.sync_time:.6g} s "
            f"tail_factor={cm.tail_factor:.6g} "
            f"base_mem={cm.base_mem / 1e9:.3f} GB")
    for line in runner.plan.pretty().splitlines():
        log(f"{tag}: plan: {line}")
    totals = [0, 0, 0, 0]
    # the auto run is traced, for the plan-vs-actual report
    tracer = obs_trace.install() if mode == "auto" else None
    prev_reg = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    for it in range(rl.iterations):
        zero_launches()
        d0 = eng.decode_batches
        s0 = runner.sync_stats["seconds"]
        st = runner.run_iteration(it)
        torch.cuda.synchronize()
        k = grpo_launches()
        db = eng.decode_batches - d0
        calls = {}
        stage_s = {}
        for name, a, b, _ in runner.controller.last_timeline:
            calls[name] = calls.get(name, 0) + 1
            stage_s[name] = stage_s.get(name, 0.0) + (b - a)
        assert k[0] == L * db and k[1] == db, (k, db)
        assert k[2] == L * (calls["inference"] + calls["actor"]), \
            (k, calls)
        assert k[3] == L * calls["actor"], (k, calls)
        m = st.metrics
        assert m and all(math.isfinite(v) for v in m.values()), m
        totals = [a + b for a, b in zip(totals, k)]
        log(f"{tag}: iteration {it}: wall {st.wall_time:.3f} s "
            f"(sync {runner.sync_stats['seconds'] - s0:.4f} s); stages "
            + ", ".join(f"{n} {stage_s[n]:.3f} s x{calls[n]}"
                        for n in stage_s)
            + f"; launches K1={k[0]} K2={k[1]} K3={k[2]} K3bwd={k[3]} "
            f"({db} decode batches); acc={st.accuracy:.3f} "
            f"reward={st.mean_reward:+.3f} loss={m['loss']:+.5g} "
            f"entropy={m.get('entropy', float('nan')):.5g} "
            f"grad_norm={m.get('grad_norm', float('nan')):.5g}")
    if tracer is not None:
        obs_trace.uninstall()
        t0 = time.perf_counter()
        report = plan_vs_actual(runner.plan, runner.controller.profiles,
                                tracer, rl.batch_size,
                                iterations=rl.iterations)
        report_s = time.perf_counter() - t0
        for line in report.format().splitlines():
            log(f"{tag}: plan-vs-actual: {line}")
        log(f"{tag}: plan-vs-actual over {rl.iterations} traced "
            f"iterations: predicted {report.predicted_wall:.4f} s, "
            f"measured {report.measured_wall:.4f} s (x"
            f"{report.wall_ratio:.3f}), bubble fraction "
            f"{report.bubble_fraction():.4f}; {len(tracer.spans())} spans, "
            f"report in {report_s:.3f} s")
        for name, fields in obs_metrics.default_registry().snapshot(
                ).items():
            log(f"{tag}: metric {name} "
                + " ".join(f"{k}={v:.6g}" for k, v in fields.items()))
        del tracer, report
    obs_metrics.set_registry(prev_reg)
    assert not all(torch.equal(a, b[..., :8]) for a, b in
                   zip(probe, pytree_leaves(runner.actor.params()))), \
        "grpo: the actor's params did not change"
    check_sync_copies(runner)
    sync = runner.sync_stats
    log(f"{tag}: weight sync {sync['syncs']} x: {sync['seconds']:.4f} s, "
        f"{sync['bytes'] / 1e9:.3f} GB in all "
        f"({sync['bytes'] / max(sync['seconds'], 1e-12) / 1e9:.1f} GB/s); "
        f"after a sync rollout and inference equal the actor bit for bit "
        f"in other storage, and a train step leaves them alone")
    assert freed and all(f >= 0.9 * sb > 0 for f, sb in freed), freed
    cut = ""
    if mode == "collocated":
        first = runner.plan.schedule
        assert isinstance(first, Temporal)
        # summed as collocated_schedule sums them
        want = priced["rollout"][1] + (priced["inference"][0]
                                       + priced["inference"][2])
        assert first.switch_cost == want, (first.switch_cost, want)
        cut = (f"; the plan priced the first cut at "
               f"{first.switch_cost:.4f} s = rollout offload "
               f"{priced['rollout'][1]:.4f} + inference onload "
               f"{priced['inference'][0]:.4f} + sync "
               f"{priced['inference'][2]:.4f}")
    log(f"{tag}: the profile's actor offload freed "
        + ", ".join(f"{f / 1e9:.3f} GB of {sb / 1e9:.3f} GB "
                    f"({100 * f / sb:.1f} %)" for f, sb in freed)
        + f" in {priced['actor'][1]:.3f} s (onload "
        f"{priced['actor'][0]:.3f} s){cut}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    accs = [s.accuracy for s in runner.stats]
    rewards = [s.mean_reward for s in runner.stats]
    log(f"{tag}: peak memory {peak:.2f} GB (max_memory_allocated); "
        f"accuracy {accs}, mean reward {rewards}; launches over the run "
        f"K1={totals[0]} K2={totals[1]} K3={totals[2]} K3bwd={totals[3]}; "
        f"card: {card_line()}")
    for key, n in zip(("paged_attention", "fused_sample", "flash_fwd",
                       "flash_bwd"), totals):
        results[key]["launches"] += n
    runner.teardown()
    del runner, eng, probe
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert left <= 2**28, f"grpo: {left / 1e9:.3f} GB outlived the run"
    log(f"{tag}: after teardown {left / 1e6:.1f} MB more allocated than "
        f"before the run")

RLHF_LAYERS = 2  # of stablelm-12b's 40: six models' state must fit the card


def rlhf(results: dict) -> None:
    """The paper's RLHF/PPO workflow end to end: ``RLHFRunner`` on
    stablelm-12b at full width (d 5120, 32 heads / 8 KV of 160, qk-norm,
    vocab 100352) cut to 2 of 40 layers, f32 (1.58 B params, 6.33 GB a
    copy: actor and critic 19.0 GB each with AdamW, reference, rollout
    and inference 6.33 GB each), collocated: profile, plan and two
    iterations of rollout (K1, K2), recompute, reference logprobs and
    critic values (K3), reward + GAE, the actor's PPO step with the KL
    term and the critic's value step (K3 and its backward).  The plan
    "auto" would make from the same profiles is logged, not run.
    Gates: every worker on the card; launches per iteration exact (K1 =
    layers x decode batches, K2 = decode batches, K3 = layers x forward
    passes, K3 backward = layers x train steps); finite metrics with
    ``kl_ref``; actor and critic changed and the reference unchanged bit
    for bit; the synced weights equal the actor's in storage of their
    own; the profile's offloads of the actor and of the critic free >=
    90 % of their state bytes; <= 256 MB left after the teardown."""
    import torch

    from repro_torch.comm.primitives import reset_router
    from repro_torch.configs import get_config
    from repro_torch.rl import PPOConfig, RLHFRunner
    from repro_torch.train import AdamWConfig, TrainHParams
    from repro_torch.utils.treeutil import pytree_leaves

    L = RLHF_LAYERS
    tag = "rlhf[collocated]"
    reset_router()
    # the engine's context cap as in the serve phases (8 + 32 tokens here):
    # the default 8192 would hold a 1.34 GB page pool for nothing
    cfg = get_config("stablelm-12b").replace(num_layers=L, max_seq_len=1024)
    ppo = PPOConfig(batch_size=16, prompt_len=8, max_new_tokens=32,
                    iterations=2, mode="collocated", profile_batches=(8, 16),
                    seed=SEED)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5, clip_norm=1.0),
                      kl_coef=ppo.kl_coef, entropy_coef=0.02)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = RLHFRunner(cfg, ppo, hp)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert all(w.device.type == "cuda" for w in runner.workers.values()), \
        {n: w.device for n, w in runner.workers.items()}

    def probe(tree):
        return [t[..., :8].clone() if t.dim() else t.clone()
                for t in pytree_leaves(tree)]

    actor0 = probe(runner.actor.params())
    critic0 = probe(runner.critic.get_state("params"))
    ref0 = [t.clone() for t in pytree_leaves(
        runner.reference.get_state("params"))]
    assert all(torch.equal(a, r[..., :8] if r.dim() else r)
               for a, r in zip(actor0, ref0))
    eng = runner.rollout.engine
    freed = {"actor": [], "critic": []}
    origs = {n: _offload_probe(getattr(runner, n), freed[n])
             for n in freed}
    t0 = time.perf_counter()
    runner.profile()
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    # the profile runs every stage with all six models' state resident
    profile_peak = torch.cuda.max_memory_allocated() / 1e9
    for n in origs:  # the wrappers hold the workers: drop them
        del getattr(runner, n).offload
    del origs
    runner.controller.scheduler_cfg = runner.scheduler_config()
    auto = runner.controller.plan(runner.graph(), total_batch=ppo.batch_size,
                                  mode="auto")
    runner.plan_execution()
    state = {n: runner.workers[n].state_bytes() / 1e9
             for n in ("actor", "critic_v", "reference")}
    log(f"{tag}: stablelm-12b full width (d {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV of {cfg.resolved_head_dim}, vocab "
        f"{cfg.vocab_size}) cut to {L} of 40 layers, f32; state on the card "
        f"after the profile: actor {state['actor']:.2f} GB, critic "
        f"{state['critic_v']:.2f} GB, reference {state['reference']:.2f} "
        f"GB; batch {ppo.batch_size}, {ppo.prompt_len} + "
        f"{ppo.max_new_tokens} tokens; runner built in {build_s:.1f} s, "
        f"profiled in {profile_s:.1f} s (peak {profile_peak:.2f} GB)")
    for name, cm in runner.controller.profiles.items():
        log(f"{tag}: profile {name}: base_time={cm.base_time:.6g} s "
            f"slope_time={cm.slope_time:.6g} s/item "
            f"onload_time={cm.onload_time:.6g} s "
            f"offload_time={cm.offload_time:.6g} s "
            f"base_mem={cm.base_mem / 1e9:.3f} GB")
    for line in runner.plan.pretty().splitlines():
        log(f"{tag}: plan: {line}")
    for line in auto.pretty().splitlines():
        log(f"{tag}: auto would plan (not run): {line}")
    del auto
    value_steps = []
    train_value = runner.critic.train_value

    def critic_step(c):
        value_steps.append(1)
        return train_value(c)

    runner.critic.train_value = critic_step
    totals = [0, 0, 0, 0]
    for it in range(ppo.iterations):
        zero_launches()
        d0, v0 = eng.decode_batches, len(value_steps)
        st = runner.run_iteration(it)
        torch.cuda.synchronize()
        k = grpo_launches()
        db = eng.decode_batches - d0
        calls, stage_s = {}, {}
        for name, a, b, _ in runner.controller.last_timeline:
            calls[name] = calls.get(name, 0) + 1
            stage_s[name] = stage_s.get(name, 0.0) + (b - a)
        vsteps = len(value_steps) - v0
        fwd = (calls["inference"] + calls["reference"] + calls["critic_v"]
               + calls["actor"] + vsteps)
        assert k[0] == L * db and k[1] == db, (k, db)
        assert k[2] == L * fwd, (k, calls, vsteps)
        assert k[3] == L * (calls["actor"] + vsteps), (k, calls, vsteps)
        m = st.metrics
        assert m and all(math.isfinite(v) for v in m.values()), m
        assert "kl_ref" in m and math.isfinite(st.value_loss), (m, st)
        totals = [a + b for a, b in zip(totals, k)]
        log(f"{tag}: iteration {it}: wall {st.wall_time:.3f} s; stages "
            + ", ".join(f"{n} {stage_s[n]:.3f} s x{calls[n]}"
                        for n in stage_s)
            + f"; launches K1={k[0]} K2={k[1]} K3={k[2]} K3bwd={k[3]} "
            f"({db} decode batches, {fwd} forward passes, "
            f"{calls['actor'] + vsteps} train steps); "
            f"reward={st.mean_reward:+.3f} value_loss={st.value_loss:.5g} "
            f"loss={m['loss']:+.5g} kl_ref={m['kl_ref']:.5g} "
            f"grad_norm={m.get('grad_norm', float('nan')):.5g}")
    del runner.critic.train_value, critic_step, train_value
    assert not all(torch.equal(a, b) for a, b in
                   zip(actor0, probe(runner.actor.params()))), \
        "rlhf: the actor's params did not change"
    assert not all(torch.equal(a, b) for a, b in
                   zip(critic0, probe(runner.critic.get_state("params")))), \
        "rlhf: the critic's params did not change"
    ref = pytree_leaves(runner.reference.get_state("params"))
    actor = pytree_leaves(runner.actor.params())
    assert all(torch.equal(a, b) for a, b in zip(ref0, ref)), \
        "rlhf: the reference moved"
    assert all(r.data_ptr() != a.data_ptr() for r, a in zip(ref, actor))
    del ref, actor, ref0
    check_sync_copies(runner)
    for n, f in freed.items():
        assert f and all(x >= 0.9 * sb > 0 for x, sb in f), (n, f)
    log(f"{tag}: the reference equals the initial actor bit for bit in "
        f"storage of its own; after a sync rollout and inference equal the "
        f"actor bit for bit in other storage; the profile's offloads freed "
        + "; ".join(f"{n} " + ", ".join(f"{x / 1e9:.3f} GB of {sb / 1e9:.3f}"
                                       f" GB ({100 * x / sb:.1f} %)"
                                       for x, sb in f)
                    for n, f in freed.items()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: peak memory {peak:.2f} GB (max_memory_allocated); "
        f"launches over the run K1={totals[0]} K2={totals[1]} K3="
        f"{totals[2]} K3bwd={totals[3]}; card: {card_line()}")
    for key, n in zip(("paged_attention", "fused_sample", "flash_fwd",
                       "flash_bwd"), totals):
        results[key]["launches"] += n
    runner.teardown()
    del runner, eng, actor0, critic0
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert left <= 2**28, f"rlhf: {left / 1e9:.3f} GB outlived the run"
    log(f"{tag}: after teardown {left / 1e6:.1f} MB more allocated than "
        f"before the run")


EMBODIED_LAYERS = 2


def embodied_run(mode: str):
    """One ``EmbodiedPPORunner`` run (see :func:`embodied`); returns its
    per-iteration trajectories and what the gates read."""
    import numpy as np
    import torch

    from repro_torch.comm.primitives import reset_router
    from repro_torch.configs import get_config
    from repro_torch.rl import EmbodiedPPOConfig, EmbodiedPPORunner
    from repro_torch.rl import embodied_workflow as emb
    from repro_torch.train import AdamWConfig, TrainHParams
    from repro_torch.utils.treeutil import pytree_leaves

    L = EMBODIED_LAYERS
    tag = f"embodied[{mode}]"
    reset_router()
    cfg = get_config("stablelm-12b").replace(
        name="stablelm-policy", num_layers=L, vocab_size=emb.VOCAB,
        max_seq_len=emb.SEQ)
    rl = EmbodiedPPOConfig(num_envs=64, horizon=16, iterations=2, mode=mode,
                           cycle_chunks=2, lr=1e-5, seed=SEED,
                           profile_batches=(16, 64))
    hp = TrainHParams(optimizer=AdamWConfig(lr=rl.lr, clip_norm=1.0),
                      clip_eps_low=0.2, clip_eps_high=0.2)
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = EmbodiedPPORunner(rl, cfg, hp)
    assert all(w.device.type == "cuda" for w in runner.workers.values()), \
        {n: w.device for n, w in runner.workers.items()}
    p0 = [t[..., :8].clone() if t.dim() else t.clone()
          for t in pytree_leaves(runner.actor.params())]
    runner.profile()
    runner.plan_execution()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gb = runner.actor.state_bytes() / 1e9
    for line in runner.plan.pretty().splitlines():
        log(f"{tag}: plan: {line}")
    calls = {"policy_gen": 0, "train": 0}
    for n in calls:
        fn = runner.task_fns[n]

        def counted(w, c, n=n, fn=fn):
            calls[n] += 1
            return fn(w, c)

        runner.task_fns[n] = counted
    trajs = []
    runner.post_execute = lambda out: (trajs.append(
        {k: np.array(out[k]) for k in ("action_tokens", "action_logprobs",
                                       "rewards", "terminated",
                                       "truncated")}), out)[1]
    totals = [0, 0, 0, 0]
    for it in range(rl.iterations):
        zero_launches()
        before = dict(calls)
        st = runner.run_iteration(it)
        torch.cuda.synchronize()
        k = grpo_launches()
        acts = calls["policy_gen"] - before["policy_gen"]
        steps = calls["train"] - before["train"]
        assert k[0] == k[1] == 0, k
        assert k[2] == L * (acts + steps), (k, acts, steps)
        assert k[3] == L * steps, (k, steps)
        log_mode = runner.controller.last_cycle_log[-1][1]
        assert log_mode == mode, (log_mode, mode)
        m = st.metrics
        assert m and all(math.isfinite(v) for v in m.values()), m
        totals = [a + b for a, b in zip(totals, k)]
        log(f"{tag}: iteration {it}: wall {st.wall_time:.3f} s; cycle ran "
            f"{log_mode} ({runner.controller.last_cycle_log[-1][2]} member "
            f"devices, {runner.controller.last_cycle_log[-1][3]} chunks); "
            f"launches K1={k[0]} K2={k[1]} K3={k[2]} K3bwd={k[3]} ({acts} "
            f"act calls, {steps} train steps); success/env="
            f"{st.success_rate:.3f} reward={st.mean_reward:+.3f} "
            f"loss={m['loss']:+.5g} grad_norm="
            f"{m.get('grad_norm', float('nan')):.5g}")
    assert not all(torch.equal(a, b[..., :8] if b.dim() else b) for a, b in
                   zip(p0, pytree_leaves(runner.actor.params()))), \
        f"{tag}: the policy's params did not change"
    walls = [s.wall_time for s in runner.stats]
    log(f"{tag}: stablelm-12b full width (d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
        f"{cfg.resolved_head_dim}) cut to {L} layers, the embodied token "
        f"space (vocab {cfg.vocab_size}), f32 + AdamW {gb:.2f} GB; "
        f"{rl.num_envs} envs x {rl.horizon} steps; set up and profiled in "
        f"{setup_s:.1f} s; iterations {', '.join(f'{w:.3f}' for w in walls)}"
        f" s; launches over the run K3={totals[2]} K3bwd={totals[3]}")
    runner.teardown()
    del runner, p0
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert left <= 2**28, f"{tag}: {left / 1e9:.3f} GB outlived the run"
    return trajs, totals


def embodied(results: dict) -> None:
    """The embodied PPO workflow end to end: ``EmbodiedPPORunner``, the
    policy at stablelm-12b's full width cut to 2 layers over the embodied
    token space (35 tokens), f32 + AdamW at lr 1e-5; 64 envs, 16 cycle
    steps, two iterations, run once forced collocated and once forced
    hybrid (2 env chunks).  Gates: every worker on the card; the two
    runs' action tokens, rewards and terminated/truncated equal and
    their logprobs within 1e-4 (the port's act noise is a hash of (seed,
    round, step, env id), so the chunking does not change it);
    ``controller.last_cycle_log`` records the forced realization; per
    iteration K3 = layers x (act calls + train forwards) and its backward
    = layers x train steps, exactly, K1 = K2 = 0; finite metrics and
    changed params."""
    import numpy as np

    runs = {mode: embodied_run(mode) for mode in ("collocated", "hybrid")}
    (tc, kc), (th, kh) = runs["collocated"], runs["hybrid"]
    assert len(tc) == len(th) == 2
    worst = 0.0
    for a, b in zip(tc, th):
        for key in ("action_tokens", "rewards", "terminated", "truncated"):
            assert np.array_equal(a[key], b[key]), key
        worst = max(worst, float(np.abs(a["action_logprobs"]
                                        - b["action_logprobs"]).max()))
    assert worst <= 1e-4, worst
    log(f"embodied: collocated and hybrid runs: action tokens, rewards and "
        f"terminated/truncated equal over {len(tc)} iterations, "
        f"max|logprob diff| {worst:.3g} (tol 1e-4); "
        f"{int(sum(t['terminated'].sum() for t in tc))} goals reached, "
        f"{int(sum(t['truncated'].sum() for t in tc))} episodes cut; card: "
        f"{card_line()}")
    for key, n in zip(("paged_attention", "fused_sample", "flash_fwd",
                       "flash_bwd"), [a + b for a, b in zip(kc, kh)]):
        results[key]["launches"] += n


RECOVER_LAYERS = 2  # of yi-9b's 48: three runners' state and checkpoints


def recover(results: dict) -> None:
    """Kill-and-recover on the card: ``GRPORunner`` on yi-9b at full
    width cut to 2 layers, f32 + AdamW, collocated (a plan that does not
    move with the profile's timings), a checkpoint after every iteration
    in a temporary directory.  A first runner takes one iteration and its
    checkpoint is copied; a second resumes from it for three with the
    rollout killed at its first call of iteration 1
    (``FaultInjector(FaultSpec("rollout", iteration=1))``) and recovers;
    a baseline resumes from the copy (and saves nothing).  Gates: exactly one recovery; the
    recovered run's mean reward and accuracy equal the baseline's (JAX's
    e2e tolerance, rtol 1e-4, atol 1e-5) and its final actor params bit
    for bit; launches per iteration exact (as the grpo phase counts
    them); the dead run's state freed before the rebuild and <= 256 MB
    left on the card after the teardowns.  Prints the checkpoints' save
    and load seconds and GB/s and the recovery's seconds by step."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.comm.primitives import reset_router
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import AdamWConfig, TrainHParams
    from repro_torch.utils.treeutil import pytree_leaves

    L = RECOVER_LAYERS
    tag = "recover"
    cfg = get_config("yi-9b").replace(num_layers=L)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-5), entropy_coef=0.01)
    io = {"save": [], "load": []}
    rows = []
    freed = []

    def make(ck, iterations, injector=None, every=1):
        reset_router()
        rl = GRPOConfig(batch_size=16, group_size=4, prompt_len=8,
                        max_new_tokens=16, temperature=1.0,
                        iterations=iterations, profile_batches=(8, 16),
                        mode="collocated", seed=SEED)
        runner = GRPORunner(cfg, rl, hp, checkpoint_dir=ck,
                            checkpoint_every=every, fault_injector=injector)
        save, load = runner.save_trainer_checkpoint, \
            runner.resume_trainer_checkpoint
        run_iteration, teardown = runner.run_iteration, runner.teardown

        def timed_save(it):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(it)
            io["save"].append((time.perf_counter() - t0,
                               runner.actor.state_bytes()))

        def timed_load():
            t0 = time.perf_counter()
            start = load()
            torch.cuda.synchronize()
            if start:
                io["load"].append((time.perf_counter() - t0,
                                   runner.actor.state_bytes()))
            return start

        def counted(it):
            zero_launches()
            # no local reference to the engine: a failure's traceback
            # keeps this frame, and with it whatever the frame holds
            d0 = runner.rollout.engine.decode_batches
            st = run_iteration(it)  # a WorkerFailure passes through
            torch.cuda.synchronize()
            k = grpo_launches()
            db = runner.rollout.engine.decode_batches - d0
            calls = {}
            for name, *_ in runner.controller.last_timeline:
                calls[name] = calls.get(name, 0) + 1
            assert k == (L * db, db, L * (calls["inference"]
                                          + calls["actor"]),
                         L * calls["actor"]), (tag, it, k, db, calls)
            rows.append((it, k))
            return st

        def measured_teardown():
            teardown()
            gc.collect()
            torch.cuda.synchronize()
            freed.append(torch.cuda.memory_allocated())

        runner.save_trainer_checkpoint = timed_save
        runner.resume_trainer_checkpoint = timed_load
        runner.run_iteration = counted
        runner.teardown = measured_teardown
        return runner

    def finish(runner):
        runner.teardown()
        del runner.save_trainer_checkpoint, runner.resume_trainer_checkpoint
        del runner.run_iteration, runner.teardown

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="recover-")
    try:
        ck, ck_base = f"{tmp}/ck", f"{tmp}/ck-baseline"
        warm = make(ck, 1)
        warm.run(verbose=False)
        finish(warm)
        del warm
        shutil.copytree(ck, ck_base)

        inj = FaultInjector(FaultSpec("rollout", iteration=1))
        faulted = make(ck, 3, inj)
        torch.cuda.reset_peak_memory_stats()
        faulted.run(verbose=False)
        faulted_peak = torch.cuda.max_memory_allocated()
        assert inj.fired and faulted.recoveries == 1, faulted.recoveries
        assert faulted.recovery_log[0].worker == "rollout"
        # the teardown inside the recovery let go of the dead run's state
        dead_left = freed[-1] - start
        assert dead_left <= 2**28, (
            f"{tag}: {dead_left / 1e9:.3f} GB of the dead run outlived its "
            "teardown")
        rec = dict(faulted.recovery_seconds)

        # the baseline resumes from the copy and saves nothing (saving
        # moves no state; the phase's time goes to the other runs' saves)
        base = make(ck_base, 3, every=0)
        torch.cuda.reset_peak_memory_stats()
        base.run(verbose=False)
        base_peak = torch.cuda.max_memory_allocated()
        got = [s for s in faulted.stats if s.iteration >= 1]
        want = [s for s in base.stats if s.iteration >= 1]
        assert [s.iteration for s in got] == [s.iteration for s in want]
        for g, w in zip(got, want):
            for f in ("mean_reward", "accuracy"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=1e-4, atol=1e-5, err_msg=f)
        same = all(torch.equal(a, b) for a, b in zip(
            pytree_leaves(faulted.actor.params()),
            pytree_leaves(base.actor.params())))
        assert same, f"{tag}: final actor params differ from the baseline's"
        n_params = sum(t.numel() for t in pytree_leaves(
            faulted.actor.params()))
        for r in (faulted, base):
            finish(r)
        del faulted, base
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert left <= 2**28, f"{tag}: {left / 1e9:.3f} GB outlived the runs"
    for what in ("save", "load"):
        secs = [t for t, _ in io[what]]
        gb = io[what][0][1] / 1e9
        log(f"{tag}: checkpoint {what} x{len(secs)}: {gb:.3f} GB each "
            "(f32 params + AdamW), "
            + ", ".join(f"{t:.3f} s ({gb / t:.2f} GB/s)" for t in secs))
    log(f"{tag}: yi-9b full width cut to {L} layers ({n_params / 1e9:.3f} B "
        f"params), collocated; the rollout killed at iteration 1, "
        f"{len(rows)} iterations counted exactly "
        + ", ".join(f"it {it}: K1={k[0]} K2={k[1]} K3={k[2]} K3bwd={k[3]}"
                    for it, k in rows))
    log(f"{tag}: recovered once in {sum(rec.values()):.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rec.items())
        + f"; the dead run's state freed before the rebuild ("
        f"{dead_left / 1e6:.1f} MB above the phase's start after its "
        f"teardown); peak {faulted_peak / 1e9:.2f} GB faulted, "
        f"{base_peak / 1e9:.2f} GB baseline")
    log(f"{tag}: rewards and accuracy equal the fresh-resume baseline "
        f"(rtol 1e-4, atol 1e-5), final actor params bit for bit; "
        f"after teardown {left / 1e6:.1f} MB more allocated than before; "
        f"phase {time.perf_counter() - t_phase:.1f} s; card: "
        f"{card_line()}")
    totals = [sum(k[i] for _, k in rows) for i in range(4)]
    for key, n in zip(("paged_attention", "fused_sample", "flash_fwd",
                       "flash_bwd"), totals):
        results[key]["launches"] += n


def main() -> int:
    t_start = time.perf_counter()
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
    check_build(so)

    results: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        check_paged_attention(dtype, results)
        check_paged_attention(dtype, results, GRANITE_HEADS,
                              "granite-moe-3b-a800m")
        check_paged_attention(dtype, results, STABLELM_HEADS, "stablelm-12b")
    # the rlhf phase's decode batch: 8 slots of 8 prompt + <= 32 new tokens
    check_paged_attention(torch.float32, results, STABLELM_HEADS,
                          "stablelm-12b", RLHF_DECODE_CTX)
    check_fused_sample(results)
    check_fused_sample(results, 51200, 49155, "granite-moe-3b-a800m")
    check_fused_sample(results, 51200, 50280, "mamba2-370m")
    check_fused_sample(results, 32768, 32000, "zamba2-2.7b")
    check_fused_sample(results, 100352, 100352, "stablelm-12b")
    check_fused_sample(results, 53248, 51866, "whisper-large-v3")
    check_fused_sample(results, 129024, 128256, "llama-3.2-vision-90b")
    check_flash_attention(results)
    check_flash_zamba2()
    check_flash_stablelm(results)
    check_flash_whisper(results)
    check_flash_phases(results)
    check_grouped_matmul(results)
    check_moe_decode(results)
    check_ssd_scan(results)
    check_ssm_update(results)
    for arch in ("yi-9b", "granite-moe-3b-a800m", "mamba2-370m",
                 "zamba2-2.7b"):
        check_reference(arch, ((0.0, 0, 1.0),)
                        if arch == "granite-moe-3b-a800m"
                        else ((0.0, 0, 1.0), (1.0, 8, 0.9)))
        check_ref_train(arch)
    for arch, window in STATIC_REF:
        check_static_reference(arch, window)
    for arch in ("llama-3.2-vision-90b", "whisper-large-v3"):
        check_ref_train(arch)

    # each model's main paths at full width: serve, greedy repeat, the
    # static engine (the dense and MoE models) and recompute from random
    # bf16 weights, then the f32 train step (depth cut where the f32
    # params and AdamW moments would not fit)
    for arch, train_layers in (("yi-9b", 8), ("granite-moe-3b-a800m", 16),
                               ("mamba2-370m", 48), ("zamba2-2.7b", 24)):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_model(torch.Generator(device="cuda").manual_seed(SEED),
                            cfg, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        gb = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params)) / 1e9
        log(f"serve: init_model {arch} bf16 {gb:.2f} GB in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(64, 513, size=16)]
        serve(cfg, params, prompts, results)
        greedy_repeat(cfg, params, prompts)
        if cfg.kind in ("dense", "moe"):
            static_step(cfg, params, results)
        recompute(cfg, params, results)
        del params  # free the serve weights before training
        torch.cuda.empty_cache()
        if cfg.moe is not None:
            moe_f32_paths(cfg)
        train(cfg, results, train_layers)
        torch.cuda.empty_cache()
    # the kinds only the static engine serves, at full width
    encdec(results)
    vlm(results)

    # the runtime end to end: profile -> plan -> execute on the card
    grpo(results, "collocated")
    grpo(results, "auto")
    # the paper's two other workflow families
    rlhf(results)
    embodied(results)
    # checkpoints and kill-and-recover
    recover(results)

    kernels = [results[k] for k in ("paged_attention", "fused_sample",
                                    "flash_fwd", "flash_bwd",
                                    "grouped_matmul", "moe_decode",
                                    "ssd_scan", "ssd_scan_bwd",
                                    "ssm_update")]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the kernels' build "
        "included")
    for r in kernels:
        lib = (f", library {r['library_ms']:.4f} ms" if r["library_ms"]
               else "")
        log(f"summary: {r['name']}: {r['ms']:.4f} ms, {r['launches']} "
            f"launches on the main paths, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}): {100 * r['bound_ms'] / r['ms']:.1f} % of "
            f"its bound{lib}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
