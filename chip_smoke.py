#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (more for the kernels):
  1. header   the card's name and power limit, and the kernel build time;
  2. kernels  each hand-written kernel against its plain PyTorch version
              at yi-9b's decode shapes, with CUDA-event timings;
  3. ref      a reduced yi-9b served on the card and on the CPU from the
              same weights: the same tokens, at temperature 0 and above;
  4. serve    yi-9b at full width (48 layers, random bf16 weights) through
              ``PagedEngine``: 16 requests, tokens/s, and the kernels'
              launch counters read around the run;
  5. greedy   the same requests twice at temperature 0: identical tokens.

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


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the CPU
# ---------------------------------------------------------------------------
def check_reference() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.model import map_params
    from repro_torch.serve import PagedEngine

    cfg = get_config("yi-9b").reduced()
    cpu_params = init_model(torch.Generator().manual_seed(SEED), cfg,
                            torch.float32, "cpu")
    gpu_params = map_params(lambda t: t.to("cuda"), cpu_params)
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


# ---------------------------------------------------------------------------
# phases 4-5: yi-9b at full width
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


def breakdown(eng, prompts, steps: int = 8) -> None:
    """Where a decode batch's time goes, at full batch (8 requests
    mid-generation, decode only): host wall per step over ``steps``
    unprofiled steps, then ``torch.profiler`` over as many more for the
    device time of every CUDA kernel, the busy and idle share of the
    device, and the kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    rows = [(e.key, e.self_device_time_total / steps / 1e6, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]  # kernels only, s/step
    busy = sum(t for _, t, _ in rows)
    if not busy:
        log("breakdown: the profiler saw no device time (not measured)")
        return
    share = {name: sum(t for k, t, _ in rows if name in k)
             for name in ("paged_attention_kernel", "fused_sample_kernel")}
    log(f"breakdown: decode step at batch {eng.max_batch}: "
        f"{wall * 1e3:.2f} ms host wall; device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% "
        f"idle) in {sum(c for *_, c in rows):.0f} kernels; "
        f"paged_attention {share['paged_attention_kernel'] * 1e3:.3f} ms, "
        f"fused_sample {share['fused_sample_kernel'] * 1e3:.3f} ms")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"breakdown:   {t * 1e3:8.3f} ms {100 * t / busy:5.1f}% "
            f"x{count:<4.0f} {key[:90]}")


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
    check_reference()

    cfg = get_config("yi-9b")
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(SEED),
                        cfg, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"serve: init_model yi-9b bf16 {gb:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(64, 513, size=16)]
    serve(cfg, params, prompts, results)
    greedy_repeat(cfg, params, prompts)

    kernels = [results["paged_attention"], results["fused_sample"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
