"""Seconds of ``chip_smoke.py``'s SSM and hybrid serves at their two sizes.

``chip_smoke.py`` serves mamba2-370m and zamba2-2.7b (whose prompts go
through the decode batch a token a step) 8 requests cut to 96 prompt
tokens (``SSM_SERVE``), with their warm-up, breakdown and greedy repeat
on 32 (``SSM_SHORT``).  Before that cut it served all 16 requests of
64-512 prompt tokens and used 64 for the rest.  This script runs the
script's own ``serve`` and ``greedy_repeat`` at both sizes, in the order
before, after, after, before for each model, on one card in one process
(the kernels built once), and prints each run's seconds, engine steps
and K7 launches: the cut in seconds on one host.  The launch gates of
``serve`` hold at both sizes.

Run:  python3 tools/ssm_serve_cut.py   (one CUDA card; ~20 min on an H100)
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-370m", "zamba2-2.7b")
ORDER = ("before", "after", "after", "before")


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts the repo's src on sys.path
    return cs


def workload(cs, prompts, size: str):
    """The served prompts and the short cut of ``size``: "before" the
    16 whole prompts and 64, "after" ``SSM_SERVE`` and ``SSM_SHORT``."""
    if size == "before":
        return prompts, 64
    n, tokens = cs.SSM_SERVE
    return [p[:tokens] for p in prompts[:n]], cs.SSM_SHORT


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_serve_cut: no CUDA device; this script runs only on the "
              "card", flush=True)
        return 1
    cs = load_smoke()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_update as ssu
    from repro_torch.models import init_model

    cs.log(f"ssm_serve_cut: {cs.card_line()}; torch {torch.__version__}")
    _build.build()
    _build.library()
    short = cs.SSM_SHORT
    for arch in ARCHS:
        cfg = get_config(arch)
        params = init_model(torch.Generator(device="cuda").manual_seed(
            cs.SEED), cfg, torch.bfloat16, "cuda")
        rng = np.random.default_rng(cs.SEED)  # chip_smoke.py's prompts
        prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(64, 513, size=16)]
        for size in ORDER:
            served, cs.SSM_SHORT = workload(cs, prompts, size)
            results = {"fused_sample": {"launches": 0},
                       "ssm_update": {"launches": 0}}
            t0 = time.perf_counter()
            cs.serve(cfg, params, served, results)
            t1 = time.perf_counter()
            ssu.ssm_state_update_bh.launches = 0
            cs.greedy_repeat(cfg, params, prompts)
            t2 = time.perf_counter()
            greedy_k7 = ssu.ssm_state_update_bh.launches
            cs.SSM_SHORT = short
            gated = results["ssm_update"]["launches"]
            cs.log(f"ssm_serve_cut: {arch} {size}: {len(served)} requests "
                   f"of {sum(map(len, served))} prompt tokens; serve "
                   f"{t1 - t0:.1f} s (gated run {gated // cfg.num_layers} "
                   f"engine steps, K7 {gated}), greedy repeat "
                   f"{t2 - t1:.1f} s (K7 {greedy_k7})")
        del params
        torch.cuda.empty_cache()
    cs.log(f"ssm_serve_cut: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
