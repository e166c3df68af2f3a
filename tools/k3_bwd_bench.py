#!/usr/bin/env python3
"""Time the K3 backward (flash attention's gradient) of a checkout of the
port on one NVIDIA card, at the four f32 train shapes of ``chip_smoke.py``:
yi-9b causal (2 x 1024, 32 / 4 heads of 128), stablelm-12b (2 x 1024, 32 /
8 of 160), whisper-large-v3's encoder (bidirectional, 2 x 1500, 20 / 20 of
64) and its decoder (causal, 2 x 448).  For each: the kernel against its
plain version (errors gated as ``chip_smoke.py`` gates them), the kernel's,
the plain version's and SDPA's backward times, both bounds and the f32
workspace; with ``--prof`` the device time of each launch by kernel name
(``torch.profiler``); with ``--ptxas`` the build's register, spill and
SASS gates first.

    python3 tools/k3_bwd_bench.py ROOT [--prof] [--ptxas]

ROOT is the root of the checkout to time (its ``src`` and ``chip_smoke.py``
are used): run it twice, on two checkouts, to compare two versions in one
call on one card.
"""
import re
import sys

root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = [((32, 4, 128), 2, 1024, True, "yi-9b causal"),
          ((32, 8, 160), 2, 1024, True, "stablelm-12b causal"),
          ((20, 20, 64), 2, 1500, False, "whisper-large-v3 encoder"),
          ((20, 20, 64), 2, 448, True, "whisper-large-v3 decoder")]


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_bwd_bench: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    so = _build.build()
    print(cs.card_line(), so.name, flush=True)
    if "--ptxas" in sys.argv:
        cs.check_build(so)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for heads, B, S, causal, tag in SHAPES:
        c = cs.flash_case(g, torch.float32, B, S, 0, True, heads,
                          causal=causal)
        print(tag, cs.flash_timed(c, torch.float32, B, S, heads,
                                  causal=causal), flush=True)
        if "--prof" in sys.argv:
            from torch.profiler import ProfilerActivity, profile

            def bwd():
                fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["out"],
                                       c["lse"], c["dout"], causal=causal)

            for _ in range(3):
                bwd()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    bwd()
                torch.cuda.synchronize()
            rows = sorted(((e.key, e.device_time_total / 10 / 1e3)
                           for e in prof.key_averages()
                           if e.device_time_total > 0), key=lambda r: -r[1])
            names = [(re.search(r"\w+_kernel(<[^>]*>)?", k) or
                      re.match(r".{0,40}", k)).group(0) for k, _ in rows]
            print(tag, "device ms a call:", "; ".join(
                f"{n} {t:.4f}" for n, (_, t) in zip(names, rows)),
                flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
