"""flowlint CLI on the port: static analysis over every workflow graph.

Counterpart of the JAX package's ``tools/flowlint.py``, with its flags:
runs the M2Flow transformation for each lint target (the three workflow
families in every planning mode, plus the example graphs), lints graph +
plan + implied channel topology, and sweeps the CUDA kernel launches and
the noise keys at the config-zoo shapes (Pass 3).

Exit status is 1 if any finding at or above ``--fail-on`` (default:
warning) survives.

Run:  PYTHONPATH=src python -m repro_torch.analysis [-v] [--target NAME ...]
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--target", action="append", default=None,
                    metavar="NAME",
                    help="lint only targets whose name contains NAME "
                         "(repeatable; default: all)")
    ap.add_argument("--fail-on", choices=("info", "warning", "error"),
                    default="warning",
                    help="exit nonzero on any finding at or above this "
                         "severity (default: warning)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel/RNG pass (Pass 3)")
    ap.add_argument("--list", action="store_true",
                    help="list lint targets and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-target results even when clean")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (
        analyze_target,
        check_kernels,
        check_rng,
        filter_findings,
        format_findings,
    )
    from repro_torch.analysis.targets import all_targets

    targets = all_targets()
    if args.target:
        targets = [t for t in targets
                   if any(pat in t.name for pat in args.target)]
        if not targets:
            print(f"flowlint: no target matches {args.target}",
                  file=sys.stderr)
            return 2
    if args.list:
        for t in targets:
            print(t.name)
        return 0

    t0 = time.perf_counter()
    all_findings = []
    for t in targets:
        findings = analyze_target(t)
        all_findings.extend(findings)
        if findings or args.verbose:
            print(format_findings(
                findings, header=f"== {t.name} ({len(t.graph.nodes)} "
                                 f"nodes) =="))
    if not args.no_kernels:
        findings = check_kernels() + check_rng()
        all_findings.extend(findings)
        if findings or args.verbose:
            print(format_findings(findings, header="== kernels + rng =="))

    gating = filter_findings(all_findings, args.fail_on)
    dt = time.perf_counter() - t0
    n_k = "skipped" if args.no_kernels else "swept"
    print(f"flowlint: {len(targets)} target(s), kernels {n_k}: "
          f"{len(all_findings)} finding(s), {len(gating)} at or above "
          f"{args.fail_on!r} [{dt:.2f}s]")
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
