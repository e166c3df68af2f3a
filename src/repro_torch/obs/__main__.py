"""flowtrace on the port: run a workflow family under tracing, emit artifacts.

Counterpart of the JAX package's ``tools/flowtrace.py``, with its flags
and ``--device`` (the card by default, as every entry point of the
port; without CUDA it raises unless ``--device cpu`` is given).  For
each selected family (grpo / rlhf / embodied) it builds a tiny
reduced-config runner on a dry-run cluster (topology from
``REPRO_DRYRUN_HOSTS`` / ``REPRO_DRYRUN_DEVICES``, default 2x4),
profiles and plans it untraced (so the artifact shows the executed run,
not the profiler's calibration churn), runs one untraced warm-up
iteration, then arms the global tracer for the training loop and
writes:

  * ``<out>.<family>.trace.json``  — Chrome-trace/Perfetto timeline
  * ``<out>.<family>.report.json`` — plan-vs-actual report (wall ratio,
    per-device busy/bubble + gap attribution, drift table)
  * ``<out>.summary.json``         — every family's report and the
    anomalies

plus the text report and the metrics snapshot on stdout.  ``--check``
turns report anomalies into exit status 1 (the trace-smoke gate);
``--overhead`` measures the tracing tax on a toy executor workload.

Run:  PYTHONPATH=src python -m repro_torch.obs --family grpo --out OUT \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

FAMILIES = ("grpo", "rlhf", "embodied")


# ---------------------------------------------------------------------------
# tiny reduced-config runners (the JAX tool's)
# ---------------------------------------------------------------------------
def _tiny_model(name):
    from repro_torch.configs import get_config
    return get_config(name).reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)


def build_runner(family: str, iterations: int, cluster, device):
    if family == "grpo":
        from repro_torch.rl import GRPOConfig, GRPORunner
        from repro_torch.train import TrainHParams
        from repro_torch.train.optimizer import AdamWConfig
        rl = GRPOConfig(batch_size=8, group_size=4, iterations=iterations,
                        max_new_tokens=4, mode="auto", seed=0,
                        profile_batches=(4, 8))
        return GRPORunner(_tiny_model("yi-9b"), rl,
                          TrainHParams(optimizer=AdamWConfig(lr=1e-3)),
                          cluster=cluster, device=device)
    if family == "rlhf":
        from repro_torch.rl import PPOConfig, RLHFRunner
        return RLHFRunner(
            _tiny_model("stablelm-12b"),
            PPOConfig(batch_size=8, iterations=iterations, max_new_tokens=3,
                      seed=0, profile_batches=(4, 8)),
            cluster=cluster, device=device)
    if family == "embodied":
        from repro_torch.rl import EmbodiedPPOConfig, EmbodiedPPORunner
        rl = EmbodiedPPOConfig(num_envs=8, horizon=4, iterations=iterations,
                               mode="collocated", seed=0, max_steps=8,
                               profile_batches=(4, 8))
        return EmbodiedPPORunner(rl, cluster=cluster, device=device)
    raise ValueError(family)


# ---------------------------------------------------------------------------
def trace_family(family: str, iterations: int, out_prefix: str,
                 verbose: bool, device) -> dict:
    """Profile + plan untraced, run the loop traced, write artifacts.
    Returns the report's JSON dict (with artifact paths added)."""
    from repro_torch.comm.primitives import reset_router
    from repro_torch.launch.cluster import cluster_from_env
    from repro_torch.obs import default_registry, format_snapshot, tracing
    from repro_torch.obs.report import plan_vs_actual, report_to_json_file

    reset_router()
    default_registry().clear()
    cluster = cluster_from_env(default_hosts=2, default_devices=4)
    runner = build_runner(family, iterations, cluster, device)
    runner.profile()
    runner.plan_execution()
    if verbose:
        print(runner.plan.pretty())
    # one untraced warm-up iteration: the first call at the training
    # shapes pays the first launches' (and the kernels' build) cost,
    # which would drown the schedule in the artifact and skew the drift
    # table by orders of magnitude
    runner.run_iteration(0)

    with tracing() as tr:
        runner.run_loop(verbose=False)

    report = plan_vs_actual(runner.plan, runner.controller.profiles, tr,
                            runner.batch_size, iterations=iterations)
    trace_path = f"{out_prefix}.{family}.trace.json"
    report_path = f"{out_prefix}.{family}.report.json"
    tr.export(trace_path)
    report_to_json_file(report, report_path)

    print(f"\n=== {family} ===")
    print(report.format())
    snap = default_registry().snapshot()
    if snap:
        print("\n-- metrics snapshot --")
        for line in format_snapshot(snap):
            print(line)
    print(f"\ntrace  -> {trace_path}\nreport -> {report_path}")
    d = report.to_json()
    d["family"] = family
    d["trace_path"] = trace_path
    d["report_path"] = report_path
    # serve-tier counters (prefix-cache hits, chunked-prefill deferrals,
    # radix cache size) ride along so the summary tells the rollout
    # throughput story without opening the trace
    d["serve_metrics"] = {
        name: fields for name, fields in sorted(snap.items())
        if name.split("/")[0] in ("serve", "engine")}
    return d


def check_report(d: dict, *, max_bubble: float,
                 ratio_lo: float, ratio_hi: float) -> list:
    """Anomaly checks for the gate.  The dry-run cluster's toy tasks are
    wall-clock noisy, so the wall-ratio band is wide — the gate catches
    broken accounting (ratio off by orders of magnitude, bubble fraction
    near 1.0), not modest drift."""
    problems = []
    r = d["wall_ratio"]
    if not (ratio_lo <= r <= ratio_hi):
        problems.append(
            f"{d['family']}: wall ratio {r:.3f} outside "
            f"[{ratio_lo}, {ratio_hi}]")
    b = d["bubble_fraction"]
    if b > max_bubble:
        problems.append(
            f"{d['family']}: bubble fraction {b:.3f} > {max_bubble}")
    if d["measured_wall_s"] <= 0:
        problems.append(f"{d['family']}: no measured wall (empty trace?)")
    if not d["drift"]:
        problems.append(f"{d['family']}: empty drift table")
    return problems


# ---------------------------------------------------------------------------
def measure_overhead(repeat: int = 5) -> dict:
    """Tracing tax on a toy executor workload: the same Pipelined
    schedule run with tracing off and on; returns min-of-N walls and the
    ratio.  Sleep-dominated tasks so the measurement reflects
    per-invocation instrumentation cost, not task jitter."""
    import numpy as np

    from repro_torch.core.pipeline import ExecutionFlowManager
    from repro_torch.core.scheduler import Leaf, Pipelined
    from repro_torch.obs import tracing

    class W:
        devices = (0,)
        offloaded = False

    def task(w, chunk):
        time.sleep(0.001)
        return chunk

    workers = {"a": W(), "b": W()}
    fns = {"a": task, "b": task}
    sched = Pipelined(Leaf("a", 1, 4), Leaf("b", 1, 4), granularity=4,
                      n_s=1, n_t=1)
    batch = {"x": np.zeros((32, 4), np.float32)}

    def run_once():
        mgr = ExecutionFlowManager(workers, fns)
        t0 = time.perf_counter()
        mgr.run(sched, batch)
        return time.perf_counter() - t0

    run_once()  # warm both paths (thread spawn, allocator)
    off = min(run_once() for _ in range(repeat))
    with tracing():
        run_once()
        on = min(run_once() for _ in range(repeat))
    return {"off_s": off, "on_s": on, "overhead": on / off - 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--family", action="append", default=None,
                    choices=FAMILIES + ("all",),
                    help="workflow family to trace (repeatable; "
                         "default: all)")
    ap.add_argument("--out", default="FLOWTRACE", metavar="PREFIX",
                    help="artifact path prefix (default: FLOWTRACE)")
    ap.add_argument("--iterations", type=int, default=2,
                    help="training iterations to run traced (default: 2)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on report anomalies (the gate)")
    ap.add_argument("--max-bubble", type=float, default=0.95,
                    help="anomaly bound on device-weighted bubble "
                         "fraction (default: 0.95)")
    ap.add_argument("--ratio-band", type=float, nargs=2,
                    default=(0.1, 10.0), metavar=("LO", "HI"),
                    help="anomaly band for measured/predicted wall "
                         "ratio (default: 0.1 10)")
    ap.add_argument("--overhead", action="store_true",
                    help="also measure the tracing tax on a toy "
                         "executor workload")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the kernels' "
                         "plain versions")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the execution plan per family")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    fams = args.family or ["all"]
    if "all" in fams:
        fams = list(FAMILIES)

    t0 = time.perf_counter()
    reports = []
    for fam in fams:
        reports.append(trace_family(fam, args.iterations, args.out,
                                    args.verbose, device))

    problems = []
    if args.check:
        lo, hi = args.ratio_band
        for d in reports:
            problems.extend(check_report(d, max_bubble=args.max_bubble,
                                         ratio_lo=lo, ratio_hi=hi))

    if args.overhead:
        oh = measure_overhead()
        print(f"\ntracing overhead (toy pipeline, min of 5): "
              f"off {oh['off_s'] * 1e3:.2f}ms  on {oh['on_s'] * 1e3:.2f}ms  "
              f"(+{100 * oh['overhead']:.1f}%)")

    summary_path = f"{args.out}.summary.json"
    with open(summary_path, "w") as f:
        json.dump({"families": reports, "problems": problems}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    dt = time.perf_counter() - t0
    print(f"\nflowtrace: {len(reports)} family(ies) in {dt:.1f}s "
          f"-> {summary_path}")
    if problems:
        for p in problems:
            print(f"ANOMALY: {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
