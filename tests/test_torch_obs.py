"""The port's engine and worker obs hooks against the JAX package's: one
paged run with a preemption, a weight swap and copy-on-write under
tracing in both packages gives the same step spans, instants, page
counters and metrics; the hooks record nothing with no tracer armed;
the rollout worker's engine fallback is traced and counted."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.metrics as jmetrics
import repro.obs.trace as jtrace
import repro_torch.obs.metrics as tmetrics
import repro_torch.obs.trace as ttrace
from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.rl.workers import RolloutWorker as JaxRolloutWorker
from repro.serve import PagedEngine as JaxPagedEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.rl.workers import RolloutWorker
from repro_torch.serve import PagedEngine

torch.set_num_threads(1)

SHRINK = dict(vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jax_get_config("yi-9b").reduced().replace(**SHRINK)
    tcfg = get_config("yi-9b").reduced().replace(**SHRINK)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(
        lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(a.shape)), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _traced_run(eng, p0, p1, trace_mod, metrics_mod):
    """A tight pool (preemptions), a shared partial page (copy-on-write)
    and an in-flight weight swap, traced; returns (tracer, snapshot)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, SHRINK["vocab_size"], size=(4, 6))
    reg = metrics_mod.MetricsRegistry()
    prev = metrics_mod.set_registry(reg)
    try:
        with trace_mod.tracing() as tr:
            eng.set_params(p0, version=0)
            shared = [int(t) for t in prompts[0]]
            eng.submit(shared, seed=9)
            eng.run()  # indexes the prompt's pages (a partial one among them)
            reqs = [eng.submit(shared[:5] + [int(prompts[i][5])], seed=i)
                    for i in range(4)]
            for _ in range(4):
                eng.step()
            eng.update_weights(p1, version=1)
            eng.run()
    finally:
        metrics_mod.set_registry(prev)
    return tr, reg.snapshot(), reqs


def _events(tr):
    spans = [(s.name, s.cat, dict(s.args)) for s in tr.spans("engine")]
    instants = [(i.name, i.cat, dict(i.args)) for i in tr.instants()]
    counters = [(c.name, c.value) for c in tr.counters()]
    return spans, instants, counters


def test_engine_hooks_match_jax_on_a_preempting_swapping_run():
    jcfg, tcfg, jp, tp = _model()
    kw = dict(max_batch=4, page_size=4, max_seq_len=32, max_new_tokens=20,
              temperature=0.0, num_pages=10, eos_token=-1)
    je = JaxPagedEngine(jcfg, **kw)
    te = PagedEngine(tcfg, device="cpu", **kw)
    jp1 = jax.tree.map(lambda x: x * 1.05, jp)
    tp1 = jax.tree.map(lambda x: x * 1.05, tp)
    jtr, jsnap, jreqs = _traced_run(je, jp, jp1, jtrace, jmetrics)
    ttr, tsnap, treqs = _traced_run(te, tp, tp1, ttrace, tmetrics)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    jsp, jin, jct = _events(jtr)
    tsp, tin, tct = _events(ttr)
    assert tsp == jsp
    assert tin == jin
    assert tct == jct
    assert tsnap == jsnap
    names = [n for n, _, _ in tin]
    assert "preempt" in names and "weight-swap" in names
    assert tsnap["engine/preemptions"]["value"] == names.count("preempt")
    assert tsnap["engine/weight_swaps"]["value"] == 1
    assert tsnap["serve/cow_pages"]["value"] >= 1
    assert tsnap["serve/prefix_hit_tokens"]["value"] > 0
    assert all(n == "engine-step" for n, _, _ in tsp)


def test_engine_hooks_record_nothing_unarmed():
    _, tcfg, _, tp = _model()
    reg = tmetrics.MetricsRegistry()
    prev = tmetrics.set_registry(reg)
    try:
        assert ttrace.active() is None
        eng = PagedEngine(tcfg, device="cpu", max_batch=2, page_size=4,
                          max_new_tokens=3, temperature=0.0)
        eng.generate(tp, np.full((2, 5), 7, np.int32))
    finally:
        tmetrics.set_registry(prev)
    assert reg.snapshot() == {}


def test_rollout_engine_fallback_is_traced_and_counted():
    """An arch no paged layout covers (a sliding window) falls back to
    the static engine with a warning, an instant and a counter, as the
    JAX worker records them."""
    out = {}
    for name, make, trace_mod, metrics_mod, get in (
            ("jax", JaxRolloutWorker, jtrace, jmetrics, jax_get_config),
            ("port", lambda *a, **k: RolloutWorker(*a, device="cpu", **k),
             ttrace, tmetrics, get_config)):
        cfg = get("yi-9b").reduced().replace(sliding_window=8, **SHRINK)
        reg = metrics_mod.MetricsRegistry()
        prev = metrics_mod.set_registry(reg)
        try:
            with trace_mod.tracing() as tr, warnings.catch_warnings(
                    record=True) as caught:
                warnings.simplefilter("always")
                w = make("rollout/fb", cfg=cfg)
            w.shutdown()
        finally:
            metrics_mod.set_registry(prev)
        assert any("falling back" in str(c.message) for c in caught)
        out[name] = ([(i.name, i.cat, dict(i.args)) for i in tr.instants()],
                     reg.snapshot())
    assert out["port"] == out["jax"]
    instants, snap = out["port"]
    assert [i[0] for i in instants] == ["engine-fallback"]
    assert snap["rollout/engine_fallback"]["value"] == 1


# ---------------------------------------------------------------------------
# ``python -m repro_torch.obs``: the port's flowtrace
# ---------------------------------------------------------------------------
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("grpo", "rlhf", "embodied")


def _run(argv, tmp: Path, **env):
    """A subprocess with a minimal environment and one intra-op thread
    (the tiny runners are slower on many)."""
    base = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}
    base.update(env)
    return subprocess.run([sys.executable] + argv, cwd=tmp, env=base,
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def flowtrace(tmp_path_factory):
    """The port's CLI over the three families with ``--check`` and
    ``--overhead``, on the CPU."""
    tmp = tmp_path_factory.mktemp("flowtrace")
    res = _run(["-m", "repro_torch.obs", "--device", "cpu", "--check",
                "--overhead", "--out", str(tmp / "P")], tmp)
    return tmp, res


@pytest.mark.parametrize("family", FAMILIES)
def test_flowtrace_check_passes_and_writes_jaxs_files(flowtrace, family):
    """``--check`` exits 0 over grpo, rlhf and embodied, and each family
    leaves ``<out>.<family>.trace.json`` and ``.report.json`` beside
    ``<out>.summary.json``, as the JAX tool does."""
    tmp, res = flowtrace
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    report = json.loads((tmp / f"P.{family}.report.json").read_text())
    trace = json.loads((tmp / f"P.{family}.trace.json").read_text())
    summary = json.loads((tmp / "P.summary.json").read_text())
    assert summary["problems"] == []
    fam = {d["family"]: d for d in summary["families"]}[family]
    assert fam["trace_path"] == str(tmp / f"P.{family}.trace.json")
    assert report["measured_wall_s"] > 0 and report["drift"]
    assert any(e.get("name") == "iteration-1" for e in trace["traceEvents"])


def test_flowtrace_overhead_runs(flowtrace):
    """``--overhead`` measures the tracing tax (no test reads its ratio:
    wall-clock ratios under a loaded pytest run are noise)."""
    _, res = flowtrace
    assert "tracing overhead (toy pipeline, min of 5)" in res.stdout


def test_flowtrace_needs_a_device_without_cuda():
    """Like every entry point of the port: the card by default, and an
    error without CUDA unless ``--device cpu`` is given."""
    from repro_torch.obs.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--family", "grpo"])


def _key_paths(x, prefix=""):
    """Every key path of a JSON value, list items under ``[]``."""
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            out.add(f"{prefix}/{k}")
            out |= _key_paths(v, f"{prefix}/{k}")
    elif isinstance(x, list):
        for v in x:
            out |= _key_paths(v, prefix + "[]")
    return out


# runs one flowtrace (the JAX tool loaded by path, or the port's module)
# on the grpo runner with the plan's mode forced, so both runs execute
# the same plan: the spans an auto plan emits (switches, channels)
# follow the profiled wall-clock costs of each run
FORCED = """
import importlib.util, sys
path, mode, out = sys.argv[1], sys.argv[2], sys.argv[3]
if path.endswith(".py"):
    spec = importlib.util.spec_from_file_location("flowtrace", path)
    ft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ft)
    extra = []
else:
    import repro_torch.obs.__main__ as ft
    extra = ["--device", "cpu"]
build = ft.build_runner


def forced(*args, **kw):
    runner = build(*args, **kw)
    runner.mode = mode
    return runner


ft.build_runner = forced
sys.exit(ft.main(["--family", "grpo", "--out", out] + extra))
"""


@pytest.mark.parametrize("mode", ["collocated", "disaggregated"])
def test_flowtrace_artifacts_have_the_jax_tools_keys_and_spans(tmp_path,
                                                               mode):
    """The JAX tool (``tools/flowtrace.py``, loaded by path, not edited)
    and the port's on the same grpo runner and plan (collocated: the
    switches' spans; disaggregated: the channels'): the report, the
    summary and the trace events have the same key paths, and the trace
    the same span names."""
    (tmp_path / "forced.py").write_text(FORCED)
    got = {}
    for side, path in (("J", str(ROOT / "tools" / "flowtrace.py")),
                       ("P", "repro_torch.obs")):
        res = _run([str(tmp_path / "forced.py"), path, mode,
                    str(tmp_path / side)], tmp_path)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        trace = json.loads((tmp_path / f"{side}.grpo.trace.json").read_text())
        got[side] = (
            _key_paths(json.loads(
                (tmp_path / f"{side}.grpo.report.json").read_text())),
            _key_paths(json.loads(
                (tmp_path / f"{side}.summary.json").read_text())),
            {e.get("name") for e in trace["traceEvents"]},
            {k for e in trace["traceEvents"] for k in e})
    assert got["P"] == got["J"]
    names = got["P"][2]
    assert ({"offload:rollout"} if mode == "collocated"
            else {"produce", "consume"}) <= names
