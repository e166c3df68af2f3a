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
