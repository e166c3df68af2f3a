"""The MoE slice on the CPU against the JAX package: the plain versions of
the grouped matmul (K4) and the drop-free decode FFN (K5) against the
Pallas kernels (interpret) and the JAX oracles; ``moe_block``,
``moe_decode_exact`` and ``moe_block_dense_ref``; ``forward``,
``policy_loss`` and train steps on reduced MoE configs; and the port's
``PagedEngine`` against JAX's, token for token at temperature 0.  Weights
are bridged from JAX, inputs made with numpy from a seed."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import train as jtrain
from repro.configs import get_config as jax_get_config
from repro.kernels import moe_gmm as jgmm
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.serve import PagedEngine as JaxPagedEngine
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import forward, init_model
from repro_torch.models import moe as tmoe
from repro_torch.serve import PagedEngine
from repro_torch.train import (
    AdamWConfig,
    TrainHParams,
    init_adamw,
    make_prefill_step,
    make_train_step,
    policy_loss,
)
from repro_torch.utils.treeutil import tree_leaves, tree_map

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them
torch.set_num_threads(1)

GRANITE = "granite-moe-3b-a800m"
SCOUT = "llama4-scout-17b-a16e"  # shared expert, top-1
# JAX's own kernel-test tolerances (tests/test_kernels.py), x10 for the
# MoE kernels as there
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# shrunk further than reduced(): the expert shapes stay reduced()'s
SHRINK = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16)
LP_ATOL = 1e-4

_jinit = jax.jit(jmodels.init_model, static_argnums=1)
# the Pallas kernels (interpret) beside the JAX oracle, one compile a shape
_jgmm = jax.jit(lambda b, w: (jgmm.grouped_matmul(b, w, interpret=True),
                              jref.grouped_matmul_ref(b, w)))
_jdecode = jax.jit(lambda *a: (jgmm.moe_decode_gmm(*a, interpret=True),
                               jref.moe_decode_ref(*a)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(jparams):
    return params_from_numpy(_np(jparams), device="cpu")


def _cfgs(name, **kw):
    kw = {**SHRINK, **kw}
    return (jax_get_config(name).reduced().replace(**kw),
            tconfigs.get_config(name).reduced().replace(**kw))


def _with_moe(cfgs, **kw):
    return tuple(c.replace(moe=dataclasses.replace(c.moe, **kw))
                 for c in cfgs)


def _both(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype`` (both
    round f32 to bf16 to nearest even)."""
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_f32(got, want, rel=1e-5):
    """f32 results that sum in another order: within ``rel`` of each value
    and of the largest |want| (the expert outputs reach ~100 here)."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# K4: grouped matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(3, 8, 64, 32), (2, 256, 512, 128)])
def test_grouped_matmul_plain_matches_pallas_and_oracle(E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + D)
    jb, tb = _both(rng.standard_normal((E, C, D), np.float32), dtype)
    jw, tw = _both(0.1 * rng.standard_normal((E, D, F), np.float32), dtype)
    got = tgmm.grouped_matmul_plain(tb, tw)
    assert got.dtype == TDT[dtype] and got.shape == (E, C, F)
    tol = 1e-5 if dtype == "float32" else TOL[dtype] * 10
    for want in (*_jgmm(jb, jw), tref.grouped_matmul_ref(tb, tw)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # ops routes a CPU tensor to the plain version
    torch.testing.assert_close(ops.grouped_matmul(tb, tw), got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_rows_mask(dtype):
    """Rows past rows[e] come back as zeros from the plain version (the
    kernel leaves them unwritten); the rows below are the full product's,
    an expert with no rows among them."""
    E, C, D, F = 4, 16, 64, 32
    rng = np.random.default_rng(3)
    jb, tb = _both(rng.standard_normal((E, C, D), np.float32), dtype)
    jw, tw = _both(0.1 * rng.standard_normal((E, D, F), np.float32), dtype)
    rows = torch.tensor([5, 0, 16, 1], dtype=torch.int32)
    got = _f32(tgmm.grouped_matmul_plain(tb, tw, rows))
    want = _f32(_jgmm(jb, jw)[0])
    tol = 1e-5 if dtype == "float32" else TOL[dtype] * 10
    for e, r in enumerate(rows.tolist()):
        np.testing.assert_allclose(got[e, :r], want[e, :r], atol=tol, rtol=tol)
        assert not got[e, r:].any()


# ---------------------------------------------------------------------------
# K5: drop-free MoE decode
# ---------------------------------------------------------------------------
def _decode_inputs(seed, T, E, k, d, f, dtype, same_experts=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d), np.float32)
    w = [0.05 * rng.standard_normal(s, np.float32)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    if same_experts:  # every token routes to the same k experts
        idx = np.tile(np.arange(k, dtype=np.int32), (T, 1))
    else:
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
            np.int32)
    gv = rng.dirichlet(np.ones(k), size=T).astype(np.float32)
    jx, tx = _both(x, dtype)
    jws, tws = zip(*(_both(a, dtype) for a in w))
    return ((jx, jnp.asarray(idx), jnp.asarray(gv), *jws),
            (tx, torch.from_numpy(idx).long(), torch.from_numpy(gv), *tws))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,E,k,d,f,same", [
    (1, 4, 2, 64, 32, False),
    (7, 8, 2, 128, 64, False),
    (160, 4, 2, 128, 128, False),  # T > 128: capacity rounds up to 256
    (9, 4, 2, 64, 32, True),       # all tokens on the same experts
    (8, 40, 8, 64, 32, True),      # granite's routing width, capacity-free
])
def test_moe_decode_plain_matches_pallas_and_oracle(T, E, k, d, f, same,
                                                    dtype):
    jin, tin = _decode_inputs(T * 31 + E, T, E, k, d, f, dtype, same)
    got = tgmm.moe_decode_gmm_plain(*tin)
    assert got.dtype == TDT[dtype] and got.shape == (T, d)
    tol = TOL[dtype] * 10
    for want in (*_jdecode(*jin), tref.moe_decode_ref(*tin)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    torch.testing.assert_close(ops.moe_decode(*tin), got, atol=0, rtol=0)


def test_decode_capacity_matches_jax():
    for n in (0, 1, 8, 127, 128, 129, 256, 300):
        assert tgmm.decode_capacity(n) == jgmm.decode_capacity(n)


def test_dispatch_slots_are_token_major_and_counted():
    """Each assignment's slot is e * C + (earlier assignments to e), the
    TPU kernel's one-hot cumsum order; counts are per expert."""
    idx = torch.tensor([[2, 0], [0, 1], [2, 1], [0, 2]])
    slot, counts = tgmm._dispatch_plain(idx, 3, 4)
    assert slot.tolist() == [8, 0, 1, 4, 9, 5, 2, 10]
    assert counts.tolist() == [3, 2, 3]


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _moe_params(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp = jax.tree.map(lambda x: x[0], _jinit(jax.random.PRNGKey(seed),
                                             jcfg)["layers"]["moe"])
    return jp, _bridge(jp)


def _hidden(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", [GRANITE, SCOUT])
@pytest.mark.parametrize("capacity_factor", [0.25, 4.0])  # drops, none
def test_moe_block_matches_jax(name, capacity_factor):
    jcfg, tcfg = _with_moe(_cfgs(name), capacity_factor=capacity_factor)
    jp, tp = _moe_params(name)
    x = _hidden(1, 2, 24, jcfg.d_model)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_block(p, jcfg, x))(
        jp, jnp.asarray(x))
    got, aux = tmoe.moe_block(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=1e-6)
    if capacity_factor < 1:  # drops happen: the dense combine differs
        dense, _ = tmoe.moe_block_dense_ref(tp, tcfg, torch.from_numpy(x))
        assert (dense - got).abs().max() > 1e-3


@pytest.mark.parametrize("name", [GRANITE, SCOUT])
def test_moe_decode_exact_and_dense_ref_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _moe_params(name)
    x = _hidden(2, 3, 5, jcfg.d_model)
    tx = torch.from_numpy(x)
    got = tmoe.moe_decode_exact(tp, tcfg, tx)
    for use_kernel in (False, True):
        _close_f32(got, jmoe.moe_decode_exact(jp, jcfg, jnp.asarray(x),
                                              use_kernel=use_kernel))
    dense, aux = tmoe.moe_block_dense_ref(tp, tcfg, tx)
    want, want_aux = jmoe.moe_block_dense_ref(jp, jcfg, jnp.asarray(x))
    _close_f32(dense, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the drop-free decode combine is the dense oracle's
    _close_f32(got, dense)


def test_top_k_ties_go_to_the_lower_index_as_in_jax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.2, 0.4, 0.0]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = tmoe.top_k_stable(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_tied_router_routes_as_jax():
    """Router columns 1 and 2 equal, so every token ties between experts 1
    and 2: both packages keep expert 1."""
    jcfg, tcfg = _cfgs(GRANITE)
    jp, tp = _moe_params(GRANITE)
    router = np.array(jp["router"])
    router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _hidden(3, 2, 6, jcfg.d_model)
    _, _, idx = tmoe._route(tp, tcfg, torch.from_numpy(x).reshape(-1, 64))
    logits = jnp.asarray(x).reshape(-1, 64) @ jp["router"]
    _, want_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    for fn in ("moe_block", "moe_decode_exact"):
        want = getattr(jmoe, fn)(jp, jcfg, jnp.asarray(x))
        got = getattr(tmoe, fn)(tp, tcfg, torch.from_numpy(x))
        if fn == "moe_block":
            want, got = want[0], got[0]
        _close_f32(got, want)


def test_init_moe_keeps_the_router_f32():
    tcfg = tconfigs.get_config(GRANITE).reduced()
    p = init_model(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                   "cpu")
    assert p["layers"]["moe"]["router"].dtype == torch.float32
    assert p["layers"]["moe"]["gate"].dtype == torch.bfloat16
    assert tuple(p["layers"]["moe"]["down"].shape) == (2, 4, 128, 256)
    jp, _ = _moe_params(GRANITE)
    bf = params_from_numpy(_np(jp), device="cpu", dtype=torch.bfloat16)
    assert bf["router"].dtype == torch.float32
    assert bf["up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, policy loss, train steps
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp = _jinit(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("name,use_kernel", [(GRANITE, False),
                                             (GRANITE, True),
                                             (SCOUT, False)])
def test_forward_logits_and_aux_match_jax(name, use_kernel):
    jcfg, tcfg, jp, tp = _model(name)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 40)).astype(
        np.int32)
    want, want_aux = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, use_kernel=use_kernel))(jp, jnp.asarray(tokens))
    for remat in (False, True):
        got, aux = forward(tp, tcfg, torch.from_numpy(tokens).long(),
                           remat=remat)
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
        assert float(aux) > 0


def _rl_batch(rng, B, S, vocab):
    mask = np.zeros((B, S), np.float32)
    mask[:, S // 2:] = 1.0
    return {
        "tokens": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
        "old_logprobs": (-3.0 + 0.3 * rng.standard_normal((B, S))).astype(
            np.float32),
        "advantages": rng.standard_normal((B, S)).astype(np.float32) * mask,
        "loss_mask": mask,
        "ref_logprobs": (-3.0 + 0.3 * rng.standard_normal((B, S))).astype(
            np.float32),
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = _f32(v)
    return out


def _close_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


@pytest.mark.parametrize("name", [GRANITE, SCOUT])
def test_policy_loss_value_and_grads_match_jax(name):
    """Loss, every metric (aux_loss among them) and every param gradient,
    the router's and the experts' included, with entropy and KL terms."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _rl_batch(np.random.default_rng(5), 3, 16, 64)
    kw = dict(entropy_coef=0.01, kl_coef=0.1)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.policy_loss(jcfg, jtrain.TrainHParams(**kw), p,
                                        b), has_aux=True))(jp, _jbatch(batch))
    params = tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, metrics = policy_loss(tcfg, TrainHParams(**kw), params,
                                _tbatch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert metrics.keys() == want_m.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    assert float(metrics["aux_loss"].detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    it = iter(grads)
    _close_trees(tree_map(lambda _: next(it), params), _np(want_g),
                 atol=1e-6, rtol=1e-4)


def test_train_step_matches_jax_two_steps():
    """Two AdamW steps in two microbatches on reduced granite from the same
    params: metrics (aux_loss among them) tightly, params within 2 * lr
    (where g ~ 0 the first Adam steps are close to lr * sign(g))."""
    jcfg, tcfg, jp, tp = _model(GRANITE)
    lr = 1e-3
    opt = dict(lr=lr, clip_norm=0.5, weight_decay=0.01)
    jhp = jtrain.TrainHParams(optimizer=jopt.AdamWConfig(**opt),
                              n_microbatches=2, entropy_coef=0.01)
    thp = TrainHParams(optimizer=AdamWConfig(**opt), n_microbatches=2,
                       entropy_coef=0.01)
    rng = np.random.default_rng(8)
    batches = [_rl_batch(rng, 4, 12, 64) for _ in range(2)]
    jst = jtrain.init_adamw(jp)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jhp))
    tp = tree_map(lambda t: t.clone(), tp)
    tst = init_adamw(tp)
    tstep = make_train_step(tcfg, thp)
    for batch in batches:
        jp, jst, jm = jstep(jp, jst, _jbatch(batch))
        tp, tst, tm = tstep(tp, tst, _tbatch(batch))
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6,
                                       rtol=1e-4, err_msg=k)
    _close_trees(tp, _np(jp), atol=2 * lr, rtol=0)


def test_engine_logprobs_match_recompute_without_drops():
    """The serve path (drop-free ``moe_decode_exact``, one token at a time
    over paged KV) and the recompute path (``moe_block``) compute the same
    logprobs in f32 when the capacity drops nothing."""
    # capacity factor E / k: C = T, so nothing can drop
    _, tcfg = _with_moe(_cfgs(GRANITE), capacity_factor=2.0)
    params = _model(GRANITE)[3]
    prompts = _prompts(4, 4, 9)
    eng = PagedEngine(tcfg, max_batch=4, page_size=4, max_new_tokens=6,
                      temperature=1.0, top_k=8, top_p=0.9, eos_token=-1,
                      prefill_chunk=8, device="cpu")
    res = eng.generate(params, prompts, seed=5)
    lp = make_prefill_step(tcfg)(params, {"tokens": res.tokens.long()})
    np.testing.assert_allclose(lp[:, 9:].numpy(), res.logprobs[:, 9:].numpy(),
                               atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's PagedEngine against JAX's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _serve_model(name):
    """Reduced MoE weights with every leaf nudged off its init constant,
    so norm scales are exercised."""
    jcfg, tcfg = _cfgs(name)
    jp = _jinit(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(
        lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(a.shape)), jp)
    return jcfg, tcfg, jp, _bridge(jp)


def _prompts(seed, n, length):
    return np.random.default_rng(seed).integers(3, 64, (n, length)).astype(
        np.int32)


def _assert_same(want, got):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=LP_ATOL)


@pytest.mark.parametrize("name,use_kernel", [(GRANITE, False),
                                             (GRANITE, True),
                                             (SCOUT, False), (SCOUT, True)])
def test_paged_engine_matches_jax_at_temp0(name, use_kernel):
    """Fewer slots than requests (queueing, backfill) and 8-token prefill
    chunks of 11-token prompts (chunked prefill through the MoE FFN)."""
    jcfg, tcfg, jp, tp = _serve_model(name)
    kw = dict(max_batch=3, page_size=4, max_new_tokens=6, temperature=0.0,
              prefill_chunk=8)
    prompts = _prompts(0, 5, 11)
    want = JaxPagedEngine(jcfg, use_kernel=use_kernel, **kw).generate(
        jp, prompts)
    eng = PagedEngine(tcfg, device="cpu", **kw)
    assert eng.layout.name == "paged-kv-moe"
    got = eng.generate(tp, prompts)
    _assert_same(want, got)
    assert eng.scheduler.stats.chunk_deferred_tokens > 0


def test_preemption_on_a_tight_pool_matches_jax():
    jcfg, tcfg, jp, tp = _serve_model(GRANITE)
    prompts = _prompts(1, 4, 6)
    kw = dict(max_batch=4, page_size=4, max_seq_len=32, max_new_tokens=20,
              temperature=0.0, num_pages=10, eos_token=-1)
    runs = []
    engines = (JaxPagedEngine(jcfg, **kw), PagedEngine(tcfg, device="cpu",
                                                       **kw))
    for eng, params in zip(engines, (jp, tp)):
        eng.set_params(params)
        reqs = [eng.submit(prompts[i], seed=i) for i in range(4)]
        eng.run()
        runs.append(reqs)
    assert engines[1].scheduler.stats.preempted == \
        engines[0].scheduler.stats.preempted > 0
    for a, b in zip(*runs):
        assert a.generated == b.generated, (a.rid, a.generated, b.generated)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LP_ATOL)


def test_request_tokens_equal_alone_and_in_a_batch():
    _, tcfg, _, tp = _serve_model(GRANITE)
    prompts = _prompts(2, 6, 9)
    kw = dict(page_size=4, max_new_tokens=8, temperature=0.0, eos_token=-1,
              device="cpu")
    batched = PagedEngine(tcfg, max_batch=6, **kw).generate(tp, prompts)
    for i in (0, 3):
        alone = PagedEngine(tcfg, max_batch=1, **kw).generate(
            tp, prompts[i:i + 1])
        np.testing.assert_array_equal(alone.tokens[0].numpy(),
                                      batched.tokens[i].numpy())
        np.testing.assert_allclose(alone.logprobs[0].numpy(),
                                   batched.logprobs[i].numpy(), atol=1e-5)
