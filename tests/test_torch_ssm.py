"""The SSM and hybrid slice on the CPU against the JAX package: the plain
versions of the SSD chunked scan (K6, forward and gradients) and the
one-token state update (K7) against the Pallas kernels (interpret) and
the JAX oracles; ``mamba2_block``, ``mamba2_decode``, ``forward``, the
batched ``decode_step``, ``policy_loss`` and train steps on reduced
mamba2-370m and zamba2-2.7b; and the port's ``PagedEngine`` over
``StateCacheLayout`` against JAX's, token for token, with the state
layout's lifecycle (preemption snapshots, exact-prompt reuse, the
``LayoutError`` guard).  Weights are bridged from JAX, inputs made with
numpy from a seed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import train as jtrain
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.kernels import ssm_update as jssu
from repro.models import model as jM
from repro.models import ssm as jssm
from repro.serve import PagedEngine as JaxPagedEngine
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import ssm_update as tssu
from repro_torch.models import forward, init_model
from repro_torch.models import model as tM
from repro_torch.models import ssm as tssm
from repro_torch.serve import (
    LayoutError,
    PagedEngine,
    PrefixCache,
    StateCacheLayout,
    covers,
    layout_class,
)
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

MAMBA, ZAMBA = "mamba2-370m", "zamba2-2.7b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# shrunk further than reduced(): the SSD shapes stay reduced()'s (state
# 16, head_dim 32, chunk 32); the hybrid gets two groups of two
SHRINK = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16)
LAYERS = {MAMBA: 2, ZAMBA: 4}
LP_ATOL = 1e-4

_jinit = jax.jit(jmodels.init_model, static_argnums=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(jparams):
    return params_from_numpy(_np(jparams), device="cpu")


def _cfgs(name, **kw):
    kw = {**SHRINK, "num_layers": LAYERS[name], **kw}
    return (jax_get_config(name).reduced().replace(**kw),
            tconfigs.get_config(name).reduced().replace(**kw))


def _both(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel):
    """Within ``rel`` of the largest |want|."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# K7: the one-token state update
# ---------------------------------------------------------------------------
# f32 arithmetic from the same inputs on every side (a bf16 input is cast
# to f32 first): they differ by the order of the readout's sum
SSU_REL = 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,P,N", [(1, 2, 16, 8), (3, 4, 32, 16),
                                     (2, 24, 64, 128)])
def test_ssm_state_update_plain_matches_pallas_and_oracle(B, H, P, N, dtype):
    rng = np.random.default_rng(B * H + N)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (0.5 * rng.standard_normal((2, B, N))).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    jx, tx = _both(x, dtype)
    jb, tb = _both(Bm, dtype)
    jc, tc = _both(Cm, dtype)
    ts, tdt, tA, tD = map(torch.from_numpy, (state, dt, A, D))
    got_y, got_s = tssu.ssm_state_update_plain(
        ts, tx, tdt, tA.expand(B, H), tb, tc, tD.expand(B, H))
    assert got_y.dtype == got_s.dtype == torch.float32
    want = jax.jit(lambda *a: jssu.ssm_state_update_bh(
        *a, interpret=True))(jnp.asarray(state), jx, jnp.asarray(dt),
                             jnp.broadcast_to(A, (B, H)), jb, jc,
                             jnp.broadcast_to(D, (B, H)))
    oracle = jref.ssm_state_update_ref(jnp.asarray(state), jx,
                                       jnp.asarray(dt), jnp.asarray(A), jb,
                                       jc, jnp.asarray(D))
    port_oracle = tref.ssm_state_update_ref(ts, tx, tdt, tA, tb, tc, tD)
    for (wy, ws) in (want, oracle, port_oracle):
        _close(got_y, wy, SSU_REL)
        _close(got_s, ws, SSU_REL)
    # ops routes a CPU tensor to the plain version
    y, s = ops.ssm_state_update(ts, tx, tdt, tA, tb, tc, tD)
    assert torch.equal(y, got_y) and torch.equal(s, got_s)


# ---------------------------------------------------------------------------
# K6: the SSD chunked scan
# ---------------------------------------------------------------------------
# relative to the largest |y|.  f32: every side sums the same terms in
# another order (the prefix sums of dt * A too); bf16: y rounded once
SSD_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def _ssd_np(seed, B, L, H, P, N, model_decay=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, H) if model_decay
         else -np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, L, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, L, N))).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _to_kernel_layout(x, dt, A, Bm, Cm, D, chunk, xp=np):
    """Model layout -> the TPU kernel's (B, H, nc, s, P) layout."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    return (xp.transpose(x.reshape(B, nc, chunk, H, P), (0, 3, 1, 2, 4)),
            xp.transpose(dt.reshape(B, nc, chunk, H), (0, 3, 1, 2)),
            xp.broadcast_to(A[None], (B, H)), Bm.reshape(B, nc, chunk, N),
            Cm.reshape(B, nc, chunk, N), xp.broadcast_to(D[None], (B, H)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,P,N,L,chunk", [
    (1, 2, 16, 8, 64, 16),
    (2, 4, 32, 16, 128, 32),
    (1, 1, 64, 64, 256, 64),
])
def test_ssd_scan_plain_matches_pallas_and_oracle(B, H, P, N, L, chunk,
                                                  dtype):
    x, dt, A, Bm, Cm, D = _ssd_np(L + N, B, L, H, P, N)
    k = [np.array(a) for a in
         _to_kernel_layout(x, dt, A, Bm, Cm, D, chunk)]
    jin = [jnp.asarray(a, JDT[dtype]) if i in (0, 3, 4) else jnp.asarray(a)
           for i, a in enumerate(k)]
    tin = [torch.from_numpy(a).to(TDT[dtype]) if i in (0, 3, 4)
           else torch.from_numpy(a) for i, a in enumerate(k)]
    got = tssd.ssd_scan_plain(*tin)
    assert got.dtype == TDT[dtype] and got.shape == tin[0].shape
    pallas = jax.jit(lambda *a: jssd.ssd_scan_bhcsp(*a, interpret=True))(
        *jin)
    for want in (pallas, jref.ssd_scan_ref(*jin), tref.ssd_scan_ref(*tin)):
        _close(got, want, SSD_REL[dtype] if want is pallas
               else max(SSD_REL[dtype], 1e-3))
    # ops.ssd_scan in the model layout routes a CPU tensor to it
    tx, tdt, tA, tB, tC, tD = (torch.from_numpy(a) for a in
                               (x, dt, A, Bm, Cm, D))
    y = ops.ssd_scan(tx.to(TDT[dtype]), tdt, tA, tB.to(TDT[dtype]),
                     tC.to(TDT[dtype]), tD, chunk)
    _close(y, got.permute(0, 2, 3, 1, 4).reshape(B, L, H, P), 1e-6)


def _hi_lo(a: torch.Tensor):
    """f32 -> (hi, lo) bf16 values as f32: hi the rounding of a, lo the
    rounding of what hi leaves (the kernel's split_bf16)."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a fed as a bf16 hi/lo pair, b as given: two products
    summed in f32, as the bf16 kernel's mma.sync pairs do."""
    hi, lo = _hi_lo(a)
    return hi @ b + lo @ b


def _ssd_kernel_order(x, dt, A, Bm, Cm, D, *, split: bool,
                      cluster: int = 8):
    """K6's forward in the card kernel's order of work, TPU layout in and
    out (csrc/ssd_scan.cu): every chunk's in-chunk term W x (W = C B^T (.)
    L (.) dt) and local state (w (.) x)^T B at once, then the carried state
    by the chain carried <- carried * exp(a_sum) + local over windows of
    ``cluster`` chunks in chunk order (each step rounded twice, the running
    state carried from one window to the next), then exp(a_cum) (.) C
    carried^T, y = W x + that + D x.  With ``split`` (the bf16 kernel),
    the operand computed in f32 of each product (W, w (.) x, the carried
    state) goes in as a bf16 hi/lo pair."""
    B, H, nc, s, P = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    a_cum = torch.cumsum((dtf * A.float()[..., None, None]).double(),
                         dim=-1).float()
    tri = torch.ones((s, s), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri, a_cum[..., :, None] - a_cum[..., None, :],
                              -1e30))
    W = (Cf @ Bf.transpose(-1, -2))[:, None] * L * dtf[..., None, :]
    xw = xf * (torch.exp(a_cum[..., -1:] - a_cum) * dtf)[..., None]
    if split:
        wx = _split_product(W, xf)
        local = _split_product(xw.transpose(-1, -2), Bf[:, None])
    else:
        wx = W @ xf
        local = xw.transpose(-1, -2) @ Bf[:, None]
    decay = torch.exp(a_cum[..., -1])
    carried = torch.empty_like(local)
    run = torch.zeros_like(local[:, :, 0])
    for w0 in range(0, nc, cluster):  # the windows, one cluster each
        for c in range(w0, min(nc, w0 + cluster)):
            carried[:, :, c] = run
            run = run * decay[:, :, c, None, None] + local[:, :, c]
    cT = carried.transpose(-1, -2)  # (P, N) -> (N, P)
    if split:
        hi, lo = _hi_lo(cT)
        off = Cf[:, None] @ hi + Cf[:, None] @ lo
    else:
        off = Cf[:, None] @ cT
    y = wx + torch.exp(a_cum)[..., None] * off + D.float()[..., None, None,
                                                           None] * xf
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,P,N", [(MAMBA, 64, 128), (ZAMBA, 64, 64)])
def test_ssd_kernel_order_matches_pallas(arch, P, N, dtype):
    """The card kernel's order of work (local states, the chain over two
    windows of the chunk cluster, the bf16 hi/lo operand split) at the
    models' head shapes, L cut to 10 chunks of 16, against the Pallas
    kernel in interpret mode."""
    B, H, chunk, L = 2, 2, 16, 160
    x, dt, A, Bm, Cm, D = _ssd_np(P + N, B, L, H, P, N, model_decay=True)
    k = [np.array(a) for a in _to_kernel_layout(x, dt, A, Bm, Cm, D, chunk)]
    jin = [jnp.asarray(a, JDT[dtype]) if i in (0, 3, 4) else jnp.asarray(a)
           for i, a in enumerate(k)]
    tin = [torch.from_numpy(a).to(TDT[dtype]) if i in (0, 3, 4)
           else torch.from_numpy(a) for i, a in enumerate(k)]
    got = _ssd_kernel_order(*tin, split=dtype == "bfloat16")
    assert got.dtype == TDT[dtype] and got.shape == tin[0].shape
    want = jax.jit(lambda *a: jssd.ssd_scan_bhcsp(*a, interpret=True))(*jin)
    _close(got, want, SSD_REL[dtype])
    # the chain's start states are the plain version's recurrence
    _close(_ssd_kernel_order(*(t.float() for t in tin), split=False),
           tssd.ssd_scan_plain(*(t.float() for t in tin)), SSD_REL["float32"])


def _ssd_bwd_kernel_order(x, dt, A, Bm, Cm, D, dy, *, cluster: int = 8):
    """K6's gradient in the card kernel's order of work, TPU layout in,
    plain f32 (csrc/ssd_scan_bwd.cu): the forward's chunk-start states S0;
    every chunk's local term sum_i e_i dy_i (x) C_i of dS0; the reverse
    chain dS1_{c-1} = exp(a_sum_c) dS1_c + local_c over windows of
    ``cluster`` chunks from the last window to the first, the running dS1
    carried from one window to the one before; then each chunk's
    gradients from S0 and dS1.  Returns (dx, ddt, dA, dBm, dCm, dD) with
    dBm and dCm summed over the heads and dA, dD over the chunks."""
    B, H, nc, s, P = x.shape
    a_cum = torch.cumsum((dt * A[..., None, None]).double(), dim=-1).float()
    e = torch.exp(a_cum)
    u = torch.exp(a_cum[..., -1:] - a_cum) * dt
    decay = torch.exp(a_cum[..., -1])  # (B, H, nc)
    Bh, Ch = Bm[:, None], Cm[:, None]  # shared by the heads
    contrib = (x * u[..., None]).transpose(-1, -2) @ Bh  # (B, H, nc, P, N)
    S0 = torch.empty_like(contrib)
    run = torch.zeros_like(contrib[:, :, 0])
    for c in range(nc):
        S0[:, :, c] = run
        run = run * decay[:, :, c, None, None] + contrib[:, :, c]
    local = (dy * e[..., None]).transpose(-1, -2) @ Ch
    dS1 = torch.empty_like(local)
    run = torch.zeros_like(local[:, :, 0])
    for w0 in reversed(range(0, nc, cluster)):  # the windows, one cluster each
        for c in reversed(range(w0, min(nc, w0 + cluster))):
            dS1[:, :, c] = run
            run = run * decay[:, :, c, None, None] + local[:, :, c]
    tri = torch.ones((s, s), dtype=torch.bool).tril()
    Lm = torch.exp(torch.where(tri, a_cum[..., :, None] - a_cum[..., None, :],
                               -1e30))
    CB = Ch @ Bh.transpose(-1, -2)  # (B, 1, nc, i, j)
    dM = dy @ x.transpose(-1, -2)   # (B, H, nc, i, j)
    M = CB * Lm * dt[..., None, :]
    Q = dM * Lm * dt[..., None, :]
    dx = (M.transpose(-1, -2) @ dy + u[..., None] * (Bh @ dS1.transpose(-1, -2))
          + D[..., None, None, None] * dy)
    dC_state = e[..., None] * (dy @ S0)
    dC = Q @ Bh + dC_state
    xd = x @ dS1
    dB = Q.transpose(-1, -2) @ Ch + u[..., None] * xd
    du = (xd * Bh).sum(-1)
    # dM M off the diagonal: on it the row and column terms cancel, and the
    # kernel leaves both out
    T = dM * M * torch.ones((s, s), dtype=torch.bool).tril(-1)
    da_cum = T.sum(-1) - T.sum(-2) + (dC_state * Ch).sum(-1) - du * u
    da_cum[..., -1] += (du * u).sum(-1) + decay * (dS1 * S0).sum((-1, -2))
    ddt = (dM * CB * Lm).sum(-2) + du * torch.exp(a_cum[..., -1:] - a_cum)
    tail = torch.flip(torch.cumsum(torch.flip(da_cum, [-1]), -1), [-1])
    return (dx, ddt + tail * A[..., None, None], (tail * dt).sum((-1, -2)),
            dB.sum(1), dC.sum(1), (dy * x).sum((-1, -2, -3)))


@functools.lru_cache(maxsize=None)
def _jax_ssd_grad(chunk: int):
    """``jax.grad`` of ``sum(ssd_chunked(...)[0] * dy)`` in all six inputs."""
    def loss(x, dt, A, Bm, Cm, D, dy):
        return jnp.sum(jssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)[0] * dy)
    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))


@pytest.mark.parametrize("L", [160, 144])
@pytest.mark.parametrize("arch,P,N", [(MAMBA, 64, 128), (ZAMBA, 64, 64)])
def test_ssd_bwd_kernel_order_matches_jax_grad(arch, P, N, L):
    """The card backward's order of work (local terms, the reverse chain
    over windows of the chunk cluster, each chunk's gradients from S0 and
    dS1) at the models' head shapes, in chunks of 16: L = 160 leaves a
    last window of two chunks, L = 144 one of a single chunk.  Every
    gradient in f32 within 1e-4 of the largest |grad| of ``jax.grad`` of
    ``ssd_chunked``.  The output gradient is y itself (that of |y|^2 / 2):
    with a random one, dA sums ~300 terms of both signs per head to a
    total that can be a tenth of them, where f32 (JAX's as well) leaves
    errors of ~1e-5 of the terms; with dy = y every gradient is a
    coherent sum and the two sides agree within a tenth of the bar."""
    B, H, chunk = 2, 2, 16
    x, dt, A, Bm, Cm, D = _ssd_np(P + N + L, B, L, H, P, N, model_decay=True)
    # dt scaled so that a chunk decays by exp(a_sum) of 0.02 .. 0.9: every
    # term of the chain between chunks weighs in the gradients
    ins = (x, (dt / 64).astype(np.float32), A, Bm, Cm, D)
    dy, _ = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    dy = np.asarray(dy)
    want = _jax_ssd_grad(chunk)(*map(jnp.asarray, ins), jnp.asarray(dy))
    nc = L // chunk
    k = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         _to_kernel_layout(*ins, chunk)]
    tdy = torch.from_numpy(dy.copy()).reshape(B, nc, chunk, H, P).permute(
        0, 3, 1, 2, 4)
    dx, ddt, dA, dBm, dCm, dD = _ssd_bwd_kernel_order(*k, tdy)
    got = (dx.permute(0, 2, 3, 1, 4).reshape(B, L, H, P),
           ddt.permute(0, 2, 3, 1).reshape(B, L, H), dA.sum(0),
           dBm.reshape(B, L, N), dCm.reshape(B, L, N), dD.sum(0))
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-4)


@pytest.mark.parametrize("L,chunk,model_decay", [(64, 16, False),
                                                 (96, 32, True)])
def test_ssd_scan_grads_match_jax_ssd_chunked(L, chunk, model_decay):
    """Every gradient of ops.ssd_scan on the CPU (x, dt, A, Bm, Cm, D)
    against ``jax.grad`` of JAX's ``ssd_chunked`` (what JAX trains
    through), for a random output gradient; f32, within 1e-4 of the
    largest |grad|."""
    B, H, P, N = 2, 4, 16, 8
    ins = _ssd_np(L * 7, B, L, H, P, N, model_decay)
    dy = np.random.default_rng(L).standard_normal((B, L, H, P)).astype(
        np.float32)

    def jloss(*a):
        y, _ = jssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y = ops.ssd_scan(*leaves, chunk)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        _close(g, w, 1e-4)
        assert g.shape == w.shape, name
    # the port's own ssd_chunked, and the sequential oracle, forward
    yc, final = tssm.ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk)
    jy, jfinal = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    _close(yc, jy, 1e-4)
    _close(final, jfinal, 1e-4)
    _close(y, tssm.ssd_sequential_ref(*(torch.from_numpy(a) for a in ins)),
           1e-3)


def test_ssd_scan_pads_a_ragged_length():
    """L = 80 with chunk 32: ops.ssd_scan pads to 96 and cuts back, giving
    the JAX mamba2 path's padded ssd_chunked result."""
    B, L, H, P, N = 2, 80, 4, 16, 8
    ins = _ssd_np(3, B, L, H, P, N, model_decay=True)
    y = ops.ssd_scan(*(torch.from_numpy(a) for a in ins), 32)
    pad = [np.pad(a, [(0, 0), (0, 16)] + [(0, 0)] * (a.ndim - 2))
           if a.ndim > 1 else a for a in ins]
    want, _ = jssm.ssd_chunked(*map(jnp.asarray, pad), 32)
    assert y.shape == (B, L, H, P)
    _close(y, np.asarray(want)[:, :L], 1e-4)


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model(name, seed=0):
    """(jax cfg, port cfg, jax params, port params), every weight nudged
    off its init constant so norm scales, conv biases, dt_bias and D are
    exercised."""
    jcfg, tcfg = _cfgs(name)
    jp = _jinit(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(
        lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(a.shape)), jp)
    return jcfg, tcfg, jp, _bridge(jp)


def _mixer(name):
    jcfg, tcfg, jp, tp = _model(name)
    lead = (0, 0) if name == ZAMBA else (0,)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[lead], jp["layers"]["mixer"]),
            tree_map(lambda t: t[lead], tp["layers"]["mixer"]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("L", [40, 64])  # 40: padded to a chunk multiple
def test_mamba2_block_matches_jax(L, use_kernel):
    jcfg, tcfg, jp, tp = _mixer(MAMBA)
    x = np.random.default_rng(L).standard_normal(
        (2, L, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.mamba2_block(
        p, jcfg, x, use_kernel=use_kernel))(jp, jnp.asarray(x))
    got = tssm.mamba2_block(tp, tcfg, torch.from_numpy(x))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_decode_matches_jax(use_kernel):
    """Six steps from a zero state: outputs, SSD state and conv window."""
    jcfg, tcfg, jp, tp = _mixer(MAMBA)
    B = 3
    xs = np.random.default_rng(1).standard_normal(
        (6, B, 1, jcfg.d_model)).astype(np.float32)
    jst = jssm.init_ssm_state(jcfg, B, jnp.float32)
    tst = tssm.init_ssm_state(tcfg, B, torch.float32, "cpu")
    step = jax.jit(lambda p, x, s: jssm.mamba2_decode(
        p, jcfg, x, s, use_kernel=use_kernel))
    for x in xs:
        want, jst = step(jp, jnp.asarray(x), jst)
        got, tst = tssm.mamba2_decode(tp, tcfg, torch.from_numpy(x), tst)
        _close(got, want, 1e-4)
        _close(tst.ssm, jst.ssm, 1e-4)
        _close(tst.conv, jst.conv, 1e-6)


def test_init_mamba2_keeps_decay_and_skip_f32():
    tcfg = _cfgs(MAMBA)[1]
    p = init_model(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                   "cpu")["layers"]["mixer"]
    for name in ("dt_bias", "A_log", "D"):
        assert p[name].dtype == torch.float32, name
    assert p["in_proj"].dtype == torch.bfloat16
    np.testing.assert_allclose(p["A_log"][1].numpy(),
                               np.log(np.linspace(1.0, 16.0, 4)), rtol=1e-6)
    jp = _model(MAMBA)[2]
    bf = params_from_numpy(_np(jp), device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["mixer"]["A_log"].dtype == torch.float32
    assert bf["layers"]["mixer"]["conv_w"].dtype == torch.bfloat16
    # the hybrid's stacked layout: (groups, per group, ...) and one shared
    # attention layer without a leading axis
    _, tz, _, tzp = _model(ZAMBA)
    assert tuple(tzp["layers"]["mixer"]["D"].shape) == (2, 2, 4)
    assert tuple(tzp["shared_attn"]["attn"]["wq"].shape) == (64, 4, 16)


# ---------------------------------------------------------------------------
# forward, decode_step, policy loss, train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,use_kernel", [(MAMBA, False), (MAMBA, True),
                                             (ZAMBA, False), (ZAMBA, True)])
def test_forward_logits_match_jax(name, use_kernel):
    jcfg, tcfg, jp, tp = _model(name)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 45)).astype(
        np.int32)
    want, _ = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, use_kernel=use_kernel))(jp, jnp.asarray(tokens))
    for remat in (False, True):
        got, aux = forward(tp, tcfg, torch.from_numpy(tokens).long(),
                           remat=remat)
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        assert float(aux) == 0.0


@pytest.mark.parametrize("name", [MAMBA, ZAMBA])
def test_prefill_step_matches_jax(name):
    """The recompute's logprobs (41 tokens: a chunk of 32 and a padded
    tail) against JAX's ``make_prefill_step``."""
    jcfg, tcfg, jp, tp = _model(name)
    tokens = np.random.default_rng(6).integers(0, 64, (3, 41)).astype(
        np.int32)
    want = jax.jit(jtrain.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    got = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == tokens.shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name,window", [(MAMBA, 0), (ZAMBA, 0), (ZAMBA, 5)])
def test_batched_decode_step_matches_jax_row_by_row(name, window):
    """The port's decode_step over three rows at positions offset by 0, 3
    and 7 against JAX's decode_step of each row alone with its scalar
    position (as JAX's state layout vmaps it): logits every step and the
    final state, the hybrid's KV ring wrapping when windowed."""
    jcfg, tcfg, jp, tp = _model(name)
    jcfg, tcfg = (c.replace(sliding_window=window) for c in (jcfg, tcfg))
    B, T, cache_len = 3, 12, 16
    offsets = np.array([0, 3, 7])
    tokens = np.random.default_rng(5).integers(0, 64, (T, B)).astype(np.int32)
    tst = tM.init_decode_state(tcfg, B, cache_len, torch.float32, "cpu")
    jsts = [jM.init_decode_state(jcfg, 1, cache_len) for _ in range(B)]
    jstep = jax.jit(lambda p, t, s, pos: jM.decode_step(p, jcfg, t, s, pos))
    for t in range(T):
        pos = offsets + t
        got, tst = tM.decode_step(tp, tcfg, torch.from_numpy(tokens[t, :, None]),
                                  tst, torch.from_numpy(pos))
        for b in range(B):
            want, jsts[b] = jstep(jp, jnp.asarray(tokens[t, b:b + 1, None]),
                                  jsts[b], jnp.int32(pos[b]))
            np.testing.assert_allclose(_f32(got[b]), np.asarray(want[0]),
                                       atol=1e-4, rtol=1e-4)
    for b in range(B):
        _close(tst.ssm.ssm.select(-4, b), jsts[b].ssm.ssm[..., 0, :, :, :],
               1e-4)
        if name == ZAMBA:
            np.testing.assert_array_equal(
                tst.shared_kv.positions[:, b].numpy(),
                np.asarray(jsts[b].shared_kv.positions[:, 0]))
            _close(tst.shared_kv.k[:, b], jsts[b].shared_kv.k[:, 0], 1e-5)


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


@pytest.mark.parametrize("name", [MAMBA, ZAMBA])
def test_policy_loss_value_and_grads_match_jax(name):
    """Loss, every metric and every param gradient (A_log, dt_bias, D,
    the conv and the hybrid's shared attention among them), with entropy
    and KL terms; each gradient within 1e-4 of its largest entry."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _rl_batch(np.random.default_rng(5), 3, 20, 64)
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
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    it = iter(grads)
    g, w = _flat(tree_map(lambda _: next(it), params)), _flat(_np(want_g))
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, err_msg=k,
                                   atol=1e-4 * float(np.abs(w[k]).max())
                                   + 1e-7)


@pytest.mark.parametrize("name", [MAMBA, ZAMBA])
def test_train_step_matches_jax_two_steps(name):
    """Two AdamW steps in two microbatches from the same params: metrics
    tightly, params within 2 * lr (where g ~ 0 the first Adam steps are
    close to lr * sign(g))."""
    jcfg, tcfg, jp, tp = _model(name)
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
    g, w = _flat(tp), _flat(_np(jp))
    for k in g:
        np.testing.assert_allclose(g[k], w[k], atol=2 * lr, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the port's PagedEngine (StateCacheLayout) against JAX's
# ---------------------------------------------------------------------------
def _jax_noise(seeds, positions, V):
    """The JAX engine's own per-request Gumbel draws, as numpy."""
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p))(
        jnp.asarray(seeds.cpu().numpy(), jnp.int32),
        jnp.asarray(positions.cpu().numpy(), jnp.int32))
    return np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))


def _prompts(seed, n, length):
    return np.random.default_rng(seed).integers(3, 64, (n, length)).astype(
        np.int32)


def _run_both(jcfg, tcfg, jp, tp, prompts, *, noise=False, use_kernel=False,
              **kw):
    """The same requests (seeds 100 + i) through JAX's engine and the
    port's; returns both request lists and the port's engine."""
    engines = (JaxPagedEngine(jcfg, use_kernel=use_kernel, **kw),
               PagedEngine(tcfg, device="cpu", **kw))
    if noise:
        engines[1].layout.noise_fn = _jax_noise
    runs = []
    for eng, params in zip(engines, (jp, tp)):
        eng.set_params(params)
        runs.append([eng.submit(p, seed=100 + i)
                     for i, p in enumerate(prompts)])
        eng.run()
    return runs[0], runs[1], engines[1]


def _assert_same(jreqs, treqs):
    for a, b in zip(jreqs, treqs):
        assert a.generated == b.generated, (a.rid, a.generated, b.generated)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LP_ATOL)


@pytest.mark.parametrize("name,use_kernel", [(MAMBA, False), (MAMBA, True),
                                             (ZAMBA, False), (ZAMBA, True)])
def test_paged_engine_matches_jax_at_temp0(name, use_kernel):
    """Fewer slots than requests (queueing, backfill): tokens and
    logprobs of every request."""
    jcfg, tcfg, jp, tp = _model(name)
    jreqs, treqs, eng = _run_both(
        jcfg, tcfg, jp, tp, _prompts(0, 5, 11), use_kernel=use_kernel,
        max_batch=3, max_new_tokens=6, temperature=0.0, max_seq_len=64,
        eos_token=-1)
    assert eng.layout.name == "state" and eng.prefix_cache is None
    _assert_same(jreqs, treqs)


@pytest.mark.parametrize("name", [MAMBA, ZAMBA])
def test_injected_jax_noise_gives_jax_tokens_above_temp0(name):
    jcfg, tcfg, jp, tp = _model(name)
    jreqs, treqs, _ = _run_both(
        jcfg, tcfg, jp, tp, _prompts(3, 5, 9), noise=True, max_batch=3,
        max_new_tokens=8, temperature=1.0, top_k=8, top_p=0.9,
        max_seq_len=64, eos_token=-1)
    _assert_same(jreqs, treqs)
    assert len({tuple(r.generated) for r in treqs}) > 1


def test_windowed_hybrid_ring_wraps_and_matches_jax():
    """Reduced zamba2 with a 6-token window on 13-token prompts: the
    shared block's KV ring (6 slots) wraps during the prompt and every
    decoded token; the JAX engine's tokens."""
    jcfg, tcfg, jp, tp = _model(ZAMBA)
    jcfg, tcfg = (c.replace(sliding_window=6) for c in (jcfg, tcfg))
    assert layout_class(tcfg) is StateCacheLayout and covers(tcfg)
    jreqs, treqs, eng = _run_both(
        jcfg, tcfg, jp, tp, _prompts(6, 4, 13), max_batch=2,
        max_new_tokens=7, temperature=0.0, max_seq_len=64, eos_token=-1)
    assert eng.layout.cache.shared_kv.k.shape[2] == 6
    _assert_same(jreqs, treqs)


# ---------------------------------------------------------------------------
# state-cache lifecycle (the JAX package's tests/test_arch_serve.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MAMBA, ZAMBA])
def test_state_cache_preempt_resume_parity(name):
    """Preemption snapshots slot state: the resumed request continues at
    its frontier (no prefill recompute) and its tokens are unchanged."""
    _, tcfg, _, tp = _model(name)
    prompts = _prompts(1, 2, 5)

    def fresh():
        eng = PagedEngine(tcfg, max_batch=2, max_new_tokens=10,
                          temperature=0.0, max_seq_len=64, eos_token=-1,
                          device="cpu")
        reqs = [eng.submit(prompts[i], max_new_tokens=10, seed=i)
                for i in range(2)]
        eng.set_params(tp)
        return eng, reqs

    ref_eng, ref_reqs = fresh()
    ref_eng.run()
    want = [list(r.generated) for r in ref_reqs]

    eng, reqs = fresh()
    victim = reqs[0]
    for _ in range(20):
        eng.step()
        if len(victim.generated) >= 2:
            break
    assert victim.state == "running" and victim.generated
    progress = victim.num_cached
    eng.preempt_request(victim)
    assert victim.num_cached == progress  # progress survives requeueing
    assert victim.rid in eng.layout._suspended
    assert eng.layout.snapshot_bytes() > 0
    eng.run()
    assert not eng.layout._suspended
    assert [list(r.generated) for r in reqs] == want


def test_state_cache_exact_prompt_reuse():
    _, tcfg, _, tp = _model(MAMBA)
    p = _prompts(2, 1, 6)[0]
    eng = PagedEngine(tcfg, max_batch=1, max_new_tokens=4, temperature=0.0,
                      max_seq_len=64, eos_token=-1, device="cpu")
    eng.set_params(tp)
    r1 = eng.submit(p, max_new_tokens=4, seed=0)
    eng.run()
    # identical prompt: admitted with prompt_len - 1 positions served
    # from the snapshot stored when r1 finished its prefill
    r2 = eng.submit(p, max_new_tokens=4, seed=0)
    eng.run()
    assert eng.layout.exact_prefix_hits == 1
    assert eng.scheduler.stats.prefix_hit_tokens == len(p) - 1
    assert list(r2.generated) == list(r1.generated)
    # continuation (prompt + generated): resumes from the finish-time
    # snapshot and matches a cold engine
    cont = np.concatenate([p, np.asarray(r1.generated, np.int32)])
    r3 = eng.submit(cont, max_new_tokens=3, seed=0)
    eng.run()
    assert eng.layout.exact_prefix_hits == 2
    cold = PagedEngine(tcfg, max_batch=1, max_new_tokens=3, temperature=0.0,
                       max_seq_len=64, eos_token=-1, prefix_sharing=False,
                       device="cpu")
    cold.set_params(tp)
    r4 = cold.submit(cont, max_new_tokens=3, seed=0)
    cold.run()
    assert cold.layout.exact_prefix_capacity == 0  # sharing disabled
    assert list(r3.generated) == list(r4.generated)
    # a weight swap flushes the snapshots held for future requests
    eng.update_weights(tp)
    eng.submit(p, max_new_tokens=1, seed=0)
    eng.run()
    assert eng.layout.exact_prefix_hits == 2


def test_state_layout_refuses_partial_cow_prefix_cache():
    """Partial-page COW on a recurrent-state cache is structurally
    impossible: constructing the combination raises, and so does a state
    layout for an attention-only stack; the engine never attaches a radix
    trie to a state layout."""
    _, tcfg, _, _ = _model(MAMBA)
    kw = dict(max_batch=2, page_size=4, num_pages=2, max_blocks=1,
              max_seq_len=32, temperature=0.0, top_k=0, top_p=1.0,
              dtype=torch.float32, device="cpu")
    with pytest.raises(LayoutError):
        StateCacheLayout(tcfg, prefix_cache=PrefixCache(4), **kw)
    with pytest.raises(LayoutError):
        StateCacheLayout(tconfigs.get_config("yi-9b").reduced(), **kw)
    eng = PagedEngine(tcfg, max_batch=1, max_new_tokens=2, temperature=0.0,
                      max_seq_len=32, prefix_sharing=True, device="cpu")
    assert eng.prefix_cache is None


def test_snapshot_is_a_copy_not_a_view():
    """A snapshot taken at preemption stays as it was while the engine
    restores it and keeps stepping the slot's row in place."""
    _, tcfg, _, tp = _model(ZAMBA)
    eng = PagedEngine(tcfg, max_batch=1, max_new_tokens=12, temperature=0.0,
                      max_seq_len=64, eos_token=-1, device="cpu")
    eng.set_params(tp)
    a = eng.submit(_prompts(7, 1, 6)[0], seed=0)
    for _ in range(8):
        eng.step()
    eng.preempt_request(a)
    snap = eng.layout._suspended[a.rid]
    frozen = tree_map(lambda t: t.clone(),
                      {"ssm": snap.ssm.ssm, "conv": snap.ssm.conv,
                       "k": snap.shared_kv.k, "pos": snap.shared_kv.positions})
    n = len(a.generated)
    for _ in range(6):  # a resumes in the slot, whose row moves on
        eng.step()
    assert len(a.generated) > n and not eng.layout._suspended
    assert torch.equal(frozen["ssm"], snap.ssm.ssm)
    assert torch.equal(frozen["conv"], snap.ssm.conv)
    assert torch.equal(frozen["k"], snap.shared_kv.k)
    assert torch.equal(frozen["pos"], snap.shared_kv.positions)
    assert not torch.equal(eng.layout.cache.ssm.ssm.select(2, 0),
                           snap.ssm.ssm)
