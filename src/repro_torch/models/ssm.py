"""Mamba2 (SSD, state-space duality) block: chunked train/prefill and
decode.

Counterpart of the JAX package's ``models/ssm.py``, the minimal SSD
formulation of arXiv:2405.21060 (single B/C group):

    h_i = exp(dt_i * A) h_{i-1} + dt_i * (B_i ⊗ x_i)
    y_i = C_i · h_i + D * x_i

``mamba2_block`` (recompute and training) always goes through
``kernels.ops.ssd_scan`` and ``mamba2_decode`` (serving) through
``kernels.ops.ssm_state_update``: the Hopper kernels on the card, their
plain versions on the CPU.  ``ssd_chunked`` is the JAX package's plain
chunked algorithm (what JAX trains through), kept as a reference beside
``ssd_sequential_ref``.  The depthwise causal conv of width 4 is plain
torch, as JAX leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Params,
    dense_init,
    init_rmsnorm,
    rmsnorm,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_mamba2(gen, cfg: ModelConfig, dtype, device, *,
                lead: Sequence[int] = ()) -> Params:
    """``dt_bias``, ``A_log`` and ``D`` are f32 whatever ``dtype`` is, as
    JAX initializes them."""
    s = cfg.ssm
    assert s is not None
    d, di, n = cfg.d_model, cfg.d_inner, s.state_size
    nh = cfg.num_ssm_heads
    conv_ch = di + 2 * n
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    return {
        # in_proj -> [z(di), x(di), B(n), C(n), dt(nh)]
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + nh), dtype, device,
                              lead=lead),
        "conv_w": dense_init(gen, (s.conv_width, conv_ch), dtype, device,
                             scale=0.5, lead=lead),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "A_log": a_log.expand(lead + (nh,)).clone(),  # A = -exp(A_log)
        "D": torch.ones(lead + (nh,), **f32),
        "norm": init_rmsnorm(di, dtype, device, lead=lead),
        "out_proj": dense_init(gen, (di, d), dtype, device, lead=lead),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, di: int = 0):
    """[z, x, B, C, dt] of ``proj``; ``di`` is x's and z's width (the
    heads' share of ``d_inner`` on a model rank)."""
    di, n = di or cfg.d_inner, cfg.ssm.state_size
    z = proj[..., :di]
    xs = proj[..., di:2 * di]
    B = proj[..., 2 * di:2 * di + n]
    C = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, xs, B, C, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, L, ch), w (width, ch): summed in f32,
    rounded once to x's type, then the bias added in that type."""
    width, L = w.shape[0], x.shape[1]
    xpad = F.pad(x, (0, 0, width - 1, 0)).float()
    wf = w.float()
    out = sum(xpad[:, k:k + L] * wf[k] for k in range(width))
    return out.to(x.dtype) + b


# ---------------------------------------------------------------------------
# Chunked SSD (the JAX package's plain algorithm)
# ---------------------------------------------------------------------------
def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H), post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (H,)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) f32, final_state (B, H, P, N) f32)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = Bm.reshape(b, nc, chunk, n).float()
    Cc = Cm.reshape(b, nc, chunk, n).float()

    a_cum = torch.cumsum(dtc * A, dim=2)  # (b, nc, s, h)
    # intra-chunk term; the mask goes before the exp
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(tri, diff, -1e30))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", CB, L, dtc, xc)

    # end-of-chunk states from within-chunk inputs
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b,nc,s,h)
    states = torch.einsum("bcsh,bcsh,bcsn,bcshp->bchpn", decay_to_end, dtc,
                          Bc, xc)

    # inter-chunk recurrence, emitting the state at each chunk's start
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, nc, h)
    s_prev = (x.new_zeros((b, h, p, n), dtype=torch.float32)
              if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    state_decay = torch.exp(a_cum)  # (b, nc, s, h)
    y_off = torch.einsum("bcsn,bchpn,bcsh->bcshp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, l, h, p)
    y = y + x.float() * D[None, None, :, None]
    return y, s_prev


# ---------------------------------------------------------------------------
# Block state for decode
# ---------------------------------------------------------------------------
class SSMState(NamedTuple):
    ssm: torch.Tensor  # (B, H, P, N) f32
    conv: torch.Tensor  # (B, width-1, conv_ch)


def init_ssm_state(cfg: ModelConfig, B: int, dtype, device) -> SSMState:
    s = cfg.ssm
    nh, p, n = cfg.num_ssm_heads, s.head_dim, s.state_size
    conv_ch = cfg.d_inner + 2 * n
    return SSMState(
        ssm=torch.zeros((B, nh, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros((B, s.conv_width - 1, conv_ch), dtype=dtype,
                         device=device),
    )


# ---------------------------------------------------------------------------
# Full block: train/prefill forward
# ---------------------------------------------------------------------------
def _local_heads(p: Params, cfg: ModelConfig, tp) -> Params:
    """The mixer's params for model rank ``tp.rank``'s nh / m heads:
    its heads' z, x and dt columns of ``in_proj`` with B and C whole, its
    x columns of ``conv_w`` and ``conv_b`` with B and C whole (those
    three come whole from the layout, which sums their gradient over the
    ranks), ``dt_bias``, ``A_log``, ``D`` and the norm's scale sliced
    through "f", ``out_proj``'s rows as stored.  The gated norm stays
    one norm over the whole ``d_inner`` (its marker totals the sum of
    squares)."""
    s = cfg.ssm
    di, n, nh = cfg.d_inner, s.state_size, cfg.num_ssm_heads
    if nh % tp.size:
        raise ValueError(f"{nh} SSM heads over {tp.size} model ranks")
    h = nh // tp.size
    h0 = tp.rank * h
    c0, c = h0 * s.head_dim, h * s.head_dim

    def cols(w, *spans):
        return torch.cat([w[..., a:a + k] for a, k in spans], dim=-1)

    def heads(w):
        return tp.enter(w)[..., h0:h0 + h]

    return {
        "in_proj": cols(p["in_proj"], (c0, c), (di + c0, c),
                        (2 * di, 2 * n), (2 * di + 2 * n + h0, h)),
        "conv_w": cols(p["conv_w"], (c0, c), (di, 2 * n)),
        "conv_b": cols(p["conv_b"], (c0, c), (di, 2 * n)),
        "dt_bias": heads(p["dt_bias"]), "A_log": heads(p["A_log"]),
        "D": heads(p["D"]),
        "norm": {"scale": tp.enter(p["norm"]["scale"])[..., c0:c0 + c],
                 "tp": tp},
        "out_proj": p["out_proj"],
    }


def mamba2_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, d_model) -> (B, L, d_model).  Split over a layout's model
    axis (a ``"tp"`` marker, ``train.parallel``), K6 runs on this rank's
    heads (:func:`_local_heads`): ``x`` enters through "f" and the
    row-parallel ``out_proj``'s partial sums leave through "g"."""
    tp = p.get("tp")
    if tp is not None:
        p, x = _local_heads(p, cfg, tp), tp.enter(x)
    s = cfg.ssm
    B_, L, _ = x.shape
    n, nh = s.state_size, p["A_log"].shape[-1]
    di = nh * s.head_dim
    proj = x @ p["in_proj"]
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj, di)
    xBC = torch.cat([xs, Bm, Cm], dim=-1)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = xBC[..., :di], xBC[..., di:di + n], xBC[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, L, nh, s.head_dim)
    # the JAX package's chunk choice; ops.ssd_scan pads L to a multiple
    chunk = min(s.chunk_size, L) if L % s.chunk_size else s.chunk_size
    y = kops.ssd_scan(xh, dt, A, Bm, Cm, p["D"], chunk)
    y = y.reshape(B_, L, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) @ p["out_proj"]
    return y if tp is None else tp.exit(y)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def mamba2_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d_model); O(1) state update through
    ``kernels.ops.ssm_state_update`` (decay, rank-1 bump, readout); the
    conv window and the projections stay plain.  Returns new tensors; the
    input state is not written."""
    s = cfg.ssm
    B_ = x.shape[0]
    di, n, nh = cfg.d_inner, s.state_size, cfg.num_ssm_heads
    proj = x[:, 0] @ p["in_proj"]  # (B, ...)
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)
    xBC = torch.cat([xs, Bm, Cm], dim=-1)  # (B, conv_ch)
    # conv over [conv_state, xBC], in f32
    window = torch.cat([state.conv, xBC[:, None, :]], dim=1)  # (B, w, ch)
    conv_out = ((window.float() * p["conv_w"].float()).sum(dim=1)
                + p["conv_b"].float())
    conv_out = F.silu(conv_out).to(x.dtype)
    xs, Bm, Cm = conv_out[:, :di], conv_out[:, di:di + n], conv_out[:, di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, nh, s.head_dim).float()
    y, new_ssm = kops.ssm_state_update(state.ssm, xh, dt, A, Bm.float(),
                                       Cm.float(), p["D"])
    y = y.reshape(B_, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, SSMState(ssm=new_ssm, conv=window[:, 1:])


# ---------------------------------------------------------------------------
# Sequential oracle (for tests)
# ---------------------------------------------------------------------------
def ssd_sequential_ref(x, dt, A, Bm, Cm, D):
    """Step-by-step recurrence; slow but obviously correct."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    hstate = x.new_zeros((b, h, p, n))
    ys = []
    for i in range(l):
        decay = torch.exp(dt[:, i] * A)  # (b, h)
        upd = (dt[:, i, :, None, None] * x[:, i, :, :, None]
               * Bm[:, i, None, None, :])
        hstate = hstate * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, Cm[:, i]))
    y = torch.stack(ys, dim=1)
    return y + x * D[None, None, :, None]
