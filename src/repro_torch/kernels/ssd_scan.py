"""Mamba2 SSD chunked scan: the Hopper kernels' wrappers and their plain
version.

Per (batch row, head), chunk by chunk, with a = dt * A and a_cum its
in-chunk prefix sum, the running (P, N) state carried across chunks:

  y[c]  = (L ⊙ C Bᵀ) diag(dt) x  +  (exp(a_cum) C) · stateᵀ  +  D x
  state = exp(a_sum) · state + Σ_s exp(a_sum - a_cum_s) dt_s x_s ⊗ B_s

The forward kernel is ``csrc/ssd_scan.cu`` and replaces ``ssd_scan_bhcsp``
of the JAX package's ``kernels/ssd_scan.py``: one block per (batch row,
head, chunk), the chunks of a row in thread-block clusters that pass the
carried state on in distributed shared memory, the products on the
tensor cores (bf16 with f32 operands as bf16 hi/lo pairs; f32 in
3xTF32).  The backward kernel is ``csrc/ssd_scan_bwd.cu`` (the JAX
package has none: it trains through ``ssd_chunked``, which XLA
differentiates): the same grid and clusters, the gradient of the carried
state passed back through the chunks in distributed shared memory from
the forward's saved chunk-start states, the products in 3xTF32.
:class:`SSDScan` ties the two into autograd.

Layouts (the TPU kernel's):
  x, y   (B, H, nc, s, P)  bf16 or f32, y in x's type
  dt     (B, H, nc, s)     post-softplus step sizes
  A, D   (B, H)            negative decay rate, skip gain
  Bm, Cm (B, nc, s, N)     shared across heads
The kernels read and write through strides: any view whose (nc, s) axes
merge into one sequence axis, with a unit last stride (the model's
(B, L, H, P) layout, transposed, is one).  They take s <= 128, P <= 64
and N <= 128.

Launch counters: ``ssd_scan_bhcsp.launches`` and ``ssd_scan_bwd.launches``
(one each per call, each call one cluster launch).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


def ssd_scan_plain(x, dt, A, Bm, Cm, D):
    """What the kernel computes, in plain torch: every input cast to f32,
    the in-chunk prefix sum of dt * A kept in f64 and rounded to f32 at
    each position (the kernel's, and torch's f32 cumsum on the CPU), the
    (s, s) mask applied before the exp with -1e30, the state carried chunk
    by chunk from zeros, y in x's type.  Autograd through it is the plain
    backward."""
    B, H, nc, s, P = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    a = dtf * A.float()[..., None, None]
    a_cum = torch.cumsum(a.double(), dim=-1).float()
    diff = a_cum[..., :, None] - a_cum[..., None, :]  # (B, H, nc, i, j)
    tri = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, diff, NEG_INF))
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[:, None]
    W = CB * L * dtf[..., None, :]
    y = W @ xf  # (B, H, nc, s, P)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    xb = xf * (decay_to_end * dtf)[..., None]
    contrib = xb.transpose(-1, -2) @ Bf[:, None]  # (B, H, nc, P, N)
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, H, nc)
    state = xf.new_zeros((B, H, P, Bm.shape[-1]))
    y_off = []
    for c in range(nc):
        Cdec = Cf[:, None, c] * torch.exp(a_cum[:, :, c])[..., None]
        y_off.append(Cdec @ state.transpose(-1, -2))
        state = state * chunk_decay[:, :, c, None, None] + contrib[:, :, c]
    y = y + torch.stack(y_off, dim=2)
    return (y + D.float()[..., None, None, None] * xf).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _seq(t: torch.Tensor, seq_axis: int, unit_last: bool = True
         ) -> torch.Tensor:
    """``t`` if its (nc, s) axes at ``seq_axis`` merge into one sequence
    axis (and, with ``unit_last``, its last stride is 1); else a
    contiguous copy."""
    st = t.stride()
    if (t.stride(-1) == 1 or not unit_last) and \
            st[seq_axis] == t.shape[seq_axis + 1] * st[seq_axis + 1]:
        return t
    return t.contiguous()


def _check(x, dt, A, Bm, Cm, D) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd scan kernels run on CUDA tensors, got {dev}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _TYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}: one "
                        "type, float32 or bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or D.dtype != torch.float32:
        raise TypeError("dt, A and D must be float32")
    if x.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)}: expected (B, H, nc, s, P)")
    B, H, nc, s, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, H, nc, s) or tuple(A.shape) != (B, H) \
            or tuple(D.shape) != (B, H) \
            or tuple(Bm.shape) != (B, nc, s, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}")
    if not (1 <= s <= MAX_CHUNK and 1 <= P <= MAX_HEAD_DIM
            and 1 <= N <= MAX_STATE):
        raise ValueError(f"chunk {s}, head_dim {P}, state {N}: the kernels "
                         f"take at most {MAX_CHUNK}, {MAX_HEAD_DIM}, "
                         f"{MAX_STATE}")


def _strides(x, dt, A, D, Bm, Cm, y, dx=None, ddt=None) -> ctypes.Array:
    """ssd::Strides of csrc/ssd_common.cuh: (b, h, l) of x, dt, y, dx, ddt;
    (b, h) of A, D; (b, l) of Bm, Cm."""
    def bhl(t):
        return [0, 0, 0] if t is None else [t.stride(0), t.stride(1),
                                            t.stride(3)]
    vals = (bhl(x) + bhl(dt) + list(A.stride()) + list(D.stride())
            + [Bm.stride(0), Bm.stride(2), Cm.stride(0), Cm.stride(2)]
            + bhl(y) + bhl(dx) + bhl(ddt))
    return (ctypes.c_longlong * len(vals))(*vals)


def _prepare(x, dt, A, Bm, Cm, D):
    _check(x, dt, A, Bm, Cm, D)
    return (_seq(x, 2), _seq(dt, 2, unit_last=False), A, _seq(Bm, 1),
            _seq(Cm, 1), D)


def ssd_scan_bhcsp(x, dt, A, Bm, Cm, D, *, save_states: bool = False):
    """Launch the forward kernel on the tensors' card.  Returns y in x's
    type and layout, and with ``save_states`` also the f32 state at the
    start of every chunk, (B, H, nc, P, N), which the backward needs."""
    x, dt, A, Bm, Cm, D = _prepare(x, dt, A, Bm, Cm, D)
    B, H, nc, s, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)  # x's strides: the model layout stays intact
    states = (torch.empty((B, H, nc, P, N), dtype=torch.float32,
                          device=x.device) if save_states else None)
    with torch.cuda.device(x.device):
        err = _build.library().ssd_scan_fwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
            states.data_ptr() if states is not None else None,
            _strides(x, dt, A, D, Bm, Cm, y), B, H, nc * s, P, N, s,
            _TYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan_bhcsp")
    ssd_scan_bhcsp.launches += 1
    return (y, states) if save_states else y


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, states, dy):
    """Launch the backward kernel on the tensors' card: (dx in x's type
    and layout, ddt f32, dA (B, H), dBm and dCm in Bm's type, dD (B, H)),
    from the forward's chunk-start ``states`` and the output gradient
    ``dy``.  dBm and dCm are per-head partials summed over the heads by
    one ordered ``torch.sum``, dA and dD per-chunk partials the same way:
    no atomics, the same bits every run."""
    x, dt, A, Bm, Cm, D = _prepare(x, dt, A, Bm, Cm, D)
    B, H, nc, s, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("dy must match x in shape and type")
    if tuple(states.shape) != (B, H, nc, P, N) \
            or states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("states must be the forward's contiguous "
                         "(B, H, nc, P, N) f32")
    dy = _seq(dy, 2)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dbp = torch.empty((B, H, nc * s, N), **f32)
    dcp = torch.empty((B, H, nc * s, N), **f32)
    dap = torch.empty((B, H, nc), **f32)
    ddp = torch.empty((B, H, nc), **f32)
    with torch.cuda.device(dev):
        err = _build.library().ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), dy.data_ptr(), states.data_ptr(),
            None, dx.data_ptr(), ddt.data_ptr(), dbp.data_ptr(),
            dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr(),
            _strides(x, dt, A, D, Bm, Cm, dy, dx, ddt), B, H, nc * s, P, N, s,
            _TYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return finish_bwd(x, Bm, Cm, dx, ddt, dbp, dcp, dap, ddp)


def finish_bwd(x, Bm, Cm, dx, ddt, dbp, dcp, dap, ddp):
    """The backward kernel's outputs as the gradient of (x, dt, A, Bm,
    Cm, D): the per-head partials of dBm and dCm and the per-chunk ones
    of dA and dD summed in order."""
    B, H, nc, s, P = x.shape
    N = Bm.shape[-1]
    dBm = dbp.sum(dim=1).reshape(B, nc, s, N).to(Bm.dtype)
    dCm = dcp.sum(dim=1).reshape(B, nc, s, N).to(Cm.dtype)
    return dx, ddt, dap.sum(dim=2), dBm, dCm, ddp.sum(dim=2)


ssd_scan_bhcsp.launches = 0
ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  The
    chunk-start states are saved only when ``save`` is true (a caller
    under ``torch.no_grad`` passes False)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, save: bool):
        if not save:
            return ssd_scan_bhcsp(x, dt, A, Bm, Cm, D)
        y, states = ssd_scan_bhcsp(x, dt, A, Bm, Cm, D, save_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        return (*ssd_scan_bwd(x, dt, A, Bm, Cm, D, states, dy), None)
