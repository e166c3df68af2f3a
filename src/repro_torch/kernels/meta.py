"""The kernels' footprints on the meta device: the dry-run's route.

``kernels.ops`` sends a CUDA tensor to a hand-written kernel and a CPU
tensor to its plain version.  A meta tensor comes here: each kernel
launch that the dry-run's steps reach (``launch.memory``) becomes one
operator of the ``repro_meta`` library, defined for the meta device
only, which allocates exactly what the card's wrapper allocates for
that launch (its outputs, its f32 scratch) and moves no data.  The
wrapper's Python around the launch (the staging copies of
``flash_attention._staged`` and ``ssd_scan._seq``, the sums after the
SSD backward) runs as it is, and :class:`FlashAttention` and
:class:`SSDScan` save for the backward exactly what the card's
``autograd.Function`` saves.  So the live bytes of a meta step are the
card's, and a ``TorchDispatchMode`` sees each launch as one operator:
its operands read once, its results and scratch written once.

Reached by the dry-run: K3 and its backward (train and prefill), K6 and
its backward (the SSM and hybrid archs), K5 and K7 (one decode step of
an MoE and of an SSM stack).  K1, K2 and K4 are not: the paged engine,
the sampler and the MoE capacity dispatch's ``torch.bmm`` serve or train
without them on the dry-run's paths.

:data:`FLOP_FORMULAS` gives ``FlopCounterMode`` each forward operator's
FLOPs as its plain version's products count them (the einsums and
matmuls; the masks, exponentials and sums count nothing), so the
dry-run's counted FLOPs are those of the plain route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.moe_gmm import decode_capacity

_LIB = torch.library.Library("repro_meta", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> (Tensor, Tensor)")
_LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor dout, bool causal, int window) "
            "-> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("ssd_fwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
            "Tensor D, bool save) -> (Tensor, Tensor)")
_LIB.define("ssd_bwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
            "Tensor D, Tensor states, Tensor dy) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("moe_decode(Tensor x, Tensor idx, Tensor gate, Tensor gate_w, "
            "Tensor up_w, Tensor down_w) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("ssm_update(Tensor state, Tensor x, Tensor dt, Tensor A, "
            "Tensor Bm, Tensor Cm, Tensor D) -> (Tensor, Tensor)")

_F32 = torch.float32


def _flash_fwd(q, k, v, causal, window):
    B, H, S, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=_F32)


def _flash_bwd(q, k, v, o, lse, dout, causal, window):
    # pass 3's mirror of the C entry flash_attention_bwd_workspace, at the
    # H100's SM count (imported here: kernel_checks imports the kernels)
    from repro_torch.analysis.kernel_checks import flash_bwd_workspace

    B, H, S, D = q.shape
    work = q.new_empty((flash_bwd_workspace(B, H, k.shape[1], S, D,
                                            causal, window),), dtype=_F32)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), work


def _ssd_fwd(x, dt, A, Bm, Cm, D, save):
    B, H, nc, _, P = x.shape
    states = x.new_empty((B, H, nc, P, Bm.shape[-1]) if save else (0,),
                         dtype=_F32)
    return torch.empty_like(x), states


def _ssd_bwd(x, dt, A, Bm, Cm, D, states, dy):
    B, H, nc, s, _ = x.shape
    N = Bm.shape[-1]
    return (torch.empty_like(x), torch.empty_like(dt),
            x.new_empty((B, H, nc * s, N), dtype=_F32),
            x.new_empty((B, H, nc * s, N), dtype=_F32),
            x.new_empty((B, H, nc), dtype=_F32),
            x.new_empty((B, H, nc), dtype=_F32))


def _moe_decode(x, idx, gate, gate_w, up_w, down_w):
    T, d = x.shape
    E, _, f = gate_w.shape
    C = decode_capacity(T)
    return (x.new_empty((T, d)), x.new_empty(idx.shape, dtype=torch.int32),
            x.new_empty((E,), dtype=torch.int32), x.new_empty((E, C, d)),
            x.new_empty((E, C, f)), x.new_empty((E, C, d)))


def _ssm_update(state, x, dt, A, Bm, Cm, D):
    return (state.new_empty(x.shape, dtype=_F32),
            state.new_empty(state.shape, dtype=_F32))


for _name, _fn in (("flash_fwd", _flash_fwd), ("flash_bwd", _flash_bwd),
                   ("ssd_fwd", _ssd_fwd), ("ssd_bwd", _ssd_bwd),
                   ("moe_decode", _moe_decode), ("ssm_update", _ssm_update)):
    _LIB.impl(_name, _fn, "Meta")

_ops = torch.ops.repro_meta


# ---------------------------------------------------------------------------
# the wrappers' meta route
# ---------------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """``flash_attention.FlashAttention`` on meta tensors: the forward's
    staging copies, out and lse; (q, k, v, out, lse) saved; the
    backward's dq, dk, dv and scratch."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _ops.flash_fwd(*map(_fa._staged, (q, k, v)), causal,
                                  window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q, k, v, out, dout = map(_fa._unit_d, (q, k, v, out, dout))
        dq, dk, dv, _ = _ops.flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                                       ctx.window)
        return dq, dk, dv, None, None


def _ssd_prepared(x, dt, A, Bm, Cm, D):
    return (_ssd._seq(x, 2), _ssd._seq(dt, 2, unit_last=False), A,
            _ssd._seq(Bm, 1), _ssd._seq(Cm, 1), D)


class SSDScan(torch.autograd.Function):
    """``ssd_scan.SSDScan`` on meta tensors: y, and with ``save`` the f32
    chunk-start states, saved with the inputs; the backward's gradients
    and per-head partials, summed as the card sums them."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, save: bool):
        y, states = _ops.ssd_fwd(*_ssd_prepared(x, dt, A, Bm, Cm, D), save)
        if save:
            ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        x, dt, A, Bm, Cm, D = _ssd_prepared(x, dt, A, Bm, Cm, D)
        outs = _ops.ssd_bwd(x, dt, A, Bm, Cm, D, states, _ssd._seq(dy, 2))
        return (*_ssd.finish_bwd(x, Bm, Cm, *outs), None)


def moe_decode(x, expert_idx, gate_vals, gate_w, up_w, down_w):
    """``moe_gmm.moe_decode_gmm`` on meta tensors: its contiguous inputs,
    then the slot map, counts, dispatch buffer, gate/up and down products
    and y, live together as at the card wrapper's return."""
    y, *_ = _ops.moe_decode(x.contiguous(),
                            expert_idx.to(torch.int64).contiguous(),
                            gate_vals.contiguous(), gate_w, up_w, down_w)
    return y


def ssm_state_update(state, x, dt, A, Bm, Cm, D):
    """``ssm_update.ssm_state_update_bh`` on meta tensors (A and D (B, H)
    as ``kernels.ops`` expands them): y and the new state, f32."""
    B, H = dt.shape
    dt, A, D = (t.float().expand(B, H) for t in (dt, A, D))
    if state.stride(-1) != 1:
        state = state.contiguous()
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    return _ops.ssm_update(state, x, dt, A, Bm, Cm, D)


# ---------------------------------------------------------------------------
# FLOPs: what FlopCounterMode counts of each plain version
# ---------------------------------------------------------------------------
def _flash_flops(q, k, v, causal, window, *, out_shape=None, **_):
    B, H, S, D = q
    return 4 * B * H * S * S * D  # the scores' and the output's einsums


def _ssd_flops(x, dt, A, Bm, Cm, D, save, *, out_shape=None, **_):
    B, H, nc, s, P = x
    N = Bm[-1]
    # C Bᵀ a chunk; W x; the chunk's state contributions; the carried
    # state read out at every chunk
    return 2 * B * nc * s * s * N + 2 * B * H * nc * s * (s * P + 2 * P * N)


def _moe_flops(x, idx, gate, gate_w, up_w, down_w, *, out_shape=None, **_):
    T, d = x
    E, _, f = gate_w
    return 6 * E * decode_capacity(T) * d * f  # gate, up, down products


def _ssm_update_flops(state, x, dt, A, Bm, Cm, D, *, out_shape=None, **_):
    B, H, P, N = state
    return 2 * B * H * P * N  # the state's readout


FLOP_FORMULAS = {_ops.flash_fwd: _flash_flops, _ops.ssd_fwd: _ssd_flops,
                 _ops.moe_decode: _moe_flops,
                 _ops.ssm_update: _ssm_update_flops}
