"""Single-token SSD state update (decode): the Hopper kernel's wrapper and
its plain version.

The decode-time recurrence of ``models/ssm.mamba2_decode`` for one token
per sequence:

  state' = exp(dt * A) * state + (dt * x) ⊗ B
  y      = state' · C + D * x

The kernel is ``csrc/ssm_update.cu`` and replaces ``ssm_state_update_bh``
of the JAX package's ``kernels/ssm_update.py``.  The state cache layout
runs it once per SSM layer in every engine step.

Layouts (the TPU kernel's):
  state   (B, H, P, N)  f32; any (b, h, p) strides, unit N stride
  x       (B, H, P)     f32 or bf16
  dt, A, D (B, H)       any float type, any strides (A and D are usually
                        per-head vectors expanded over B)
  Bm, Cm  (B, N)        x's type
  -> y (B, H, P) f32, state' (B, H, P, N) f32, both contiguous

Launch counter: ``ssm_state_update_bh.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssm_state_update_plain(state, x, dt, A, Bm, Cm, D):
    """What the kernel computes, in plain torch: every input cast to f32,
    both outputs f32."""
    state = state.float()
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())  # (B, H)
    upd = (dtf[..., None] * xf)[..., None] * Bm.float()[:, None, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y + D.float()[..., None] * xf, new_state


def ssm_state_update_bh(state, x, dt, A, Bm, Cm, D):
    """Launch the kernel on the tensors' card; returns (y, state')."""
    if state.device.type != "cuda":
        raise ValueError(f"ssm_state_update_bh runs on CUDA tensors, got "
                         f"{state.device}")
    if state.dtype != torch.float32 or state.dim() != 4:
        raise TypeError(f"state {state.dtype} {tuple(state.shape)}: "
                        "expected (B, H, P, N) float32")
    B, H, P, N = state.shape
    if x.dtype not in _TYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}: one "
                        "type, float32 or bfloat16")
    if tuple(x.shape) != (B, H, P) or tuple(Bm.shape) != (B, N) \
            or tuple(Cm.shape) != (B, N):
        raise ValueError(f"x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not fit state "
                         f"{tuple(state.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on "
                             f"{state.device}")
    dt, A, D = (t.float().expand(B, H) for t in (dt, A, D))
    if state.stride(-1) != 1:
        state = state.contiguous()
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    y = torch.empty((B, H, P), dtype=torch.float32, device=state.device)
    out = torch.empty((B, H, P, N), dtype=torch.float32, device=state.device)
    if y.numel() == 0:
        return y, out
    vals = [*state.stride()[:3], *x.stride()[:2], *dt.stride(), *A.stride(),
            *D.stride(), Bm.stride(0), Cm.stride(0)]
    with torch.cuda.device(state.device):
        err = _build.library().ssm_state_update_launch(
            state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
            out.data_ptr(), (ctypes.c_longlong * len(vals))(*vals), B, H, P, N,
            _TYPES[x.dtype], torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(err, "ssm_state_update_bh")
    ssm_state_update_bh.launches += 1
    return y, out


ssm_state_update_bh.launches = 0
