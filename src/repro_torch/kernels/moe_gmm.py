"""Grouped (per-expert) matmul and the drop-free MoE decode FFN: the Hopper
kernels' wrappers and their plain versions.

``grouped_matmul`` computes ``out[e] = buf[e] @ w[e]`` for every expert,
summing in f32; ``moe_decode_gmm`` is the exact top-k expert FFN of the
serve tier: a token -> expert gather into a per-expert buffer that never
drops (capacity ``decode_capacity(T)``), gate and up products with SiLU
gating, the down product and the gate-weighted combine.  The kernels are
``csrc/moe_gmm.cu``, built by :mod:`repro_torch.kernels._build`; they
replace ``grouped_matmul`` and ``moe_decode_gmm`` of the JAX package's
``kernels/moe_gmm.py``.  The grouped matmul is one kernel a type: bf16
(serving) on the tensor cores, f32 on the CUDA cores, so f32 sums keep
full precision without TF32.

Layouts:
  buf   (E, C, D)  bf16 or f32, w (E, D, F) of the same type
  out   (E, C, F)  buf's type
  rows  (E,)       int32, optional: rows at or past rows[e] are neither
                   read nor written
  x     (T, d), expert_idx (T, k) int, gate_vals (T, k) f32,
  gate_w/up_w (E, d, f), down_w (E, f, d) -> y (T, d) in x's type

Launch counters: ``grouped_matmul.launches`` counts every grouped-matmul
launch, the gate/up and down launches inside ``moe_decode_gmm`` among
them; ``moe_decode_gmm.launches`` counts its calls.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_capacity(num_tokens: int) -> int:
    """Drop-free per-expert buffer size for ``moe_decode_gmm``: top-k
    expert indices are distinct per token, so one expert receives at most
    ``num_tokens`` assignments; round up to the MXU tile above 128."""
    if num_tokens <= 128:
        return max(num_tokens, 1)
    return ((num_tokens + 127) // 128) * 128


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def grouped_matmul_plain(buf, w, rows: Optional[torch.Tensor] = None):
    """What the kernel computes, in plain torch: the f32 product per
    expert, rounded to buf's type.  Rows at or past ``rows[e]`` come back
    as zeros (the kernel leaves them unwritten)."""
    out = torch.einsum("ecd,edf->ecf", buf.float(), w.float()).to(buf.dtype)
    if rows is not None:
        live = (torch.arange(buf.shape[1], device=buf.device)[None, :]
                < rows.to(buf.device).long()[:, None])
        out = out * live[..., None].to(out.dtype)
    return out


def expert_positions(flat_e: torch.Tensor, E: int):
    """(pos (n,), counts (E,)): each assignment's rank among the earlier
    assignments to its expert in token-major order (the TPU kernel's
    one-hot cumsum), and each expert's assignments.  The one-hot is laid
    out (E, n) so the scan runs along the contiguous axis: on an H100 the
    scan along the outer axis of an (n, E) int64 one-hot took 16.5 ms at
    n = 65536, E = 40."""
    onehot = (flat_e[None, :] == torch.arange(E, device=flat_e.device)
              [:, None]).to(torch.int32)
    cum = onehot.cumsum(1, dtype=torch.int32)
    return cum.gather(0, flat_e[None, :])[0].long() - 1, cum[:, -1]


def _dispatch_plain(expert_idx, E: int, C: int):
    """(slot (T*k,) int64, counts (E,)): each assignment's row e * C + pos
    in the (E * C) buffer (see :func:`expert_positions`)."""
    flat_e = expert_idx.reshape(-1).long()
    pos, counts = expert_positions(flat_e, E)
    return flat_e * C + pos, counts.clamp(max=C)


def moe_decode_gmm_plain(x, expert_idx, gate_vals, gate_w, up_w, down_w):
    """What the kernels compute, in plain torch, step by step with the TPU
    kernel's rounding points: the gather, each grouped product rounded to
    x's type, ``silu(g) * u`` in x's type, the down product, then each
    token's k slots summed in order j = 0..k-1 in f32 (products of
    ``gate_vals`` rounded to x's type) and rounded once."""
    T, d = x.shape
    E = gate_w.shape[0]
    k = expert_idx.shape[1]
    C = decode_capacity(T)
    slot, counts = _dispatch_plain(expert_idx, E, C)
    token_ids = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((E * C, d)).index_copy(0, slot, x[token_ids])
    buf = buf.view(E, C, d)
    h = (F.silu(grouped_matmul_plain(buf, gate_w, counts))
         * grouped_matmul_plain(buf, up_w, counts))
    out = grouped_matmul_plain(h, down_w, counts).reshape(E * C, d)
    gathered = out[slot].reshape(T, k, d).float()
    g = gate_vals.to(x.dtype).float()
    acc = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = acc + g[:, j, None] * gathered[:, j]
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_same(dev: torch.device, dtype, **tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the MoE kernels run on CUDA tensors, got {dev}")
    if dtype not in _TYPES:
        raise TypeError(f"{dtype}: float32 or bfloat16 only")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _rows_arg(rows, E: int, dev) -> int:
    if rows is None:
        return 0
    if rows.device != dev or rows.dtype != torch.int32 \
            or tuple(rows.shape) != (E,) or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (E,) int32 tensor on "
                         "the card")
    return rows.data_ptr()


def _gmm_launch(a, w, w_up, out, rows) -> None:
    E, C, D = a.shape
    F_ = w.shape[2]
    with torch.cuda.device(a.device):
        err = _build.library().grouped_matmul_launch(
            a.data_ptr(), w.data_ptr(),
            0 if w_up is None else w_up.data_ptr(), out.data_ptr(),
            _rows_arg(rows, E, a.device), E, C, D, F_, _TYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1


def grouped_matmul(buf, w, rows: Optional[torch.Tensor] = None):
    """Launch the grouped-matmul kernel on the tensors' card; returns
    (E, C, F) in buf's type (rows past ``rows[e]`` unwritten)."""
    _check_same(buf.device, buf.dtype, w=w)
    if buf.dim() != 3 or w.dim() != 3 or w.shape[:2] != (buf.shape[0],
                                                         buf.shape[2]):
        raise ValueError(f"buf {tuple(buf.shape)} and w {tuple(w.shape)}: "
                         "expected (E, C, D) and (E, D, F)")
    buf = buf.contiguous()
    out = torch.empty((*buf.shape[:2], w.shape[2]), dtype=buf.dtype,
                      device=buf.device)
    _gmm_launch(buf, w, None, out, rows)
    return out


def moe_decode_gmm(x, expert_idx, gate_vals, gate_w, up_w, down_w):
    """Launch the four kernels of the drop-free MoE decode FFN on the
    tensors' card; returns (T, d) in x's type."""
    dev = x.device
    _check_same(dev, x.dtype, gate_w=gate_w, up_w=up_w, down_w=down_w)
    T, d = x.shape
    E, d_, f = gate_w.shape
    k = expert_idx.shape[1]
    if d_ != d or up_w.shape != gate_w.shape \
            or tuple(down_w.shape) != (E, f, d) \
            or tuple(expert_idx.shape) != (T, k) \
            or tuple(gate_vals.shape) != (T, k):
        raise ValueError(
            f"x {tuple(x.shape)}, expert_idx {tuple(expert_idx.shape)}, "
            f"gate_vals {tuple(gate_vals.shape)}, gate_w "
            f"{tuple(gate_w.shape)}, up_w {tuple(up_w.shape)}, down_w "
            f"{tuple(down_w.shape)} do not agree")
    if expert_idx.device != dev or gate_vals.device != dev:
        raise ValueError("expert_idx and gate_vals must be on x's card")
    if gate_vals.dtype != torch.float32:
        raise TypeError(f"gate_vals is {gate_vals.dtype}, expected float32")
    x = x.contiguous()
    idx = expert_idx.to(torch.int64).contiguous()
    gate = gate_vals.contiguous()
    C = decode_capacity(T)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    slot = torch.empty((T, k), dtype=torch.int32, device=dev)
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    buf = torch.empty((E, C, d), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.moe_dispatch_launch(
            x.data_ptr(), idx.data_ptr(), slot.data_ptr(), counts.data_ptr(),
            buf.data_ptr(), T, k, d, E, C, _TYPES[x.dtype], stream)
    _build.check(err, "moe_dispatch")
    h = torch.empty((E, C, f), dtype=x.dtype, device=dev)
    _gmm_launch(buf, gate_w, up_w, h, counts)
    out = torch.empty((E, C, d), dtype=x.dtype, device=dev)
    _gmm_launch(h, down_w, None, out, counts)
    y = torch.empty((T, d), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.moe_combine_launch(out.data_ptr(), slot.data_ptr(),
                                     gate.data_ptr(), y.data_ptr(), T, k, d,
                                     _TYPES[x.dtype], stream)
    _build.check(err, "moe_combine")
    moe_decode_gmm.launches += 1
    return y


grouped_matmul.launches = 0
moe_decode_gmm.launches = 0
