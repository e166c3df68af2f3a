"""Mixture-of-Experts with capacity-based dispatch (Switch/MaxText style),
and the exact top-k combine of the serve tier.

Counterpart of the JAX package's ``models/moe.py``, with its signatures
minus ``use_kernel``: the route follows the device, as for the other
kernels (:mod:`repro_torch.kernels.ops`).  The JAX sharding hints have no
counterpart: across ranks a layout gathers the block's rows and splits
the experts over its model axis (``train.parallel``).

- :func:`moe_block` (training and recompute) keeps JAX's capacity
  dispatch and aux loss.  Its three expert products are batched matmuls,
  as JAX leaves them to XLA.  The dispatch is an ``index_copy`` onto
  ``E*C + 1`` rows (each kept slot written once, overflow to the last
  row) and the combine a gather to (T, k, d) summed over k: no
  ``index_add_``, whose CUDA atomics would add in a varying order and
  make recompute and training unrepeatable.
- :func:`moe_decode_exact` (serving) always goes through
  ``ops.moe_decode``: the drop-free grouped kernels on the card, their
  plain version on the CPU.
- :func:`moe_block_dense_ref` is the dense all-experts oracle.

Top-k takes the first k of a stable descending sort, so ties go to the
lower expert index as ``jax.lax.top_k`` breaks them (``torch.topk``
promises no order).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.moe_gmm import expert_positions
from repro_torch.models.layers import Params, dense_init, init_mlp, mlp


def init_moe(gen, cfg: ModelConfig, dtype, device, *,
             lead: Sequence[int] = ()) -> Params:
    """The router stays f32 whatever ``dtype``, as in JAX."""
    assert cfg.moe is not None
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.expert_d_ff
    p: Params = {
        "router": dense_init(gen, (d, E), torch.float32, device, lead=lead),
        "gate": dense_init(gen, (E, d, f), dtype, device, lead=lead),
        "up": dense_init(gen, (E, d, f), dtype, device, lead=lead),
        "down": dense_init(gen, (E, f, d), dtype, device, lead=lead),
    }
    if m.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, d, m.shared_expert_d_ff, dtype, device,
                               lead=lead)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    # keep MXU-aligned when large (round UP so alignment never adds drops)
    if c >= 128:
        c = ((c + 127) // 128) * 128
    return max(c, 1)


def top_k_stable(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg: ModelConfig, xf: torch.Tensor):
    """(probs (T, E), normalized gate values (T, k) f32, expert ids (T, k))."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_stable(probs, cfg.moe.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(cfg: ModelConfig, probs, expert_idx) -> torch.Tensor:
    """Switch eq. 4 load-balance loss."""
    E = cfg.moe.num_experts
    me = probs.mean(0)
    ce = F.one_hot(expert_idx, E).float().sum(1).mean(0)
    return cfg.moe.aux_loss_weight * E * (me * ce).sum()


def moe_block(p: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), aux load-balance loss scalar).

    Over a batch split across ranks (a ``"rows"`` marker in ``p``,
    ``train.parallel``) the dispatch and the aux loss run on the whole
    batch, gathered from the ranks, and each rank keeps its rows.

    Split over a layout's model axis (a ``"tp"`` marker) every rank
    routes the whole batch and computes the whole aux loss, then runs
    the capacity rows of its E / m experts (``p["gate"]`` holds fewer
    than E), or every expert's rows over its d_ff / m columns.  Its
    combine is a partial sum that leaves through "g"; the dispatched
    tokens and the gate values enter through "f", so the router's
    gradient from the gate values is summed over the ranks while its
    aux-loss part, whole on every rank, is not."""
    rows = p.get("rows")
    if rows is not None:
        y, aux = moe_block({k: v for k, v in p.items() if k != "rows"},
                           cfg, rows.gather(x))
        return rows.local(y), aux
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    C = _capacity(T, cfg)

    xf = x.reshape(T, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xf)
    aux = _aux_loss(cfg, probs, expert_idx)

    # ---- capacity dispatch ----
    flat_expert = expert_idx.reshape(T * k)  # token-major order
    my_pos, _ = expert_positions(flat_expert, E)
    keep = my_pos < C
    tp, xs = p.get("tp"), xf
    El, lo = p["gate"].shape[-3], 0  # the experts this rank runs
    if tp is not None:
        xs, gate_vals = tp.enter(xf), tp.enter(gate_vals)
        if El < E:
            lo = tp.rank * El
            keep = keep & (flat_expert >= lo) & (flat_expert < lo + El)
    # overflow (and another rank's experts) to the last row
    slot = torch.where(keep, (flat_expert - lo) * C + my_pos, El * C)

    token_ids = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((El * C + 1, d)).index_copy(0, slot, xs[token_ids])
    buf = buf[: El * C].view(El, C, d)

    # ---- expert FFN (grouped matmul) ----
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out_flat = torch.bmm(h, p["down"]).reshape(El * C, d)

    # ---- combine ----
    gathered = torch.where(keep[:, None],
                           out_flat[slot.clamp(max=El * C - 1)],
                           0.0)  # (Tk, d)
    weighted = gathered * gate_vals.reshape(T * k, 1).to(x.dtype)
    y = weighted.reshape(T, k, d).sum(1)
    if tp is not None:
        y = tp.exit(y)

    if "shared" in p:
        y = y + mlp(p["shared"], xf)
    return y.reshape(B, S, d), aux


def moe_decode_exact(p: Params, cfg: ModelConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """Exact top-k expert combine for the serving/decode path (no aux).

    Capacity dispatch (:func:`moe_block`) drops tokens as a function of
    who else is in the batch, which serving cannot accept: sampling must
    not depend on how the scheduler composed the decode batch.  This path
    routes as :func:`moe_block` does and combines every routed expert,
    through ``ops.moe_decode``.
    """
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    _, gate_vals, expert_idx = _route(p, cfg, xf)
    y = kops.moe_decode(xf, expert_idx, gate_vals, p["gate"], p["up"],
                        p["down"]).to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], xf)
    return y.reshape(B, S, d)


def moe_block_dense_ref(p: Params, cfg: ModelConfig,
                        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: dense all-experts compute, exact top-k combine (no capacity
    drops).  With a capacity factor high enough that nothing drops,
    :func:`moe_block` must match it."""
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xf)
    h = (F.silu(torch.einsum("td,edf->tef", xf, p["gate"]))
         * torch.einsum("td,edf->tef", xf, p["up"]))
    all_out = torch.einsum("tef,efd->ted", h, p["down"])  # (T, E, d)
    combine = torch.zeros(probs.shape, dtype=torch.float32, device=x.device)
    combine = combine.scatter(1, expert_idx, gate_vals)
    y = torch.einsum("te,ted->td", combine.to(x.dtype), all_out)
    aux = _aux_loss(cfg, probs, expert_idx)
    if "shared" in p:
        y = y + mlp(p["shared"], xf)
    return y.reshape(B, S, d), aux
