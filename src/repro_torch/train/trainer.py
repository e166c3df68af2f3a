"""Train and inference step builders.

Counterpart of the JAX package's ``train/trainer.py``:
``make_train_step`` builds the RL policy-gradient step (clipped surrogate
with a token-level loss) and ``make_prefill_step`` the inference worker's
logprob recompute, ``make_serve_step`` one decode step against a standing
cache.  Of the JAX ``TrainHParams``, ``act_spec`` and ``grad_specs``
(sharding constraints inside the jitted step, for GSPMD) have no
counterpart: across ranks ``make_train_step`` takes a
``train.parallel.Layout``, whose gather the loss passes to ``forward``
and whose reduce and norm finish the gradient of the local shards;
``compute_dtype`` and ``value_coef`` are read by nothing in either
package.  Every arch kind
runs here (``forward`` carries what is kind-specific); a batch's
``image_embeds`` (VLM) or ``frame_embeds`` (encoder-decoder) go to
``forward`` as its ``extra``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import token_entropy, token_logprobs
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
)
from repro_torch.utils.treeutil import tree_leaves, tree_map, tree_unflatten

Batch = Dict[str, torch.Tensor]

# the batch entries that ``forward`` takes as its ``extra``
EXTRA_KEYS = ("image_embeds", "frame_embeds")


def _extra(batch: Batch):
    extra = {k: batch[k] for k in EXTRA_KEYS if k in batch}
    return extra or None


class TrainHParams(NamedTuple):
    optimizer: AdamWConfig = AdamWConfig()
    n_microbatches: int = 1
    remat: bool = False
    # PPO/GRPO clipping
    clip_eps_low: float = 0.2
    clip_eps_high: float = 0.2
    kl_coef: float = 0.0
    entropy_coef: float = 0.0
    # dtype of the gradient accumulator across microbatches
    accum_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# RL policy loss (token-level, DAPO-style averaging)
# ---------------------------------------------------------------------------
def policy_loss(cfg: ModelConfig, hp: TrainHParams, params: Any,
                batch: Batch, gather=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate policy gradient on response tokens.

    batch:
      tokens        (B, S) int — prompt + response
      old_logprobs  (B, S) f32 — behaviour logprobs, aligned so entry t
                                 scores tokens[t] (entry 0 unused)
      advantages    (B, S) f32
      loss_mask     (B, S) f32 — 1 on response tokens
      ref_logprobs  (B, S) f32 — optional, for the k3 KL term
      (+ image_embeds / frame_embeds for vlm / encdec archs)
    ``gather`` goes to ``forward`` (a layout's, over shards); under a
    layout that splits the vocabulary the logits are this model rank's
    slice (``models.layers.VocabShard``), which ``token_logprobs`` and
    ``token_entropy`` read through the vocab-parallel log-softmax.
    """
    logits, aux = M.forward(params, cfg, batch["tokens"], _extra(batch),
                            remat=hp.remat, gather=gather)
    # logits[t] predicts tokens[t+1]
    lp = token_logprobs(logits[:, :-1], batch["tokens"][:, 1:],
                        cfg.vocab_size)  # (B, S-1)
    old_lp = batch["old_logprobs"][:, 1:]
    adv = batch["advantages"][:, 1:]
    mask = batch["loss_mask"][:, 1:].float()

    log_ratio = lp - old_lp
    ratio = torch.exp(log_ratio)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - hp.clip_eps_low,
                          1.0 + hp.clip_eps_high) * adv
    pg = -torch.minimum(unclipped, clipped)

    # token-level averaging (DAPO): sum over all tokens / total token count
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (pg * mask).sum() / denom

    metrics = {
        "pg_loss": loss,
        "aux_loss": aux,
        "ratio_mean": (ratio * mask).sum() / denom,
        "approx_kl": ((ratio - 1.0 - log_ratio) * mask).sum() / denom,
        "clip_frac": (((ratio - 1.0).abs() > hp.clip_eps_high).float()
                      * mask).sum() / denom,
    }
    if hp.entropy_coef > 0:
        ent = token_entropy(logits[:, :-1], cfg.vocab_size)  # (B, S-1)
        ent_mean = (ent * mask).sum() / denom
        loss = loss - hp.entropy_coef * ent_mean
        metrics["entropy"] = ent_mean
    if hp.kl_coef > 0 and "ref_logprobs" in batch:
        ref = batch["ref_logprobs"][:, 1:]
        # k3 estimator (Schulman): e^(ref-lp) - (ref-lp) - 1
        d = ref - lp
        kl = ((torch.exp(d) - d - 1.0) * mask).sum() / denom
        loss = loss + hp.kl_coef * kl
        metrics["kl_ref"] = kl
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def lm_loss(cfg: ModelConfig, hp: TrainHParams, params: Any,
            batch: Batch, gather=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain next-token cross-entropy (supervised warm-up and tests)."""
    logits, aux = M.forward(params, cfg, batch["tokens"], remat=hp.remat,
                            gather=gather)
    lp = token_logprobs(logits[:, :-1], batch["tokens"][:, 1:],
                        cfg.vocab_size)
    mask = (batch["loss_mask"][:, 1:] if "loss_mask" in batch
            else torch.ones_like(lp))
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(lp * mask).sum() / denom + aux
    return loss, {"loss": loss, "ce": loss - aux}


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, hp: TrainHParams, loss_fn=policy_loss,
                    layout=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    Gradient accumulation: the batch is split into n_microbatches chunks
    run one after the other (grads averaged in ``hp.accum_dtype``, metrics
    of the last chunk), bounding activation memory at one microbatch.
    The params and moments are updated in place (see ``adamw_update``).
    With a ``layout`` (``train.parallel.Layout``: mesh, specs, gather,
    reduce) the params and moments are this rank's shards and the batch
    its rows: the loss gathers each layer through ``layout.gather``, the
    microbatches accumulate in the local shards, ``layout.reduce``
    finishes the gradient and ``layout.grad_norm`` gives the clip its
    norm, so the step equals the one-rank step on the whole batch.
    """
    gather = layout.gather if layout is not None else None

    def grads_of(params, mb: Batch):
        live = tree_map(
            lambda p: p.detach().requires_grad_(p.is_floating_point()),
            params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            if gather is None:
                loss, metrics = loss_fn(cfg, hp, live, mb)
            else:
                loss, metrics = loss_fn(cfg, hp, live, mb, gather=gather)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return ({k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def train_step(params, opt_state: AdamWState, batch: Batch):
        nm = hp.n_microbatches
        if nm <= 1:
            metrics, grads = grads_of(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // nm
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=hp.accum_dtype, device=p.device), params)
            for i in range(nm):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                metrics, g = grads_of(params, mb)
                tree_map(lambda acc, x: acc.add_(x.to(hp.accum_dtype)),
                         grads, g)
                del g
            tree_map(lambda acc: acc.div_(nm), grads)
        norm = None
        if layout is not None:
            grads = layout.reduce(grads)
            norm = layout.grad_norm
        params, opt_state, opt_metrics = adamw_update(
            hp.optimizer, params, grads, opt_state, grad_norm=norm)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, hp: Optional[TrainHParams] = None,
                      layout=None):
    """Inference worker: recompute per-token logprobs for a rollout batch.
    With a ``layout`` (``train.parallel.Layout``) the params are this
    rank's shards and the batch its rows, each layer gathered through
    ``layout.gather`` as in :func:`make_train_step` (the dry-run's rank
    0, ``launch.memory``)."""
    hp = hp or TrainHParams()
    gather = layout.gather if layout is not None else None

    @torch.no_grad()
    def prefill_step(params, batch: Batch) -> torch.Tensor:
        logits, _ = M.forward(params, cfg, batch["tokens"], _extra(batch),
                              remat=hp.remat, gather=gather)
        lp = token_logprobs(logits[:, :-1], batch["tokens"][:, 1:],
                            cfg.vocab_size)
        # align: entry t scores tokens[t]; entry 0 zero
        return F.pad(lp, (1, 0))

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Decode worker: ONE new token against the standing cache.  The JAX
    ``unroll`` (of the layer scan) has no counterpart: the port's layers
    are a Python loop."""

    @torch.no_grad()
    def serve_step(params, token: torch.Tensor, state: M.DecodeState, pos):
        return M.decode_step(params, cfg, token, state, pos)

    return serve_step


def init_train_state(gen, cfg: ModelConfig, dtype=torch.float32,
                     device=None):
    params = M.init_model(gen, cfg, dtype, device)
    return params, init_adamw(params)
