"""RL component workers (paper Fig. 5a) built on the M2Flow Worker base.

Each worker owns its tensors (registered for onload/offload context
switching) and exposes chunk-level task methods the Execution Flow
Manager drives at any granularity — the SPMD-over-any-batch property
elastic pipelining relies on (§3.3).  Chunks travel between workers as
dicts of host numpy arrays; each worker moves what it needs onto its
device and hands numpy back.

Counterpart of the GRPO workers of the JAX package's ``rl/workers.py``:
``RolloutWorker``, ``InferenceWorker``, ``ActorWorker`` and
``RewardWorker``.  The rollout runs on the paged engine only (the static
``Engine`` is ROADMAP.md queue 1, item 4), and it has no closed-loop
``act`` path; ``act`` and ``SimulatorWorker`` come with the embodied
workflow (item 7).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.worker import Worker
from repro_torch.device import DeviceLike
from repro_torch.models import init_model
from repro_torch.rl.advantage import broadcast_to_tokens, grpo_advantages
from repro_torch.rl.reward import math_reward
from repro_torch.serve import layouts as serve_layouts
from repro_torch.serve.engine import PagedEngine
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.trainer import (
    TrainHParams,
    make_prefill_step,
    make_train_step,
)

STATIC_ENGINE_UNPORTED = (
    "the static Engine is not ported yet (ROADMAP.md queue 1, item 4: the "
    "static Engine); the paged engine serves dense and MoE stacks without "
    "a sliding window, and SSM and hybrid stacks")


def rollout_seeds(seed: int) -> Iterator[int]:
    """Base seeds of a rollout worker's successive ``generate`` calls: a
    stream seeded once, one draw in [0, 2^31 - 1) a call.  Request ``i``
    of a call is seeded ``base + i`` by the engine."""
    rng = np.random.default_rng(seed)
    while True:
        yield int(rng.integers(0, 2**31 - 1))


class RolloutWorker(Worker):
    """Generation engine (the paper's SGLang/vLLM role).

    Generates through the continuous-batching
    :class:`~repro_torch.serve.engine.PagedEngine`: requests join/leave
    the decode batch per step, the cache lives in the arch's layout
    (paged KV blocks or constant-size recurrent state), and trainer
    weight updates apply in flight with per-request version tags.  An
    arch no layout covers (windowed dense attention, encoder-decoder,
    VLM) raises: the JAX worker falls back to its static engine there.

    Sampling seeds come from :attr:`seeds` (:func:`rollout_seeds` of
    ``seed + process_index``), one base seed a call; a caller may replace
    the stream (tests feed the JAX worker's base seeds).
    """

    def __init__(self, name: str, *, cfg: ModelConfig,
                 max_new_tokens: int = 16, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, devices: Sequence[int] = (),
                 process_index: int = 0, max_batch: int = 8, page_size: int = 16,
                 prefix_sharing: bool = True, prefill_chunk: int = 32,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        if not serve_layouts.covers(cfg):
            raise NotImplementedError(
                f"RolloutWorker {name!r}: arch {cfg.name!r} (kind="
                f"{cfg.kind}, sliding_window={cfg.sliding_window}) needs "
                "the static engine, and " + STATIC_ENGINE_UNPORTED)
        # prefix sharing makes a GRPO group's common prompt prefill
        # once: generate() submits all group members to one engine,
        # the first admission indexes the prompt pages in the radix
        # cache and every sibling adopts them
        self.engine = PagedEngine(
            cfg, max_batch=max_batch, page_size=page_size,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, prefix_sharing=prefix_sharing,
            prefill_chunk=prefill_chunk, device=self.device)
        self.seeds: Iterator[int] = rollout_seeds(seed + process_index)
        self.register_state("params", None)

    def bind_devices(self, devices: Sequence[int]) -> None:
        """Plan-driven rebinding; the engine's cache lives on one card,
        so a slice that folds onto another card is refused (on one card
        every slice folds onto it)."""
        new = self.mesh_of(tuple(devices))
        if new and new[0] != self.engine.device:
            raise NotImplementedError(
                f"moving {self.name}'s paged engine from "
                f"{self.engine.device} to {new[0]}: the port runs on one "
                "card (ROADMAP.md queue 1, item 12: multi-device)")
        super().bind_devices(devices)

    def offload(self, keys: Optional[Sequence[str]] = None):
        moved = super().offload(keys)
        if "params" in moved:
            # the engine holds the applied weights too: drop them, or
            # the offload frees nothing on the card
            self.engine.release_params()
        return moved

    # weight sync (paper §2.1): trainer -> rollout.  On the paged engine
    # this is NOT a barrier — the update is enqueued and applied at the
    # next step boundary while requests stay in flight.
    def update_weights(self, params: Any,
                       version: Optional[int] = None) -> None:
        self.set_state("params", params)
        self.engine.update_weights(params, version)

    def generate(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        params = self.get_state("params")
        assert params is not None, "rollout weights not initialized"
        res = self.engine.generate(params, np.asarray(chunk["prompt_tokens"]),
                                   seed=next(self.seeds))
        out = dict(chunk)
        out["tokens"] = res.tokens.numpy()
        out["logprobs"] = res.logprobs.numpy()
        out["lengths"] = res.lengths.numpy()
        if res.weight_versions is not None:
            out["weight_versions"] = np.asarray(res.weight_versions)
        return out

    def request_records(self):
        """(tokens, service_time) per completed request since last call —
        feeds the profiler's measured tail factor."""
        return self.engine.pop_request_records()


class InferenceWorker(Worker):
    """Prefill-only logprob recompute (the paper's 'Inference' box)."""

    def __init__(self, name: str, *, cfg: ModelConfig,
                 devices: Sequence[int] = (), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        self._step = make_prefill_step(cfg)
        self.register_state("params", None)

    def update_weights(self, params: Any) -> None:
        self.set_state("params", params)

    def compute_logprobs(self, chunk: Dict[str, np.ndarray],
                         key: str = "old_logprobs",
                         params: Optional[Any] = None
                         ) -> Dict[str, np.ndarray]:
        """Prefill recompute.  ``key`` lets the async consumer re-score a
        stale rollout at the CURRENT parameter version (e.g. into
        ``'target_logprobs'``) without clobbering the behavior reference;
        explicit ``params`` scores with those weights WITHOUT touching the
        worker's registered state (the producer thread owns that state —
        see GRPORunner._run_async_horizon)."""
        if params is None:
            params = self.get_state("params")
        tokens = torch.tensor(np.asarray(chunk["tokens"]), dtype=torch.long,
                              device=self.device)
        out = dict(chunk)
        out[key] = self._step(params, {"tokens": tokens}).cpu().numpy()
        return out


class ActorWorker(Worker):
    """Trainable policy (actor) with AdamW state; GRPO/PPO loss.

    Its f32 params come from ``init_model`` with a generator seeded
    ``seed``, unless ``params`` hands them in (tests bridge the JAX
    actor's).  The train step updates params and moments in place."""

    def __init__(self, name: str, *, cfg: ModelConfig, hp: TrainHParams,
                 seed: int = 0, devices: Sequence[int] = (),
                 process_index: int = 0, device: DeviceLike = None,
                 params: Optional[Any] = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        self.hp = hp
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_model(gen, cfg, torch.float32, self.device)
        self.register_state("params", params)
        self.register_state("opt", init_adamw(params))
        self._step = make_train_step(cfg, hp)
        self.metrics_history = []

    def params(self) -> Any:
        return self.get_state("params")

    def train(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        params = self.get_state("params")
        opt = self.get_state("opt")
        dev = self.device
        batch = {"tokens": torch.tensor(np.asarray(chunk["tokens"]),
                                        dtype=torch.long, device=dev)}
        for k in ("old_logprobs", "advantages", "loss_mask"):
            batch[k] = torch.tensor(np.asarray(chunk[k]),
                                    dtype=torch.float32, device=dev)
        params, opt, metrics = self._step(params, opt, batch)
        self.set_state("params", params)
        self.set_state("opt", opt)
        m = {k: float(v) for k, v in metrics.items()}
        self.metrics_history.append(m)
        out = dict(chunk)
        out["metrics"] = m
        return out


class RewardWorker(Worker):
    """Rule-based reward + GRPO group advantage computation (host numpy;
    it owns no device state)."""

    def __init__(self, name: str, *, prompt_len: int, group_size: int = 1,
                 devices: Sequence[int] = (), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.prompt_len = prompt_len
        self.group_size = group_size

    def score(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        toks = chunk["tokens"]
        rewards = math_reward(toks, chunk["answers"], self.prompt_len)
        B, S = toks.shape
        mask = np.zeros((B, S), np.float32)
        mask[:, self.prompt_len:] = (toks[:, self.prompt_len:] != 0)
        gs = min(self.group_size, B) if B % max(self.group_size, 1) == 0 else 1
        if gs == 1 and self.group_size > 1:
            warnings.warn(
                f"reward chunk of {B} rows is not a multiple of "
                f"group_size={self.group_size}; group-relative advantages "
                "degrade to 0 (no learning signal). Align the execution "
                "plan's chunk size (SchedulerConfig.chunk_multiple).",
                stacklevel=2)
        adv_seq = grpo_advantages(rewards, gs)
        out = dict(chunk)
        out["rewards"] = rewards
        out["loss_mask"] = mask
        out["advantages"] = broadcast_to_tokens(adv_seq, mask)
        return out
