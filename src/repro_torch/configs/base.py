"""Configuration system: model / shape / parallelism configs + registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of that package).  Every ported architecture lives in its own module
under ``repro_torch.configs`` and registers a :class:`ModelConfig` via
:func:`register`; :func:`get_config` resolves a name.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture kinds
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"  # audio backbone (whisper-style)
VLM = "vlm"

ARCH_KINDS = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    # Capacity factor for token dispatch; capacity per expert is
    # ceil(tokens * top_k / num_experts * capacity_factor).
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Auxiliary load-balance loss weight (Switch-style).
    aux_loss_weight: float = 1e-2
    # Shared (always-on) expert d_ff; 0 disables.
    shared_expert_d_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    state_size: int
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128
    conv_width: int = 4
    # number of SSD heads = d_inner / head_dim (derived)


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture's full configuration.

    Only the *backbone* transformer/SSM is described; modality frontends
    (audio conv stack, vision encoder) are stubs whose outputs are supplied
    as precomputed embeddings by ``input_specs``.
    """

    name: str
    kind: str
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int  # dense FFN width (per-expert width lives in moe.expert_d_ff)
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    max_seq_len: int = 8192
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False
    qk_norm: bool = False
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # hybrid: one *shared-weight* attention block applied every N ssm layers
    attn_every: int = 0
    # --- enc-dec (audio) ---
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30s -> 1500 frames after conv
    # --- vlm ---
    cross_attn_every: int = 0  # every Nth layer is a cross-attn layer
    num_image_tokens: int = 1024
    # --- long-context variant ---
    sliding_window: int = 0  # 0 = full attention; >0 = windowed
    # --- source citation ---
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the embedding shards cleanly on a 16-way axis."""
        return _ceil_to(self.vocab_size, 16 * 128)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.ssm is None:
            return 0
        return self.ssm.expand * self.d_model

    @property
    def num_ssm_heads(self) -> int:
        if self.ssm is None:
            return 0
        return self.d_inner // self.ssm.head_dim

    @property
    def num_self_layers(self) -> int:
        """Decoder self-attention/SSM layers excluding periodic extras."""
        if self.kind == VLM and self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            return self.num_layers - n_cross
        return self.num_layers

    @property
    def num_cross_layers(self) -> int:
        if self.kind == VLM and self.cross_attn_every:
            return self.num_layers // self.cross_attn_every
        if self.kind == ENCDEC:
            return self.num_layers  # every decoder layer cross-attends
        return 0

    # ------------------------------------------------------------------
    # Parameter counting (for 6ND model FLOPs and roofline)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        return q + kv + o

    def _dense_ffn_params(self, d_ff: int) -> int:
        # gated (SwiGLU-style): gate, up, down
        return 3 * self.d_model * d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        di, ds = self.d_inner, self.ssm.state_size
        nh = self.num_ssm_heads
        # in_proj -> [z, x, B, C, dt]; out_proj
        in_proj = self.d_model * (2 * di + 2 * ds + nh)
        conv = self.ssm.conv_width * (di + 2 * ds)
        out_proj = di * self.d_model
        return in_proj + conv + out_proj + 2 * nh  # A_log, D

    def layer_params(self) -> Dict[str, int]:
        """Parameter count per layer *type*."""
        out: Dict[str, int] = {}
        if self.kind in (DENSE, ENCDEC, VLM):
            out["self"] = self._attn_params() + self._dense_ffn_params(self.d_ff)
        if self.kind == MOE:
            assert self.moe is not None
            expert = self._dense_ffn_params(self.moe.expert_d_ff)
            router = self.d_model * self.moe.num_experts
            shared = (
                self._dense_ffn_params(self.moe.shared_expert_d_ff)
                if self.moe.shared_expert_d_ff
                else 0
            )
            out["self"] = (
                self._attn_params() + self.moe.num_experts * expert + router + shared
            )
            out["self_active"] = (
                self._attn_params() + self.moe.top_k * expert + router + shared
            )
        if self.kind == SSM:
            out["ssm"] = self._ssm_params() + (
                self._dense_ffn_params(self.d_ff) if self.d_ff else 0
            )
        if self.kind == HYBRID:
            # zamba-style: mamba blocks carry no FFN; d_ff belongs to the
            # shared attention block.
            out["ssm"] = self._ssm_params()
            out["shared_attn"] = self._attn_params() + self._dense_ffn_params(
                max(self.d_ff, 4 * self.d_model)
            )
        if self.kind == VLM:
            out["cross"] = self._attn_params() + self._dense_ffn_params(self.d_ff)
        if self.kind == ENCDEC:
            out["enc"] = self._attn_params() + self._dense_ffn_params(self.d_ff)
            out["cross"] = self._attn_params()
        return out

    def param_count(self, active_only: bool = False) -> int:
        lp = self.layer_params()
        emb = self.padded_vocab * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        if self.kind in (DENSE,):
            total += self.num_layers * lp["self"]
        elif self.kind == MOE:
            key = "self_active" if active_only else "self"
            total += self.num_layers * lp[key]
        elif self.kind == SSM:
            total += self.num_layers * lp["ssm"]
        elif self.kind == HYBRID:
            total += self.num_layers * lp["ssm"]
            total += lp["shared_attn"]  # shared weights counted ONCE
        elif self.kind == VLM:
            total += self.num_self_layers * lp["self"]
            total += self.num_cross_layers * lp["cross"]
        elif self.kind == ENCDEC:
            total += self.num_encoder_layers * lp["enc"]
            total += self.num_layers * (lp["self"] + lp["cross"])
        return total

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        assert self.kind in ARCH_KINDS, self.kind
        if self.kind in (SSM, HYBRID):
            assert self.ssm is not None
        if self.kind == MOE:
            assert self.moe is not None
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                "GQA requires num_heads % num_kv_heads == 0"
            )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests.

        2 layers, d_model <= 512, <= 4 experts, per assignment.
        """
        kw: Dict[str, object] = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=256,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=64 if self.num_heads else 0,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            max_seq_len=256,
            num_encoder_layers=2 if self.num_encoder_layers else 0,
            encoder_seq_len=32 if self.kind == ENCDEC else self.encoder_seq_len,
            cross_attn_every=2 if self.cross_attn_every else 0,
            num_image_tokens=16 if self.kind == VLM else self.num_image_tokens,
            attn_every=2 if self.attn_every else 0,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=128,
                capacity_factor=self.moe.capacity_factor,
                aux_loss_weight=self.moe.aux_loss_weight,
                shared_expert_d_ff=64 if self.moe.shared_expert_d_ff else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(
                state_size=16, expand=2, head_dim=32, chunk_size=32, conv_width=4
            )
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.phase == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    # import side-effect registration
    from repro_torch.configs import _load_all  # noqa: F401

    _load_all()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    cfg = _REGISTRY[name]()
    cfg.validate()
    return cfg


def list_archs() -> List[str]:
    from repro_torch.configs import _load_all

    _load_all()
    return sorted(_REGISTRY)
