"""Target-hardware constants used by the roofline analysis and the dry-run.

Counterpart of the JAX package's ``utils/hardware.py``, which describes a
TPU v5e.  The port runs on an NVIDIA H100 SXM, so :data:`H100_SXM` is the
default chip; :data:`TPU_V5E` stays only so the tests can hold the port's
roofline arithmetic to JAX's on the same chip.  The field names are
JAX's, with their CUDA meaning:

  * ``peak_flops_bf16`` — dense bf16 tensor-core FLOP/s;
  * ``hbm_bandwidth`` — HBM bytes/s;
  * ``ici_link_bandwidth`` — on the H100 the card's whole NVLink rate
    each way (18 links together), so the roofline counts one "link";
  * ``hbm_bytes`` — device memory;
  * ``vmem_bytes`` — on the H100 the most shared memory one thread block
    may take (227 KB, the dynamic limit of sm_90), which bounds a
    kernel's tiles as VMEM bounds a Pallas block.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float  # FLOP/s per chip
    hbm_bandwidth: float  # bytes/s per chip
    ici_link_bandwidth: float  # bytes/s per link
    hbm_bytes: float  # capacity per chip
    vmem_bytes: float


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB, NVLink 900 GB/s both ways together (450 GB/s each way)
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_link_bandwidth=450e9,
    hbm_bytes=80e9,
    vmem_bytes=227 * 1024,
)

# the JAX package's chip, for comparing the two roofline reports
TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_link_bandwidth=50e9,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
)

DEFAULT_CHIP = H100_SXM

# streaming multiprocessors of an H100 SXM: the K3 backward sizes its
# head groups by the card's count (``csrc/flash_attention_bwd.cu``
# ``head_groups``)
H100_SM_COUNT = 132
