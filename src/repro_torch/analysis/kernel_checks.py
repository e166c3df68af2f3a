"""flowlint Pass 3 — CUDA launch lint and RNG-determinism lint.

Counterpart of the JAX package's ``analysis/kernel_checks.py``, which
lints Pallas BlockSpecs.  The port's kernel wrappers (``kernels/*.py``)
check their inputs and call a C launcher (``kernels/csrc/*.cu``) that
picks a grid, a block, the dynamic shared memory and, for some kernels,
a thread-block cluster; a bad combination raises in the wrapper or fails
at ``cudaLaunchKernelEx`` on the card.  This pass re-derives each
launch as a declarative :class:`KernelInvocation` (the launch's geometry,
the tile each block takes of each operand, the wrapper's preconditions)
and evaluates it at the config-zoo shapes (``configs/shapes.py``) in
microseconds, with JAX's codes:

  * K101 — degenerate grid (a dimension of zero or negative extent);
  * K102 — a precondition under which the wrapper raises or the launch
    fails on sm_90: a head_dim past the kernel's limit or not a multiple
    of 8 (K1), more than 64 query heads a KV head (K1), more than 1024
    threads a block, a grid y or z above 65535 (x above 2**31 - 1),
    dynamic shared memory above 227 KB, a cluster above 8 blocks or one
    that does not divide the grid;
  * K103 — a tile exceeding its operand dimension (where the kernel
    does not clip that dimension's last tile);
  * K104 — an index map addressing out of bounds at some grid corner
    (page tables modeled at their worst-case entry);
  * K105 — a page table too short to cover the declared context length;
  * K106 — GQA head counts that do not divide (``H % KV != 0``);
  * K107 — a public kernel entry in ``kernels/ops.py`` with no lint spec.

A wrapper that launches several kernels (K3's backward, K5) gives one
invocation a launch; ``launch`` names the CUDA kernel as the profiler
records it, and ``chip_smoke.py`` holds the grid, block and shared
memory against the profiler's launch records on the card.

The RNG half checks the determinism contract of the port's sampling
noise (``serve/sampling.py``): a row of noise is a function of one
32-bit key that ``request_noise`` (seed, position) and ``act_noise``
(seed, round, step, env id) build by xor-and-mix.  Two coordinates
that map to one key draw the same noise, so the key must be injective
over each coordinate domain: it is enumerated and a collision is R101.
"""
from __future__ import annotations

import inspect
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, MAX_HEAD_DIM_BWD
from repro_torch.kernels.moe_gmm import decode_capacity
from repro_torch.kernels.paged_attention import split_plan
from repro_torch.kernels.ssd_scan import MAX_CHUNK, MAX_HEAD_DIM as SSD_MAX_P
from repro_torch.kernels.ssd_scan import MAX_STATE
from repro_torch.serve.sampling import _mix32
from repro_torch.train.parallel import local_heads
from repro_torch.utils.hardware import H100_SM_COUNT

PASS = "kernel"

# sm_90 launch limits
MAX_THREADS = 1024
MAX_GRID = (2**31 - 1, 65535, 65535)
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may opt into
MAX_CLUSTER = 8  # the portable cluster size
MAX_PAGED_GROUP = 64  # K1: query heads a KV head (a warp carries <= 16 rows)

_SIZE = {"float32": 4, "bfloat16": 2}


def _f(code: str, severity: str, subject: str, message: str,
       hint: str = "", pass_name: str = PASS) -> Finding:
    return Finding(code, severity, subject, message, hint, pass_name)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b) if b > 0 else 0


# ---------------------------------------------------------------------------
# Kernel invocation IR
# ---------------------------------------------------------------------------
@dataclass
class BlockMap:
    """The tile one thread block takes of one operand.  ``index_map``
    takes the block's grid ids (x, y, z) and gives tile indices; along
    the ``clipped`` dimensions the kernel bounds-checks its loads and
    stores, so a tile there may overhang the operand as long as it
    starts inside it."""
    name: str
    operand_shape: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    index_map: Callable[..., Tuple[int, ...]]
    clipped: Tuple[int, ...] = ()


@dataclass
class Divisibility:
    """A declared constraint the wrapper checks at run time."""
    label: str
    value: int
    divisor: int
    code: str = "K102"  # K106 for the GQA head-count constraint


@dataclass
class Bound:
    """A limit the wrapper or the C launcher enforces: ``value <= limit``."""
    label: str
    value: int
    limit: int


@dataclass
class KernelInvocation:
    kernel: str      # entry name in kernels/ops.py
    shape_name: str  # config-zoo shape this was evaluated at
    grid: Tuple[int, ...]
    block: Tuple[int, ...] = (1,)
    smem: int = 0    # dynamic shared memory, bytes
    cluster: Tuple[int, ...] = (1,)
    launch: str = ""  # the CUDA kernel's name
    operands: List[BlockMap] = field(default_factory=list)
    constraints: List[Divisibility] = field(default_factory=list)
    bounds: List[Bound] = field(default_factory=list)
    # (label, covered, needed): covered < needed -> K105
    coverage: Optional[Tuple[str, int, int]] = None

    @property
    def subject(self) -> str:
        name = f"{self.kernel}/{self.launch}" if self.launch else self.kernel
        return f"{name}@{self.shape_name}"


# ---------------------------------------------------------------------------
# Spec builders — each mirrors one wrapper and its C launcher
# ---------------------------------------------------------------------------
def _group(H: int, KV: int) -> int:
    return max(H // KV, 1) if KV > 0 else 1


def flash_invocation(shape_name: str, *, B: int, H: int, S: int, D: int,
                     KV: int, dtype: str = "bfloat16") -> KernelInvocation:
    """Mirrors ``flash_attention_bhsd`` -> ``flash_attention_fwd_launch``:
    a block per 64 query rows of one (b, h), grid (ceil(S / 64), H, B);
    bf16 runs ``flash_fwd_wgmma_kernel`` (a consumer warpgroup and a TMA
    producer warp, 160 threads; the Q tile and a 2-stage K/V ring of
    64-key tiles, each 128 bytes a 64-column block of the padded head
    dim), f32 ``flash_fwd_kernel`` (256 threads; Q, K, V tiles of
    D + 1 floats a row and a 64 x 65 score tile).  The block walks every
    key tile of its row, so it reads the whole (b, h // G) K/V head."""
    G = _group(H, KV)
    nq = _cdiv(S, 64)
    if dtype == "bfloat16":
        kdb = _cdiv(_cdiv(D, 16) * 16, 64)
        launch, block = "flash_fwd_wgmma_kernel", (160,)
        smem = 1024 + kdb * 128 * (64 + 2 * 2 * 64) + 8 * (1 + 4 * 2)
    else:
        launch, block = "flash_fwd_kernel", (256,)
        smem = 4 * ((64 + 2 * 64) * (D + 1) + 64 * 65)
    return KernelInvocation(
        kernel="flash_attention", shape_name=shape_name, launch=launch,
        grid=(nq, H, B), block=block, smem=smem,
        operands=[
            BlockMap("q", (B, H, S, D), (1, 1, 64, D),
                     lambda qi, h, b: (b, h, qi, 0), clipped=(2,)),
            BlockMap("k", (B, KV, S, D), (1, 1, S, D),
                     lambda qi, h, b, g=G: (b, h // g, 0, 0)),
            BlockMap("v", (B, KV, S, D), (1, 1, S, D),
                     lambda qi, h, b, g=G: (b, h // g, 0, 0)),
            BlockMap("o", (B, H, S, D), (1, 1, 64, D),
                     lambda qi, h, b: (b, h, qi, 0), clipped=(2,)),
        ],
        constraints=[Divisibility("H % num_kv_heads", H, KV, code="K106")],
        bounds=[Bound("head_dim (forward)", D, MAX_HEAD_DIM)])


def _bwd_pad_d(D: int) -> int:
    return 64 if D <= 64 else _cdiv(D, 16) * 16


def _bwd_head_groups(B: int, H: int, KV: int, key_blocks: int,
                     sm_count: int) -> int:
    """``head_groups`` of ``csrc/flash_attention_bwd.cu``: the fewest
    query-head groups (a divisor of G) that give two blocks an SM."""
    G = _group(H, KV)
    for g in range(1, G):
        if G % g == 0 and key_blocks * g * KV * B >= 2 * sm_count:
            return g
    return G


def _bwd_key_blocks(S: int, causal: bool) -> int:
    """``key_blocks``: launch 2's blocks along the keys, a key tile each
    or a causal pair."""
    nk = _cdiv(S, 64)
    return (nk + 1) // 2 if causal else nk


def _bwd_tiles(S: int, causal: bool, window: int) -> int:
    """``tiles_before(nq, S, causal, window)``: the live (query tile,
    key tile) pairs of one (b, h), each a 64 x 64 dS tile."""
    n = 0
    for i in range(_cdiv(S, 64)):
        q0 = 64 * i
        tb = (max(q0 - window + 1, 0) if window > 0 else 0) // 64
        te = _cdiv(min(S, q0 + 64) if causal else S, 64)
        n += te - tb
    return n


def flash_bwd_workspace(B: int, H: int, KV: int, S: int, D: int,
                        causal: bool = True, window: int = 0,
                        sm_count: int = H100_SM_COUNT) -> int:
    """``flash_attention_bwd_workspace`` of
    ``csrc/flash_attention_bwd.cu``, in floats: the dS tiles (4096
    floats each), delta (B, H, S), then two (B, KV, S, D) partials a
    query-head group when a KV head's heads are split into more than
    one."""
    if B < 1 or S < 1 or KV < 1 or H % KV:
        return 0
    groups = _bwd_head_groups(B, H, KV, _bwd_key_blocks(S, causal),
                              sm_count)
    return ((B * H * _bwd_tiles(S, causal, window) << 12) + B * H * S
            + (2 * groups * B * KV * S * D if groups > 1 else 0))


def flash_bwd_invocations(shape_name: str, *, B: int, H: int, S: int,
                          D: int, KV: int, causal: bool = True,
                          sm_count: int = H100_SM_COUNT
                          ) -> List[KernelInvocation]:
    """Mirrors ``flash_attention_bwd`` -> ``flash_attention_bwd_launch``
    (either type): ``flash_bwd_delta_kernel`` over the B H S rows, then
    ``flash_bwd_dkdv_kernel`` a block per key tile (a pair of them under
    a causal mask) and query-head group of each (kv head, b), then
    ``flash_bwd_sum_kernel`` when a KV head's heads are split into more
    than one group, then ``flash_bwd_dq_kernel`` a block per 64 query
    rows of each (b, h).  256 threads throughout; the product launches
    stage 64-row f32 tiles of D padded to 16 (64 below 64) + 4 floats."""
    G = _group(H, KV)
    nk = _cdiv(S, 64)
    key_blocks = _bwd_key_blocks(S, causal)
    groups = _bwd_head_groups(B, H, KV, key_blocks, sm_count)
    pitch = _bwd_pad_d(D) + 4
    nt = 4 if D <= 64 else (8 if D <= 128 else 12)
    dkdv_smem = 4 * (4 * 64 * pitch + (2 if nt <= 8 else 1) * 64 * 64 + 128)
    dq_smem = 4 * 2 * (64 * (64 + 4) + 64 * pitch)
    rows = B * H * S
    common = dict(kernel="flash_attention", shape_name=shape_name,
                  block=(256,))
    bound = [Bound("head_dim (backward)", D, MAX_HEAD_DIM_BWD)]
    gqa = [Divisibility("H % num_kv_heads", H, KV, code="K106")]
    hg = max(G // max(groups, 1), 1)
    out = [
        KernelInvocation(
            launch="flash_bwd_delta_kernel", grid=(_cdiv(rows, 256), 1, 1),
            operands=[BlockMap("o", (rows, D), (256, D),
                               lambda i, y, z: (i, 0), clipped=(0,))],
            bounds=bound, **common),
        KernelInvocation(
            launch="flash_bwd_dkdv_kernel",
            grid=(key_blocks, KV * groups, B), smem=dkdv_smem,
            operands=[
                BlockMap("k", (B, KV, S, D), (1, 1, 64, D),
                         lambda kb, y, b, gr=groups: (b, y // gr, kb, 0),
                         clipped=(2,)),
                BlockMap("q", (B, H, S, D), (1, hg, S, D),
                         lambda kb, y, b: (b, y, 0, 0)),
            ],
            constraints=gqa, bounds=bound, **common),
    ]
    if groups > 1:
        n = B * KV * S * D
        out.append(KernelInvocation(
            launch="flash_bwd_sum_kernel",
            grid=(min(_cdiv(n, 256), 16 * sm_count), 1, 1), bounds=bound,
            **common))
    out.append(KernelInvocation(
        launch="flash_bwd_dq_kernel", grid=(nk, H, B), smem=dq_smem,
        operands=[
            BlockMap("dq", (B, H, S, D), (1, 1, 64, D),
                     lambda qi, h, b: (b, h, qi, 0), clipped=(2,)),
            BlockMap("k", (B, KV, S, D), (1, 1, S, D),
                     lambda qi, h, b, g=G: (b, h // g, 0, 0)),
        ],
        constraints=gqa, bounds=bound, **common))
    return out


def tensor_parallel_flash_invocations(
        shape_name: str, *, B: int, H: int, S: int, D: int, KV: int,
        model: int, dtype: str = "float32", backward: bool = True,
        causal: bool = True,
        sm_count: int = H100_SM_COUNT) -> List[KernelInvocation]:
    """K3's forward (and backward) launches on one model rank of a layout
    that splits ``H`` query heads over ``model`` ranks: the rank's local
    heads and the KV heads they read (``train.parallel.local_heads``;
    when ``KV % model != 0`` the rules keep ``wk``/``wv`` whole and the
    rank slices the ones its queries map to); ``causal=False`` for an
    encoder's bidirectional attention.  The kernel maps local head j to
    local KV head ``j // (H_loc / KV_loc)``, the global map only when
    the local heads cover whole groups of G = H / KV or lie inside one:
    any other split is K106 (the layout raises there)."""
    h, kv = local_heads(H, KV, model)
    name = f"{shape_name}@model{model}"
    out = [flash_invocation(name, B=B, H=h, S=S, D=D, KV=kv, dtype=dtype)]
    if backward:
        out += flash_bwd_invocations(name, B=B, H=h, S=S, D=D, KV=kv,
                                     causal=causal, sm_count=sm_count)
    if h != H:
        G = H // KV
        local_map = Divisibility(
            f"local query heads ({h}) against groups of H / KV ({G}): "
            f"whole groups or one group a rank", max(h, G), min(h, G),
            code="K106")
        for inv in out:
            inv.constraints = inv.constraints + [local_map]
    return out


YI_TP_HEADS = (32, 4, 128)  # yi-9b's (H, KV, head_dim)
TP_MODEL_AXES = (2, 4, 8)
# the train step's other kernels on a model rank: K6 and its backward at
# mamba2's and zamba2's (SSM heads, head_dim, state), K3 bidirectional at
# whisper-large-v3's encoder (H, KV, head_dim) over its 1500 frames
SSM_TP_HEADS = {"mamba2-370m": (32, 64, 128), "zamba2-2.7b": (80, 64, 64)}
WHISPER_ENCODER = ((20, 20, 64), 1500)
SPLIT_MODEL_AXES = (2, 4)


def tensor_parallel_ssd_invocations(
        shape_name: str, *, B: int, L: int, H: int, P: int, N: int,
        chunk: int, model: int, dtype: str = "float32",
        backward: bool = True) -> List[KernelInvocation]:
    """K6's forward (and backward) launches on one model rank of a layout
    that splits a Mamba2 mixer's ``H`` SSM heads over ``model`` ranks
    (``models.ssm._local_heads``): H / model heads, B and C whole.  A
    model axis that does not divide the heads is K106 (the layout raises
    there)."""
    h = H // model if H % model == 0 else H
    name = f"{shape_name}@model{model}"
    out = [ssd_invocation(name, B=B, L=L, H=h, P=P, N=N, chunk=chunk,
                          dtype=dtype)]
    if backward:
        out.append(ssd_invocation(name, B=B, L=L, H=h, P=P, N=N,
                                  chunk=chunk, dtype=dtype, backward=True))
    heads = Divisibility(f"SSM heads ({H}) over the model axis ({model})",
                         H, model, code="K106")
    for inv in out:
        inv.constraints = inv.constraints + [heads]
    return out


def paged_invocation(shape_name: str, *, B: int, H: int, D: int, P: int,
                     page: int, KV: int, nb: int, max_context: int,
                     table_max: Optional[int] = None,
                     dtype: str = "bfloat16") -> KernelInvocation:
    """Mirrors ``paged_attention_bhd`` -> ``paged_attention_bhd_launch``:
    a cluster of up to 8 blocks (the splits of ``split_plan``) for each
    (kv head, b), a warp a query row up to 4, a 2-stage ring of K and V
    tiles of 32 tokens (rows of D + 16 bytes' worth) and the f32 q rows
    and partials.  ``table_max`` models the largest page id a block
    table can hold (defaults to the pool's last page, P - 1 — the
    allocator's worst case)."""
    G = _group(H, KV)
    tmax = (P - 1) if table_max is None else table_max
    tile, n_split = split_plan(nb, page)
    size = _SIZE[dtype]
    pitch = D + 16 // size
    smem = 2 * 2 * tile * pitch * size + 4 * (2 * G * D + 2 * G)
    return KernelInvocation(
        kernel="paged_attention", shape_name=shape_name,
        launch="paged_attention_kernel", grid=(n_split, KV, B),
        block=(32 * min(4, G),), smem=smem, cluster=(n_split, 1, 1),
        operands=[
            BlockMap("q", (B, KV, G, D), (1, 1, G, D),
                     lambda r, kv, b: (b, kv, 0, 0)),
            BlockMap("k_pages", (P, page, KV, D), (1, page, 1, D),
                     lambda r, kv, b, t=tmax: (t, 0, kv, 0)),
            BlockMap("v_pages", (P, page, KV, D), (1, page, 1, D),
                     lambda r, kv, b, t=tmax: (t, 0, kv, 0)),
            BlockMap("o", (B, KV, G, D), (1, 1, G, D),
                     lambda r, kv, b: (b, kv, 0, 0)),
        ],
        constraints=[
            Divisibility("H % num_kv_heads", H, KV, code="K106"),
            Divisibility("head_dim % 8", D, 8),
        ],
        bounds=[Bound("query heads a KV head", G, MAX_PAGED_GROUP),
                Bound("head_dim", D, 256)],
        coverage=("block_table pages * page_size vs max context",
                  nb * page, max_context))


def ssd_invocation(shape_name: str, *, B: int, L: int, H: int, P: int,
                   N: int, chunk: int, dtype: str = "bfloat16",
                   backward: bool = False) -> KernelInvocation:
    """Mirrors ``ops.ssd_scan`` -> ``ssd_scan_fwd_launch`` (or, with
    ``backward``, ``ssd_scan_bwd_launch``): L padded to a multiple of
    ``chunk``, then a cluster of min(chunks, 8) blocks of 256 threads for
    each (h, b) that walks the row's chunks in windows of 8.  The shared
    memory is laid out for the largest chunk whatever the chunk is."""
    nc = _cdiv(L, chunk)
    cl = min(nc, 8)
    if backward:
        launch, smem = "ssd_bwd_tf32_kernel", 231552
    elif dtype == "bfloat16":
        launch, smem = "ssd_fwd_mma_kernel", 106512
    else:
        launch, smem = "ssd_fwd_tf32_kernel", 192528
    return KernelInvocation(
        kernel="ssd_scan", shape_name=shape_name, launch=launch,
        grid=(cl, H, B), block=(256,), smem=smem, cluster=(cl, 1, 1),
        operands=[
            BlockMap("x", (B, H, nc, chunk, P), (1, 1, 1, chunk, P),
                     lambda c, h, b: (b, h, c, 0, 0)),
            BlockMap("dt", (B, H, nc, chunk), (1, 1, 1, chunk),
                     lambda c, h, b: (b, h, c, 0)),
            BlockMap("Bm", (B, nc, chunk, N), (1, 1, chunk, N),
                     lambda c, h, b: (b, c, 0, 0)),
            BlockMap("Cm", (B, nc, chunk, N), (1, 1, chunk, N),
                     lambda c, h, b: (b, c, 0, 0)),
            BlockMap("y", (B, H, nc, chunk, P), (1, 1, 1, chunk, P),
                     lambda c, h, b: (b, h, c, 0, 0)),
        ],
        bounds=[Bound("chunk", chunk, MAX_CHUNK),
                Bound("head_dim", P, SSD_MAX_P),
                Bound("state size", N, MAX_STATE)])


def gmm_invocation(shape_name: str, *, E: int, C: int, D: int, F: int,
                   dtype: str = "bfloat16", gated: bool = False
                   ) -> KernelInvocation:
    """Mirrors ``grouped_matmul`` -> ``grouped_matmul_launch``: per-expert
    (C, D) @ (D, F) in blocks of 64 output columns; bf16 runs
    ``gmm_mma_kernel`` (128 threads, up to 64 rows a block, a 3-stage ring
    of 64-deep weight tiles (two when gated) and activation rows), f32
    ``gmm_kernel`` (128 threads, 8 or 32 rows a block, static shared
    memory)."""
    if dtype == "bfloat16":
        bm = 64
        rows = min(_cdiv(C, 8) * 8, 64)
        smem = 3 * ((2 if gated else 1) * 64 * 64 * 2 + rows * 64 * 2)
        launch = "gmm_mma_kernel"
    else:
        bm = 8 * (1 if C <= 16 else 4)
        smem, launch = 0, "gmm_kernel"
    return KernelInvocation(
        kernel="grouped_matmul", shape_name=shape_name, launch=launch,
        grid=(_cdiv(C, bm), _cdiv(F, 64), E), block=(128,), smem=smem,
        operands=[
            BlockMap("buf", (E, C, D), (1, bm, D),
                     lambda ci, fi, e: (e, ci, 0), clipped=(1,)),
            BlockMap("w", (E, D, F), (1, D, 64),
                     lambda ci, fi, e: (e, 0, fi), clipped=(2,)),
            BlockMap("out", (E, C, F), (1, bm, 64),
                     lambda ci, fi, e: (e, ci, fi), clipped=(1, 2)),
        ])


def moe_decode_invocation(shape_name: str, *, T: int, E: int, d: int,
                          f: int, k: int = 8, dtype: str = "bfloat16"
                          ) -> List[KernelInvocation]:
    """Mirrors ``moe_decode`` -> ``moe_decode_gmm``: the T k assignments
    gather into an (E, C, d) buffer with C = decode_capacity(T)
    (``moe_dispatch_kernel``, 8 assignments a block of 256 threads), then
    grouped GEMMs — gate/up fused at (E, C, d) @ (E, d, f) and down at
    (E, C, f) @ (E, f, d) — then ``moe_combine_kernel`` a block per
    token and 256 columns."""
    C = decode_capacity(T)
    n = T * k
    dispatch = KernelInvocation(
        kernel="moe_decode", shape_name=shape_name,
        launch="moe_dispatch_kernel", grid=(_cdiv(n, 8), 1, 1),
        block=(256,), smem=(8 * E + E + 8) * 4,
        operands=[BlockMap("x", (T, d), (1, d),
                           lambda i, y, z, t=T: (min(8 * i, t - 1), 0))])
    up = gmm_invocation(shape_name, E=E, C=C, D=d, F=f, dtype=dtype,
                        gated=True)
    down = gmm_invocation(shape_name, E=E, C=C, D=f, F=d, dtype=dtype)
    combine = KernelInvocation(
        kernel="moe_decode", shape_name=shape_name,
        launch="moe_combine_kernel", grid=(T, _cdiv(d, 256), 1),
        block=(256,),
        operands=[BlockMap("y", (T, d), (1, 256),
                           lambda t, c, z: (t, c), clipped=(1,))])
    for inv in (up, down):
        inv.kernel = "moe_decode"
    return [dispatch, up, down, combine]


def sampling_invocation(shape_name: str, *, B: int, V: int
                        ) -> KernelInvocation:
    """Mirrors ``fused_sample`` -> ``fused_sample_bv_launch``: a cluster
    of 8 blocks of 512 threads a row, each holding a slice of
    ceil(V / 8) logits (rounded up to 4) and its Gumbel noise in shared
    memory; (B,) token and logprob outs."""
    per = _cdiv(_cdiv(V, 8), 4) * 4
    return KernelInvocation(
        kernel="fused_sample", shape_name=shape_name,
        launch="fused_sample_kernel", grid=(8, B, 1), block=(512,),
        smem=2 * 4 * per, cluster=(8, 1, 1),
        operands=[
            BlockMap("logits", (B, V), (1, per), lambda r, b, _: (b, r),
                     clipped=(1,)),
            BlockMap("gumbel", (B, V), (1, per), lambda r, b, _: (b, r),
                     clipped=(1,)),
            BlockMap("token", (B, 1), (1, 1), lambda r, b, _: (b, 0)),
            BlockMap("lp", (B, 1), (1, 1), lambda r, b, _: (b, 0)),
        ])


def ssm_update_invocation(shape_name: str, *, B: int, H: int, P: int,
                          N: int) -> KernelInvocation:
    """Mirrors ``ssm_state_update`` -> ``ssm_state_update_launch``: grid
    (H, B), 256 threads over one full (P, N) state tile, B and C rows
    (2 N floats) in shared memory."""
    return KernelInvocation(
        kernel="ssm_state_update", shape_name=shape_name,
        launch="ssm_update_kernel", grid=(H, B, 1), block=(256,),
        smem=2 * 4 * N,
        operands=[
            BlockMap("state", (B, H, P, N), (1, 1, P, N),
                     lambda h, b, _: (b, h, 0, 0)),
            BlockMap("x", (B, H, P), (1, 1, P), lambda h, b, _: (b, h, 0)),
            BlockMap("dt", (B, H), (1, 1), lambda h, b, _: (b, h)),
            BlockMap("Bm", (B, N), (1, N), lambda h, b, _: (b, 0)),
            BlockMap("Cm", (B, N), (1, N), lambda h, b, _: (b, 0)),
            BlockMap("y", (B, H, P), (1, 1, P), lambda h, b, _: (b, h, 0)),
            BlockMap("new_state", (B, H, P, N), (1, 1, P, N),
                     lambda h, b, _: (b, h, 0, 0)),
        ])


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def _launch_limits(inv: KernelInvocation) -> List[Finding]:
    """K102 for a launch sm_90 refuses."""
    out: List[Finding] = []
    subject = inv.subject

    def bad(msg: str, hint: str) -> None:
        out.append(_f("K102", "error", subject, msg, hint))

    threads = _prod(inv.block)
    if threads > MAX_THREADS:
        bad(f"{threads} threads a block (at most {MAX_THREADS})",
            "split the block's work over more blocks")
    for i, (n, top) in enumerate(zip(inv.grid, MAX_GRID)):
        if n > top:
            bad(f"grid dimension {i} has extent {n} (at most {top})",
                "fold the excess into grid x")
    if inv.smem > MAX_SMEM:
        bad(f"{inv.smem} bytes of dynamic shared memory (at most "
            f"{MAX_SMEM})", "shrink the block's tiles")
    size = _prod(inv.cluster)
    if size > MAX_CLUSTER:
        bad(f"a cluster of {size} blocks (at most {MAX_CLUSTER})",
            "walk the extra blocks' work in windows of 8")
    elif size > 1 and any(n % c for n, c in zip(inv.grid, inv.cluster)):
        bad(f"cluster {inv.cluster} does not divide grid {inv.grid}",
            "size the grid in whole clusters")
    return out


def check_invocation(inv: KernelInvocation) -> List[Finding]:
    out: List[Finding] = []
    subject = inv.subject

    for i, n in enumerate(inv.grid):
        if n <= 0:
            out.append(_f(
                "K101", "error", subject,
                f"grid dimension {i} has extent {n}",
                "every grid axis needs at least one block"))
    for c in inv.constraints:
        if c.divisor <= 0 or c.value % c.divisor:
            if c.code == "K106":
                msg = (f"GQA requires {c.label} == 0, got "
                       f"{c.value} % {c.divisor}")
                hint = ("query heads must be an integer multiple of KV "
                        "heads — the K/V index map computes h // (H//KV)")
            else:
                msg = (f"{c.label} != 0 ({c.value} % {c.divisor}) — the "
                       f"wrapper would raise")
                hint = "pick a size the kernel takes at this shape"
            out.append(_f(c.code, "error", subject, msg, hint))
    for b in inv.bounds:
        if b.value > b.limit:
            out.append(_f(
                "K102", "error", subject,
                f"{b.label} {b.value} past the kernel's limit {b.limit} — "
                f"the wrapper would raise", "use a shape the kernel takes"))
    out.extend(_launch_limits(inv))
    for op in inv.operands:
        for d, (blk, dim) in enumerate(zip(op.block_shape,
                                           op.operand_shape)):
            if blk > dim and d not in op.clipped:
                out.append(_f(
                    "K103", "error", f"{subject}:{op.name}",
                    f"block shape {op.block_shape} exceeds operand "
                    f"shape {op.operand_shape} in dim {d} "
                    f"({blk} > {dim})",
                    "clamp the tile to min(tile, dim) or clip its loads"))
    if not any(f.code in ("K101", "K103") for f in out):
        out.extend(_check_index_maps(inv))
    if inv.coverage is not None:
        label, covered, needed = inv.coverage
        if covered < needed:
            out.append(_f(
                "K105", "error", subject,
                f"{label}: {covered} < {needed} — decode steps past "
                f"position {covered} address past the block table",
                "size the table at ceil(max_seq_len / page_size) pages "
                "(PagedEngine.max_blocks does this)"))
    return out


def _check_index_maps(inv: KernelInvocation) -> List[Finding]:
    """Evaluate each index map at every grid corner and check the tile
    it selects stays inside the operand (starts inside it along a
    clipped dimension).  Corner evaluation is exact here because every
    index map is monotone in each grid id (affine, floor-div, or a
    table lookup modeled at its max)."""
    out: List[Finding] = []
    corners = list(itertools.product(*([0, n - 1] if n > 1 else [0]
                                       for n in inv.grid)))
    for op in inv.operands:
        for ids in corners:
            idx = op.index_map(*ids)
            oob = next((
                (d, i * blk, i * blk + blk)
                for d, (i, blk, dim) in enumerate(zip(idx, op.block_shape,
                                                      op.operand_shape))
                if i * blk < 0 or (i * blk >= dim if d in op.clipped
                                   else i * blk + blk > dim)), None)
            if oob is None:
                continue
            d, lo, hi = oob
            out.append(_f(
                "K104", "error", f"{inv.subject}:{op.name}",
                f"index map at grid point {ids} selects "
                f"[{lo}:{hi}) in dim {d} of operand shape "
                f"{op.operand_shape} (out of bounds)",
                "the index map must keep idx*block + block "
                "within the operand at every grid point"))
            break  # first offending corner per operand is enough
    return out


def default_invocations(sm_count: int = H100_SM_COUNT
                        ) -> List[KernelInvocation]:
    """The clean registry: every ops.py kernel at every config-zoo shape
    it serves, with JAX's representative 7B-class model dimensions (heads
    and widths match the qwen-family configs; SSD dims match mamba2).
    Serving runs bf16; the train shape runs the f32 train step, forward
    and backward."""
    H, KV, D = 28, 4, 128            # dense/GQA attention dims
    ssd_H, ssd_P, ssd_N = 24, 64, 128  # mamba2 heads / head_dim / state
    page = 16                        # PagedEngine default page_size
    vocab = 151_936                  # qwen-family padded vocab width
    out: List[KernelInvocation] = []
    for name, sc in SHAPES.items():
        S, B = sc.seq_len, sc.global_batch
        if sc.phase == "decode":
            nb = -(-S // page)
            out.append(paged_invocation(
                name, B=B, H=H, D=D, P=B * nb + 1, page=page, KV=KV,
                nb=nb, max_context=S))
            # the fused sampler runs back-to-back with paged attention
            # on every decode step, same batch extent
            out.append(sampling_invocation(name, B=B, V=vocab))
            # per-arch decode paths through the state / MoE cache
            # layouts: constant-size SSD state update (mamba2 dims) and
            # the drop-free MoE FFN (granite-moe dims: 40 experts, top 8,
            # d_model 1536, expert d_ff 512, T = B tokens)
            out.append(ssm_update_invocation(
                name, B=B, H=ssd_H, P=ssd_P, N=ssd_N))
            out.extend(moe_decode_invocation(
                name, T=B, E=40, d=1536, f=512))
        else:
            dtype = "float32" if sc.phase == "train" else "bfloat16"
            out.append(flash_invocation(
                name, B=min(B, 8), H=H, S=S, D=D, KV=KV, dtype=dtype))
            out.append(ssd_invocation(
                name, B=min(B, 8), L=S, H=ssd_H, P=ssd_P, N=ssd_N,
                chunk=128, dtype=dtype))
            if sc.phase == "train":
                out.extend(flash_bwd_invocations(
                    name, B=min(B, 8), H=H, S=S, D=D, KV=KV,
                    sm_count=sm_count))
                out.append(ssd_invocation(
                    name, B=min(B, 8), L=S, H=ssd_H, P=ssd_P, N=ssd_N,
                    chunk=128, dtype=dtype, backward=True))
    # MoE FFN hot-spot at the train shape: 8 experts, top-2, capacity
    # ceil(4096 * 2 / 8 * 1.25) = 1280 dispatched tokens per expert
    out.append(gmm_invocation("train_4k", E=8, C=1280, D=2048, F=5632))
    # the f32 train step's K3 on a tensor-parallel rank of yi-9b's heads
    # (the launcher's model axis): 16 / 2, 8 / 1 and 4 / 1 (KV whole)
    sc = SHAPES["train_4k"]
    H, KV, D = YI_TP_HEADS
    for model in TP_MODEL_AXES:
        out.extend(tensor_parallel_flash_invocations(
            "train_4k/yi-9b", B=min(sc.global_batch, 8), H=H, S=sc.seq_len,
            D=D, KV=KV, model=model, sm_count=sm_count))
    # and K6 with its backward at the SSM archs' local heads, K3
    # bidirectional at whisper's encoder's
    (H, KV, D), S = WHISPER_ENCODER
    for model in SPLIT_MODEL_AXES:
        for arch, (Hs, P, N) in SSM_TP_HEADS.items():
            out.extend(tensor_parallel_ssd_invocations(
                f"train_4k/{arch}", B=min(sc.global_batch, 8),
                L=sc.seq_len, H=Hs, P=P, N=N, chunk=128, model=model))
        out.extend(tensor_parallel_flash_invocations(
            "whisper-large-v3/encoder-train", B=min(sc.global_batch, 8),
            H=H, S=S, D=D, KV=KV, model=model, causal=False,
            sm_count=sm_count))
    return out


def flash_bwd_shapes() -> List[Tuple[int, int, int, int, int, bool, int]]:
    """(B, H, KV, S, D, causal, window) of every K3 backward launch that
    :func:`default_invocations` lints: the train shape, yi-9b's heads on
    a tensor-parallel rank and whisper's encoder's, bidirectional.  The
    card checks ``flash_attention_bwd_workspace`` against
    :func:`flash_bwd_workspace` at these."""
    sc = SHAPES["train_4k"]
    B, S = min(sc.global_batch, 8), sc.seq_len
    out = [(B, 28, 4, S, 128, True, 0)]
    H, KV, D = YI_TP_HEADS
    out += [(B, *local_heads(H, KV, m), S, D, True, 0)
            for m in TP_MODEL_AXES]
    (H, KV, D), frames = WHISPER_ENCODER
    out += [(B, *local_heads(H, KV, m), frames, D, False, 0)
            for m in SPLIT_MODEL_AXES]
    return out


def check_registry_coverage(
        invocations: Sequence[KernelInvocation]) -> List[Finding]:
    """K107 — every public kernel entry in ``kernels/ops.py`` must have
    at least one lint spec, or new kernels silently escape Pass 3."""
    from repro_torch.kernels import ops as _ops
    covered = {inv.kernel for inv in invocations}
    out: List[Finding] = []
    for name, fn in inspect.getmembers(_ops, inspect.isfunction):
        if name.startswith("_") or fn.__module__ != _ops.__name__:
            continue
        if name not in covered:
            out.append(_f(
                "K107", "warning", name,
                f"kernel entry ops.{name} has no KernelInvocation spec "
                f"— Pass 3 cannot check it",
                "add a spec builder mirroring the wrapper's launch math "
                "to analysis.kernel_checks"))
    return out


def check_kernels(
        invocations: Optional[Sequence[KernelInvocation]] = None
) -> List[Finding]:
    invs = list(default_invocations() if invocations is None
                else invocations)
    out: List[Finding] = []
    for inv in invs:
        out.extend(check_invocation(inv))
    out.extend(check_registry_coverage(invs))
    return out


# ---------------------------------------------------------------------------
# RNG determinism lint
# ---------------------------------------------------------------------------
@dataclass
class RNGKeySpec:
    """One noise-keying scheme.  ``combine`` is either the string
    ``"nested"`` (a scheme whose identity is the coordinate tuple itself,
    injective by construction) or a callable collapsing the coordinates
    into one key, checked for collisions by enumeration.  The callable
    is applied elementwise to int64 tensors of every point at once, so
    it must be arithmetic that broadcasts (as the port's hash does)."""
    name: str
    coords: Tuple[str, ...]
    domain: Dict[str, range]
    combine: Union[str, Callable[..., Any]] = "nested"


def request_key(seed, position):
    """The 32-bit key of ``serve.sampling.request_noise``'s row for the
    token at ``position`` of the request seeded ``seed``."""
    return _mix32(_mix32(seed) ^ position)


def act_key(seed, rollout_round, cycle_step, env_id):
    """The key of ``serve.sampling.act_noise``'s row for env ``env_id``
    at (``rollout_round``, ``cycle_step``) under the act path's base
    ``seed``: the row seed folds the round and the step, the env id is
    the position."""
    row = seed
    for v in (rollout_round, cycle_step):
        row = _mix32(_mix32(row) ^ v)
    return request_key(row, env_id)


def default_rng_specs() -> List[RNGKeySpec]:
    """JAX's two schemes over JAX's domains, with the port's keys: the
    act path at a fixed base seed (``RolloutWorker``'s seed ^ 0x5EED at
    seed 0) and the paged sampler's (seed, position)."""
    return [
        RNGKeySpec("rollout_act", ("rollout_round", "cycle_step", "env_id"),
                   {"rollout_round": range(4), "cycle_step": range(64),
                    "env_id": range(64)},
                   combine=lambda r, s, e: act_key(0x5EED, r, s, e)),
        RNGKeySpec("paged_sampler", ("seed", "position"),
                   {"seed": range(16), "position": range(256)},
                   combine=request_key),
    ]


_MAX_ENUM = 1_000_000


def _first_collision(keys: List[int]) -> Optional[Tuple[int, int]]:
    seen: Dict[int, int] = {}
    for j, k in enumerate(keys):
        if k in seen:
            return seen[k], j
        seen[k] = j
    return None


def check_rng(specs: Optional[Sequence[RNGKeySpec]] = None
              ) -> List[Finding]:
    out: List[Finding] = []
    for spec in (default_rng_specs() if specs is None else specs):
        subject = spec.name
        missing = [c for c in spec.coords if c not in spec.domain]
        if missing:
            out.append(_f(
                "R101", "warning", subject,
                f"no enumeration domain declared for coordinate(s) "
                f"{missing} — collision check skipped",
                "declare a bounded range per coordinate",
                pass_name="rng"))
            continue
        if spec.combine == "nested":
            # the identity IS the coordinate tuple, unique by construction
            continue
        total = 1
        for c in spec.coords:
            total *= max(len(spec.domain[c]), 1)
        if total > _MAX_ENUM:
            out.append(_f(
                "R101", "warning", subject,
                f"domain too large to enumerate ({total} points)",
                "shrink the declared domain to a representative bound",
                pass_name="rng"))
            continue
        points = list(itertools.product(
            *(spec.domain[c] for c in spec.coords)))
        if not points:
            continue
        cols = torch.tensor(points, dtype=torch.int64).unbind(1)
        keys = torch.as_tensor(spec.combine(*cols)).reshape(-1).tolist()
        hit = _first_collision(keys)
        if hit is not None:
            i, j = hit
            a = dict(zip(spec.coords, points[i]))
            b = dict(zip(spec.coords, points[j]))
            out.append(_f(
                "R101", "error", subject,
                f"noise key collision: {a} and {b} both key to "
                f"{keys[j]!r} — two logically distinct draws share a "
                f"noise row, breaking the bit-identical chunking "
                f"guarantee",
                "mix each coordinate into the key in turn instead of "
                "combining coordinates arithmetically",
                pass_name="rng"))
    return out

