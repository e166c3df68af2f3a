"""The port's flowlint Pass 3 (``repro_torch.analysis.kernel_checks``)
against the JAX package's: the registry at the config-zoo shapes is
clean in both, every JAX invocation has its port counterpart at the same
shape, JAX's defect cases give the same codes on the port's launches,
the CUDA-only preconditions (head_dim, heads a KV head, threads, grid,
shared memory, clusters) are K102, the coverage check and the RNG half
behave as JAX's, the lint's noise keys are the ones ``request_noise``
and ``act_noise`` hash, and ``python -m repro_torch.analysis`` runs all
three passes."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.analysis.kernel_checks as jk
import repro_torch.analysis as ta
import repro_torch.analysis.kernel_checks as tk
from repro_torch.serve.sampling import _mix32, act_noise, request_noise

ROOT = Path(__file__).resolve().parents[1]


def codes(findings):
    return {f.code for f in findings}


def _env() -> dict:
    """A minimal environment for a subprocess, one intra-op thread."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1"}
    for var in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):
        if var in os.environ:
            env[var] = os.environ[var]
    return env


def test_registry_is_clean_in_both_packages():
    assert tk.check_kernels() == [] and tk.check_rng() == []
    assert jk.check_kernels() == [] and jk.check_rng() == []


def test_every_jax_invocation_has_a_port_launch_at_its_shape():
    port = {(i.kernel, i.shape_name) for i in tk.default_invocations()}
    jax_ = {(i.kernel, i.shape_name) for i in jk.default_invocations()}
    assert jax_ <= port
    # the port's extra launches are its backward kernels at the train shape
    assert {k for k, _ in port} == {k for k, _ in jax_}


@pytest.mark.parametrize("inv", tk.default_invocations(),
                         ids=lambda i: i.subject)
def test_each_default_launch_is_clean_and_within_sm90(inv):
    assert tk.check_invocation(inv) == []
    assert len(inv.grid) == 3 and inv.launch
    assert 1 <= inv.block[0] <= 1024 and inv.smem <= 227 * 1024


def test_k101_degenerate_grid():
    inv = tk.KernelInvocation(kernel="toy", shape_name="t", grid=(4, 0, 1))
    assert codes(tk.check_invocation(inv)) == {"K101"}
    j = jk.KernelInvocation(kernel="toy", shape_name="t", grid=(4, 0))
    assert codes(jk.check_invocation(j)) == {"K101"}
    # a zero batch at the flash wrapper, as JAX's case
    for fs in (tk.check_invocation(tk.flash_invocation(
                   "t", B=0, H=28, S=4096, D=128, KV=4)),
               jk.check_invocation(jk.flash_invocation(
                   "t", B=0, H=28, S=4096, D=128, KV=4))):
        assert "K101" in codes(fs) and codes(fs) <= {"K101", "K103"}


def test_ragged_lengths_are_no_k102_on_the_port():
    """JAX's flash blocks must divide S (K102 at S=100 with 64-blocks);
    the CUDA kernels clip their last tile, and ``ops.ssd_scan`` pads L."""
    assert codes(jk.check_invocation(jk.flash_invocation(
        "t", B=2, H=28, S=100, D=128, KV=4, block_q=64, block_k=64,
        clamp=False))) == {"K102"}
    assert codes(jk.check_invocation(jk.ssd_invocation(
        "t", B=2, L=1000, H=24, P=64, N=128, chunk=128))) == {"K102"}
    for dtype in ("float32", "bfloat16"):
        assert tk.check_invocation(tk.flash_invocation(
            "t", B=2, H=28, S=100, D=128, KV=4, dtype=dtype)) == []
        assert tk.check_invocation(tk.ssd_invocation(
            "t", B=2, L=1000, H=24, P=64, N=128, chunk=128,
            dtype=dtype)) == []
    assert tk.ssd_invocation("t", B=2, L=1000, H=24, P=64, N=128,
                             chunk=128).grid == (8, 24, 2)


@pytest.mark.parametrize("case", [
    "flash_d264", "flash_bwd_d200", "paged_d100", "paged_g65",
    "paged_smem", "ssd_chunk", "ssd_p", "ssd_n", "sample_rows",
    "threads", "cluster9", "cluster_divides"])
def test_k102_wrapper_and_launch_preconditions(case):
    inv = {
        "flash_d264": lambda: tk.flash_invocation(
            "t", B=1, H=8, S=64, D=264, KV=8),
        "paged_d100": lambda: tk.paged_invocation(
            "t", B=1, H=8, D=100, P=9, page=16, KV=8, nb=8, max_context=128),
        "paged_g65": lambda: tk.paged_invocation(
            "t", B=1, H=65, D=64, P=9, page=16, KV=1, nb=8, max_context=128),
        "paged_smem": lambda: tk.paged_invocation(
            "t", B=1, H=64, D=256, P=9, page=32, KV=1, nb=8,
            max_context=256, dtype="float32"),
        "ssd_chunk": lambda: tk.ssd_invocation(
            "t", B=1, L=512, H=4, P=64, N=128, chunk=256),
        "ssd_p": lambda: tk.ssd_invocation(
            "t", B=1, L=512, H=4, P=80, N=128, chunk=128),
        "ssd_n": lambda: tk.ssd_invocation(
            "t", B=1, L=512, H=4, P=64, N=256, chunk=128),
        "sample_rows": lambda: tk.sampling_invocation("t", B=70000, V=4096),
        "threads": lambda: tk.KernelInvocation(
            kernel="toy", shape_name="t", grid=(1, 1, 1), block=(2048,)),
        "cluster9": lambda: tk.KernelInvocation(
            kernel="toy", shape_name="t", grid=(9, 1, 1), cluster=(9, 1, 1)),
        "cluster_divides": lambda: tk.KernelInvocation(
            kernel="toy", shape_name="t", grid=(6, 1, 1), cluster=(4, 1, 1)),
    }.get(case)
    if case == "flash_bwd_d200":
        fs = [f for i in tk.flash_bwd_invocations(
            "t", B=1, H=8, S=64, D=200, KV=8) for f in tk.check_invocation(i)]
    else:
        fs = tk.check_invocation(inv())
    assert codes(fs) == {"K102"}, fs
    assert all(f.severity == "error" for f in fs)


def test_k103_block_exceeds_operand():
    for mod in (tk, jk):
        inv = mod.KernelInvocation(
            kernel="toy", shape_name="t", grid=(1, 1, 1),
            operands=[mod.BlockMap("a", (4,), (8,), lambda *i: (0,))])
        assert codes(mod.check_invocation(inv)) == {"K103"}
    # a clipped dimension may overhang, as the kernels' tails do
    inv = tk.KernelInvocation(
        kernel="toy", shape_name="t", grid=(1, 1, 1),
        operands=[tk.BlockMap("a", (4,), (8,), lambda *i: (0,),
                              clipped=(0,))])
    assert tk.check_invocation(inv) == []


def test_k104_index_map_out_of_bounds():
    # a block table holding a page id one past the pool
    for mod in (tk, jk):
        fs = mod.check_invocation(mod.paged_invocation(
            "t", B=2, H=28, D=128, P=64, page=16, KV=4, nb=8,
            max_context=128, table_max=64))
        assert codes(fs) == {"K104"}
        assert {f.subject.split(":")[-1] for f in fs} == {"k_pages",
                                                          "v_pages"}
    # a clipped tile must still start inside its operand
    inv = tk.KernelInvocation(
        kernel="toy", shape_name="t", grid=(3, 1, 1),
        operands=[tk.BlockMap("a", (100,), (64,), lambda i, *_: (i,),
                              clipped=(0,))])
    assert codes(tk.check_invocation(inv)) == {"K104"}


def test_k105_page_table_too_short():
    for mod in (tk, jk):
        assert codes(mod.check_invocation(mod.paged_invocation(
            "t", B=2, H=28, D=128, P=64, page=16, KV=4, nb=4,
            max_context=128))) == {"K105"}


def test_k106_gqa_head_mismatch():
    for mod in (tk, jk):
        fs = mod.check_invocation(mod.flash_invocation(
            "t", B=2, H=30, S=4096, D=128, KV=4))
        assert "K106" in codes(fs)
        assert codes(fs) <= {"K106", "K104"}
    fs = tk.check_invocation(tk.paged_invocation(
        "t", B=2, H=30, D=128, P=64, page=16, KV=4, nb=8, max_context=128))
    assert "K106" in codes(fs)


@pytest.mark.parametrize("model,local", [(2, (16, 2)), (4, (8, 1)),
                                         (8, (4, 1))])
def test_k3_at_yi_tensor_parallel_local_heads(model, local):
    """K3's forward and backward on a model rank of yi-9b's 32 / 4 heads:
    16 / 2, 8 / 1 and 4 / 1 (model 8: ``wk`` whole on "model", two
    ranks a KV head), as the layout's ``tp_heads`` gives them, clean and
    in the registry at the train shape."""
    from repro_torch.train.parallel import tp_heads

    invs = tk.tensor_parallel_flash_invocations(
        "t", B=2, H=32, S=1024, D=128, KV=4, model=model)
    fwd = invs[0]
    assert fwd.launch == "flash_fwd_kernel" and fwd.grid == (16, local[0], 2)
    assert fwd.operands[1].operand_shape == (2, local[1], 1024, 128)
    assert [i.launch for i in invs][1:] == [
        i.launch for i in tk.flash_bwd_invocations(
            "t", B=2, H=local[0], S=1024, D=128, KV=local[1])]
    assert all(tk.check_invocation(i) == [] for i in invs)
    for r in range(model):
        h_lo, h_hi, kv_lo, kv_hi = tp_heads(32, 4, model, r)
        assert (h_hi - h_lo, kv_hi - kv_lo) == local
    subjects = {i.subject for i in tk.default_invocations()}
    assert (f"flash_attention/flash_fwd_kernel@train_4k/yi-9b@model{model}"
            in subjects)


@pytest.mark.parametrize("arch,model,local", [
    ("mamba2-370m", 2, 16), ("mamba2-370m", 4, 8),
    ("zamba2-2.7b", 2, 40), ("zamba2-2.7b", 4, 20)])
def test_k6_at_split_ssm_local_heads(arch, model, local):
    """K6 and its backward on a model rank of a Mamba2 mixer split by
    heads: mamba2's 32 heads give 16 and 8, zamba2's 80 give 40 and 20,
    each launch a cluster per (head, row) of the rank's heads, clean and
    in the registry at the train shape; heads the axis does not divide
    are K106."""
    H, P, N = tk.SSM_TP_HEADS[arch]
    invs = tk.tensor_parallel_ssd_invocations(
        "t", B=2, L=1024, H=H, P=P, N=N, chunk=128, model=model)
    assert [i.launch for i in invs] == ["ssd_fwd_tf32_kernel",
                                        "ssd_bwd_tf32_kernel"]
    assert all(i.grid == (8, local, 2) for i in invs)
    assert all(tk.check_invocation(i) == [] for i in invs)
    subjects = {i.subject for i in tk.default_invocations()}
    assert (f"ssd_scan/ssd_bwd_tf32_kernel@train_4k/{arch}@model{model}"
            in subjects)
    bad = tk.tensor_parallel_ssd_invocations(
        "t", B=2, L=1024, H=H, P=P, N=N, chunk=128, model=3)
    assert all(codes(tk.check_invocation(i)) == {"K106"} for i in bad)


@pytest.mark.parametrize("model,local", [(2, 10), (4, 5)])
def test_k3_bidirectional_at_whisper_encoder_local_heads(model, local):
    """K3's forward and backward on a model rank of whisper-large-v3's
    encoder (20 heads of 64, 1500 frames, bidirectional): 10 and 5 heads
    a rank, every key tile a block in the backward (no causal pairing),
    clean and in the registry."""
    (H, KV, D), S = tk.WHISPER_ENCODER
    invs = tk.tensor_parallel_flash_invocations(
        "t", B=2, H=H, S=S, D=D, KV=KV, model=model, causal=False)
    assert invs[0].grid == (24, local, 2)
    dkdv = next(i for i in invs if i.launch == "flash_bwd_dkdv_kernel")
    assert dkdv.grid[0] == 24 and dkdv.grid[2] == 2
    assert all(tk.check_invocation(i) == [] for i in invs)
    subjects = {i.subject for i in tk.default_invocations()}
    assert ("flash_attention/flash_fwd_kernel@whisper-large-v3/"
            f"encoder-train@model{model}" in subjects)


def test_k106_when_a_layout_splits_a_kv_group():
    """12 query heads over 4 KV heads (groups of 3) on 3 model ranks: 4
    local heads span two groups, which the kernel's local map j // 2
    would misread; every launch of the rank is K106 (and the layout
    raises), where the whole heads are clean."""
    from repro_torch.train.parallel import tp_heads

    invs = tk.tensor_parallel_flash_invocations(
        "t", B=2, H=12, S=64, D=64, KV=4, model=3)
    for inv in invs:
        assert codes(tk.check_invocation(inv)) == {"K106"}, inv.subject
    assert all(tk.check_invocation(i) == []
               for i in tk.tensor_parallel_flash_invocations(
                   "t", B=2, H=12, S=64, D=64, KV=4, model=1))
    with pytest.raises(ValueError):
        tp_heads(12, 4, 3, 1)


def test_k107_uncovered_kernel_entry():
    tf = tk.check_registry_coverage(
        [tk.flash_invocation("t", B=2, H=28, S=4096, D=128, KV=4)])
    jf = jk.check_registry_coverage(
        [jk.flash_invocation("t", B=2, H=28, S=4096, D=128, KV=4)])
    assert codes(tf) == {"K107"} and codes(jf) == {"K107"}
    assert {f.subject for f in tf} == {f.subject for f in jf}
    assert {"paged_attention", "ssd_scan",
            "grouped_matmul"} <= {f.subject for f in tf}
    assert all(f.severity == "warning" for f in tf)


def test_gmm_spec_clean_at_train_shape():
    for dtype in ("bfloat16", "float32"):
        assert tk.check_invocation(tk.gmm_invocation(
            "train_4k", E=8, C=1280, D=2048, F=5632, dtype=dtype)) == []
    assert jk.check_invocation(jk.gmm_invocation(
        "train_4k", E=8, C=1280, D=2048, F=5632)) == []


def test_launch_geometry_follows_the_wrappers():
    """The numbers the card's profiler is held to (chip_smoke.py): K1's
    splits are ``split_plan``'s, K5 is four launches, K3's backward adds
    its sum launch only when a KV head's heads are split."""
    from repro_torch.kernels.paged_attention import split_plan

    inv = tk.paged_invocation("t", B=2, H=32, D=128, P=33, page=16, KV=4,
                              nb=16, max_context=256, dtype="float32")
    assert inv.grid == (split_plan(16, 16)[1], 4, 2) == (8, 4, 2)
    assert inv.cluster == (8, 1, 1) and inv.block == (128,)
    assert inv.smem == 75840
    assert [i.launch for i in tk.moe_decode_invocation(
        "t", T=4, E=40, d=1536, f=512)] == [
        "moe_dispatch_kernel", "gmm_mma_kernel", "gmm_mma_kernel",
        "moe_combine_kernel"]
    small = tk.flash_bwd_invocations("t", B=2, H=32, S=300, D=128, KV=4)
    assert [i.launch for i in small] == [
        "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
        "flash_bwd_sum_kernel", "flash_bwd_dq_kernel"]
    assert small[1].grid == (3, 32, 2) and small[1].smem == 168448
    assert small[2].grid == (1200, 1, 1) and small[3].smem == 102400
    big = tk.flash_bwd_invocations("t", B=8, H=28, S=4096, D=128, KV=4)
    assert "flash_bwd_sum_kernel" not in [i.launch for i in big]


def test_r101_combined_fold_collision():
    for mod in (tk, jk):
        spec = mod.RNGKeySpec("bad_combined", ("step", "env"),
                              {"step": range(8), "env": range(8)},
                              combine=lambda s, e: s + e)
        fs = mod.check_rng([spec])
        assert codes(fs) == {"R101"}
        assert [f.severity for f in fs] == ["error"]
    # the same first colliding pair in both
    spec = tk.RNGKeySpec("c", ("step", "env"),
                         {"step": range(8), "env": range(8)},
                         combine=lambda s, e: s + e)
    jspec = jk.RNGKeySpec("c", ("step", "env"),
                          {"step": range(8), "env": range(8)},
                          combine=lambda s, e: s + e)
    t_msg = tk.check_rng([spec])[0].message
    j_msg = jk.check_rng([jspec])[0].message
    pair = re.compile(r"\{.*?\} and \{.*?\}")
    assert pair.search(t_msg).group() == pair.search(j_msg).group()


def test_r101_missing_domain_is_a_warning():
    for mod in (tk, jk):
        spec = mod.RNGKeySpec("no_domain", ("step",), {},
                              combine=lambda s: s)
        fs = mod.check_rng([spec])
        assert codes(fs) == {"R101"}
        assert [f.severity for f in fs] == ["warning"]


def test_nested_fold_chain_is_clean():
    for mod in (tk, jk):
        spec = mod.RNGKeySpec("nested_ok", ("a", "b"),
                              {"a": range(8), "b": range(8)},
                              combine="nested")
        assert mod.check_rng([spec]) == []


def test_default_rng_specs_cover_jax_domains():
    t = {s.name: s for s in tk.default_rng_specs()}
    j = {s.name: s for s in jk.default_rng_specs()}
    assert set(t) == set(j)
    for name in t:
        assert t[name].coords == j[name].coords
        assert t[name].domain == j[name].domain
        assert callable(t[name].combine)


def _row_from_key(key: torch.Tensor, V: int) -> torch.Tensor:
    v = torch.arange(V, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(key[:, None] ^ v) + key[:, None])
    return (-torch.log(-torch.log((h.double() + 0.5) / 2.0 ** 32))).float()


def test_lint_keys_are_the_noise_functions_keys():
    """A noise row is a function of the lint's key alone, so a key
    collision is a noise collision: rebuilt from ``request_key`` and
    ``act_key``, the rows equal ``request_noise``'s and ``act_noise``'s
    bit for bit."""
    seeds = torch.tensor([0, 1, 7, 2**31 - 1], dtype=torch.int64)
    pos = torch.tensor([0, 5, 255, 1023], dtype=torch.int64)
    want = request_noise(seeds, pos, 17)
    got = _row_from_key(tk.request_key(seeds, pos), 17)
    assert torch.equal(got, want)
    ids = torch.arange(6, dtype=torch.int64)
    want = act_noise(0x5EED, 3, 40, ids, 11)
    key = tk.act_key(torch.full_like(ids, 0x5EED), torch.full_like(ids, 3),
                     torch.full_like(ids, 40), ids)
    assert torch.equal(_row_from_key(key, 11), want)


def test_analyze_runs_pass_three():
    assert ta.analyze(kernels=True) == []
    spec = tk.RNGKeySpec("bad", ("a",), {"a": range(4)},
                         combine=lambda a: a // 2)
    assert codes(tk.check_rng([spec])) == {"R101"}
    with_plan = ta.analyze_target(__import__(
        "repro_torch.analysis.targets", fromlist=["grpo_target"]
    ).grpo_target(), kernels=True)
    assert with_plan == ta.analyze_target(__import__(
        "repro_torch.analysis.targets", fromlist=["grpo_target"]
    ).grpo_target())


def test_cli_runs_all_passes_and_prints_jax_summary():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--fail-on", "error"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert re.fullmatch(
        r"flowlint: \d+ target\(s\), kernels swept: 0 finding\(s\), 0 at "
        r"or above 'error' \[\d+\.\d\ds\]", last), last
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list",
         "--target", "grpo"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert listed.returncode == 0 and listed.stdout.strip()
    assert all("grpo" in n for n in listed.stdout.split())
    none = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--no-kernels",
         "--target", "no-such-target"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert none.returncode == 2
