"""The port's dry-run (``repro_torch.launch.dryrun``, ``utils.roofline``,
``utils.hardware``) against the JAX package's: ``model_flops`` and the
roofline report's arithmetic equal JAX's, and the bytes a device holds
of the parameters, AdamW moments, decode state and batch equal what
JAX's sharding rules give for JAX's shapes on the same production mesh
(JAX's side through ``jax.eval_shape``: no devices needed, its rules
read only the mesh's names and sizes)."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.utils.roofline as jroof
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.models import model as JM
from repro.train import sharding_rules as JR
from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import hardware as H
from repro_torch.utils import roofline as R

ROOT = Path(__file__).resolve().parents[1]


def test_shapes_and_h100_spec():
    import repro.configs.shapes as jshapes
    import repro.utils.hardware as jhw

    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    assert H.DEFAULT_CHIP is H.H100_SXM
    assert H.H100_SXM.peak_flops_bf16 == jhw.H100_PEAK_FLOPS_BF16
    assert H.H100_SXM.hbm_bandwidth == jhw.H100_HBM_BW
    assert H.H100_SXM.vmem_bytes == 227 * 1024
    assert vars(H.TPU_V5E) == vars(jhw.TPU_V5E)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_jax(shape):
    for arch in list_archs():
        assert R.model_flops(get_config(arch), get_shape(shape)) == \
            jroof.model_flops(jget_config(arch), jget_shape(shape))


def test_roofline_report_math_equals_jax():
    kw = dict(arch="yi-9b", shape="train_4k", mesh="16x16", chips=256,
              hlo_flops=3.1e14, hlo_bytes=2.2e11, collective_bytes=7.5e9,
              model_flops=6.3e16)
    for extra in ({}, {"hlo_bytes": 9e13}, {"collective_bytes": 9e14}):
        t = R.RooflineReport(**{**kw, **extra}).finalize(H.TPU_V5E, 4)
        j = jroof.RooflineReport(**{**kw, **extra}).finalize(
            jroof.DEFAULT_CHIP, 4)
        assert (t.compute_s, t.memory_s, t.collective_s) == \
            (j.compute_s, j.memory_s, j.collective_s)
        assert t.dominant == j.dominant and t.row() == j.row()
        assert t.useful_flops_ratio == j.useful_flops_ratio
    h = R.RooflineReport(**kw).finalize()
    assert h.compute_s == kw["hlo_flops"] / 989e12
    assert h.collective_s == kw["collective_bytes"] / 450e9


def _jax_mesh(multi_pod: bool):
    m = make_production_mesh(multi_pod=multi_pod)
    return SimpleNamespace(shape=m.shape, axis_names=m.axis_names)


def _jax_bytes(mesh, tree, specs) -> int:
    """Bytes a device holds of a ShapeDtypeStruct tree laid out by JAX's
    specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, flat):
        n = np.dtype(x.dtype).itemsize
        dims = list(x.shape)
        for i, e in enumerate(tuple(spec)):
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                dims[i] //= mesh.shape[a]
        total += n * int(np.prod(dims))
    return total


def _jax_memory(arch: str, shape_name: str, multi_pod: bool):
    # (JAX's launch.dryrun is not imported: it sets XLA_FLAGS at import;
    # its arch_for_shape only calls cfg.replace, as the port's does)
    mesh = _jax_mesh(multi_pod)
    shape = jget_shape(shape_name)
    cfg = D.arch_for_shape(jget_config(arch), shape)
    sds = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg,
                                               jnp.bfloat16))
    ps = JR.param_specs(mesh, cfg, sds)
    out = {"param_bytes": _jax_bytes(mesh, sds, ps), "opt_bytes": 0,
           "decode_state_bytes": 0, "batch_bytes": 0}
    B, S = shape.global_batch, shape.seq_len
    if shape.phase == "train":
        f32 = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), sds)
        out["opt_bytes"] = 2 * _jax_bytes(mesh, f32, ps)
    if shape.phase == "decode":
        st = jax.eval_shape(lambda: JM.init_decode_state(cfg, B, S,
                                                         jnp.bfloat16))
        out["decode_state_bytes"] = _jax_bytes(
            mesh, st, JR.decode_state_specs(mesh, cfg, st))
    else:
        batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        for k in ("old_logprobs", "advantages", "loss_mask"):
            batch[k] = jax.ShapeDtypeStruct((B, S), jnp.float32)
        if cfg.kind == "vlm":
            batch["image_embeds"] = jax.ShapeDtypeStruct(
                (B, cfg.num_image_tokens, cfg.d_model), jnp.bfloat16)
        if cfg.kind == "encdec":
            batch["frame_embeds"] = jax.ShapeDtypeStruct(
                (B, cfg.encoder_seq_len, cfg.d_model), jnp.bfloat16)
        out["batch_bytes"] = _jax_bytes(
            mesh, batch, JR.array_batch_specs(mesh, batch))
    return out


CASES = [("yi-9b", "train_4k", False), ("yi-9b", "decode_32k", True),
         ("granite-moe-3b-a800m", "decode_32k", False),
         ("zamba2-2.7b", "long_500k", False),
         ("whisper-large-v3", "train_4k", False),
         ("llama-3.2-vision-90b", "prefill_32k", False),
         ("mistral-large-123b", "long_500k", True),
         ("mamba2-370m", "train_4k", True)]


@functools.lru_cache(maxsize=None)
def _case(arch: str, shape: str, multi_pod: bool = False):
    """``run_case`` once a case in this process (several tests read it)."""
    return D.run_case(arch, shape, multi_pod=multi_pod, save=False,
                      verbose=False)


@pytest.mark.parametrize("arch,shape,multi_pod", CASES,
                         ids=[f"{a}-{s}-{'pod' if m else '16x16'}"
                              for a, s, m in CASES])
def test_bytes_a_device_equal_jax_rules(arch, shape, multi_pod):
    r = _case(arch, shape, multi_pod)
    want = _jax_memory(arch, shape, multi_pod)
    got = {k: r["memory"][k] for k in want}
    assert got == want
    assert r["memory"]["resident_bytes"] == sum(want.values())
    assert r["memory"]["fits_resident"] == (sum(want.values()) <= 80e9)
    assert r["chips"] == (512 if multi_pod else 256)
    # the meta forward's count is the 6ND estimate plus attention and
    # the plain versions' extras: never below it
    assert r["flops"]["model_flops"] == jroof.model_flops(
        jget_config(arch), jget_shape(shape))
    assert r["flops"]["counted_flops"] >= 0.85 * r["flops"]["model_flops"]
    # the forward reads every weight once at least, and the memory term
    # is an even share of what its ops move
    moved = r["bytes_moved"]["counted_bytes"]
    assert moved >= 2 * get_config(arch).param_count()
    assert r["roofline"]["memory_s"] == \
        moved / r["chips"] / H.H100_SXM.hbm_bandwidth


def test_byte_counter_reads_operands_and_writes_results():
    """A product moves its operands and its result; a view moves
    nothing, a reshape that copies moves its input once each way; an
    in-place add reads both and writes the first."""
    import torch

    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 2), device="meta", dtype=torch.float64)
    with D.ByteCounter() as c:
        a.t()[1:]
        a[1:].reshape(3, 8).view(24)
        a.view(2, 16)
        assert c.bytes == 0
        a.t().reshape(2, 16)
        assert c.bytes == 2 * 4 * 8 * 4
    with D.ByteCounter() as c:
        a @ b.float()
    assert c.bytes == 4 * 8 * 4 + (8 * 2 * 8 + 8 * 2 * 4) + \
        (8 * 2 * 4 + 4 * 2 * 4)
    with D.ByteCounter() as c:
        a.add_(a)
    assert c.bytes == 3 * 4 * 8 * 4


def test_collectives_follow_the_specs():
    """A (1, 1) mesh has no collectives; on (16, 16) a train step
    gathers each FSDP-sharded weight twice and reduce-scatters its
    gradient, and pods add an all-reduce of every gradient shard."""
    from repro_torch.train.sharding_rules import param_specs
    from repro_torch.utils.treeutil import tree_leaves
    from repro_torch.utils.sharding import LogicalMesh

    cfg = get_config("yi-9b")
    params = D.meta_params(cfg)
    one = LogicalMesh(("data", "model"), (1, 1))
    c = R.collective_bytes(one, params, param_specs(one, cfg, params),
                           train=True)
    assert sum(c["bytes"].values()) == 0
    mesh = make_production_mesh()
    specs = param_specs(mesh, cfg, params)
    tr = R.collective_bytes(mesh, params, specs, train=True)
    fw = R.collective_bytes(mesh, params, specs, train=False)
    assert tr["counts"]["all-gather"] == 2 * fw["counts"]["all-gather"] > 0
    assert tr["bytes"]["reduce-scatter"] * 16 == fw["bytes"]["all-gather"]
    assert fw["bytes"]["reduce-scatter"] == fw["bytes"]["all-reduce"] == 0
    pod = make_production_mesh(multi_pod=True)
    pp = R.collective_bytes(pod, params, param_specs(pod, cfg, params),
                            train=True)
    assert pp["counts"]["all-reduce"] == \
        tr["counts"]["all-reduce"] + len(tree_leaves(params))


def test_cli_writes_a_torch_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "OUT_DIR", str(tmp_path))
    D.main(["--arch", "yi-9b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "ALL DRY-RUN CASES PASSED" in out and "fits_resident=True" in out
    data = json.loads((tmp_path / "yi-9b_decode_32k_16x16_torch.json")
                      .read_text())
    assert data["chip"] == "h100_sxm" and data["memory"]["fits_resident"] is True
    assert set(data["roofline"]) >= {"compute_s", "memory_s",
                                     "collective_s", "dominant"}


def test_import_sets_no_environment_variable():
    code = ("import os; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.train; "
            "import repro_torch.analysis.kernel_checks; "
            "assert dict(os.environ) == before; print('ENV_OK')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert "ENV_OK" in out.stdout, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the peak estimate (``launch.memory``) and the kernels' meta route
# ---------------------------------------------------------------------------
import torch  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import meta as KM  # noqa: E402
from repro_torch.kernels import moe_gmm as GMM  # noqa: E402
from repro_torch.kernels import ops as KOPS  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import ssm_update as SSU  # noqa: E402
from repro_torch.launch import memory as MEM  # noqa: E402

META = torch.device("meta")


def _m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def test_live_bytes_a_view_adds_nothing():
    with MEM.LiveBytes() as lb:
        a = _m(10, 10)
        a[2:].t()
        a.view(100)
        assert (lb.live, lb.peak) == (400, 400)
        b = a * 2
        assert (lb.live, lb.peak) == (800, 800)
        del b
        assert lb.live == 400


def test_live_bytes_a_storage_dies_with_its_last_view():
    with MEM.LiveBytes() as lb:
        a = _m(6, 4, dtype=torch.float64)
        v, w = a[1:], a.t()
        del a
        assert lb.live == 192
        del v
        assert lb.live == 192
        del w
        assert (lb.live, lb.peak) == (0, 192)


def test_live_bytes_keeps_what_autograd_saves_until_the_backward():
    x = _m(8, grad=True)
    with MEM.LiveBytes() as lb:
        assert lb.add(x) == 32 and lb.add(x) == 0
        y = x.exp()  # saved for exp's backward
        s = y.sum()
        del y
        assert lb.live == 32 + 32 + 4
        s.backward()
        # exp's saved output freed, x.grad made
        assert lb.live == 32 + 4 + 32
        # at exp's backward: x, the saved y, s, the sum's seed of ones
        # and the product grad * y
        assert lb.peak == 32 + 32 + 4 + 4 + 32


def test_trace_step_splits_arguments_outputs_and_aliases():
    """An in-place update aliases its argument; a fresh result is an
    output; the temporary's peak gives back JAX's formula."""
    p = _m(16)

    def step(p):
        t = p * 3  # 64 bytes of temporary
        p.add_(t)
        return p, t.sum()

    got, _ = MEM.trace_step(step, p)
    assert (got.argument, got.output, got.alias) == (64, 68, 64)
    assert got.peak == 64 + 64 + 4 and got.temp == 64
    assert got.end == 64 + 4  # the temporary freed, the outputs held
    assert got.memory()["peak_est_bytes"] == got.peak


def test_meta_memo_repeats_results_without_changing_them():
    """A pure operator met twice gives the same shapes, strides and types
    with and without the memo; a view still aliases."""
    x = _m(3, 5).t()
    with MEM.MetaMemo():
        a, b = x * 2.0, x * 2.0
        v = x.reshape(15) if x.is_contiguous() else x[:, 1:]
    want = x * 2.0
    for t in (a, b):
        assert (t.shape, t.stride(), t.dtype) == \
            (want.shape, want.stride(), want.dtype)
    assert a.untyped_storage() is not b.untyped_storage()
    assert v.untyped_storage() is x.untyped_storage()
    # a copying reshape: a clone, then an ``_unsafe_view`` of it (no alias
    # annotation, the clone's storage): no fresh storage the second time
    x = _m(3, 5)
    with MEM.LiveBytes() as lb:
        lb.add(x)
        y1 = x.t().reshape(15)
        y2 = x.t().reshape(15)
        assert (lb.live, lb.peak) == (3 * 60, 3 * 60)
    assert y1.untyped_storage() is not y2.untyped_storage()


FLOP_SHAPES = [(2, 4, 2, 70, 16), (1, 8, 1, 33, 8)]


@pytest.mark.parametrize("B,H,KV,S,D", FLOP_SHAPES)
def test_meta_kernel_flops_equal_the_plain_versions(B, H, KV, S, D):
    """Each meta kernel op counts what FlopCounterMode counts of its plain
    version: K3, K6, K5 and K7 at small shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    def flops(fn, custom=None):
        with FlopCounterMode(display=False, custom_mapping=custom or {}) \
                as fc:
            fn()
        return fc.get_total_flops()

    q, k, v = _m(B, H, S, D), _m(B, KV, S, D), _m(B, KV, S, D)
    assert flops(lambda: FA.flash_attention_plain(q, k, v)) == flops(
        lambda: KM._ops.flash_fwd(q, k, v, True, 0), KM.FLOP_FORMULAS) > 0
    nc, s, P, N = 3, 16, D // 2, 7
    x, dt, A = _m(B, H, nc, s, P), _m(B, H, nc, s), _m(B, H)
    Bm, Cm = _m(B, nc, s, N), _m(B, nc, s, N)
    assert flops(lambda: SSD.ssd_scan_plain(x, dt, A, Bm, Cm, A)) == flops(
        lambda: KM._ops.ssd_fwd(x, dt, A, Bm, Cm, A, False),
        KM.FLOP_FORMULAS) > 0
    T, d, E, f, top = S, D, 2 * H, 12, 2
    xt, idx, gv = _m(T, d), _m(T, top, dtype=torch.long), _m(T, top)
    gw, uw, dw = _m(E, d, f), _m(E, d, f), _m(E, f, d)
    assert flops(lambda: GMM.moe_decode_gmm_plain(xt, idx, gv, gw, uw, dw)) \
        == flops(lambda: KM._ops.moe_decode(xt, idx, gv, gw, uw, dw),
                 KM.FLOP_FORMULAS) > 0
    st, xs, dts = _m(B, H, P, N), _m(B, H, P), _m(B, H)
    assert flops(lambda: SSU.ssm_state_update_plain(
        st, xs, dts, dts, _m(B, N), _m(B, N), dts)) == flops(
        lambda: KOPS.ssm_state_update(st, xs, dts, _m(H), _m(B, N),
                                      _m(B, N), _m(H)),
        KM.FLOP_FORMULAS) > 0


def test_meta_flash_allocates_what_the_card_wrapper_does():
    """ops.flash_attention on meta: out (q's layout) and lse f32 saved
    with q, k, v; the backward's dq, dk, dv and the workspace live at
    once, then the workspace freed."""
    B, S, H, KV, D = 2, 130, 4, 2, 16
    q, k, v = _m(B, S, H, D, grad=True), _m(B, S, KV, D, grad=True), \
        _m(B, S, KV, D, grad=True)
    qb, kb = B * S * H * D * 4, B * S * KV * D * 4
    with MEM.LiveBytes() as lb:
        lb.add((q, k, v))
        out = KOPS.flash_attention(q, k, v)
        assert out.shape == q.shape
        lse = B * H * S * 4
        assert lb.live == qb + 2 * kb + qb + lse
        out.backward(torch.empty_like(out))
    from repro_torch.analysis.kernel_checks import flash_bwd_workspace

    work = flash_bwd_workspace(B, H, KV, S, D) * 4
    assert work > 0
    # at the backward op: arguments, out and lse saved, dout, dq, dk,
    # dv and the workspace
    assert lb.peak == 2 * qb + 2 * kb + lse + qb + qb + 2 * kb + work


def test_workspace_mirror_matches_the_c_formula_by_hand():
    """The K3 backward's scratch: 64 x 64 dS tiles of the live (query,
    key) tile pairs, delta, and the head groups' partials when a KV
    head's heads split into more than one group."""
    from repro_torch.analysis.kernel_checks import flash_bwd_workspace as w

    # causal S 128: tiles (0,0), (1,0), (1,1); one causal key block
    # pair x g x 1 x 1 never reaches 264 blocks, so the 4 heads of the
    # KV head are 4 groups, each with a (1, 1, 128, 64) dK and dV
    partials = 2 * 4 * 128 * 64
    assert w(1, 4, 1, 128, 64) == 4 * 3 * 4096 + 4 * 128 + partials
    assert w(1, 4, 1, 128, 64, causal=False) == \
        4 * 4 * 4096 + 4 * 128 + partials
    # a window of 64: query tile 1 sees key tiles 0 and 1 still
    assert w(1, 4, 1, 128, 64, window=64) == w(1, 4, 1, 128, 64)
    # one head a KV head: no partials
    assert w(1, 4, 4, 128, 64) == 4 * 3 * 4096 + 4 * 128
    # yi-9b's train microbatch, 32 / 4 heads of 128 over 2 x 1024: 136
    # live tiles; 8 key blocks x g x 4 x 2 stays below 264 for every
    # proper divisor g of the 8 heads a KV head, so 8 groups; the card
    # reported 209.98 MB (PERF.md, the K3 bwd row)
    got = w(2, 32, 4, 1024, 128)
    assert got == 2 * 32 * 136 * 4096 + 2 * 32 * 1024 \
        + 2 * 8 * 2 * 4 * 1024 * 128
    assert round(got * 4 / 1e6, 2) == 209.98


def test_meta_ssd_saves_states_and_sums_the_partials():
    """ops.ssd_scan on meta: y, and under autograd the f32 chunk-start
    states; the gradients in the inputs' shapes."""
    B, L, H, P, N = 2, 100, 3, 8, 6
    x, dt = _m(B, L, H, P, grad=True), _m(B, L, H, grad=True)
    A, D = _m(H, grad=True), _m(H, grad=True)
    Bm, Cm = _m(B, L, N, grad=True), _m(B, L, N, grad=True)
    seen = []

    class Record(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.repro_meta.ssd_fwd.default:
                seen.append(tuple(out[1].shape))
            return out

    with Record():
        y = KOPS.ssd_scan(x, dt, A, Bm, Cm, D, 32)
        y.sum().backward()
        with torch.no_grad():
            KOPS.ssd_scan(x, dt, A, Bm, Cm, D, 32)
    assert seen == [(B, H, 4, P, N), (0,)]
    assert (x.grad.shape, A.grad.shape, Bm.grad.shape) == \
        (x.shape, A.shape, Bm.shape)


def test_meta_decode_kernels_are_one_op_each():
    """K5 and K7 on meta: one repro_meta op each, and ByteCounter counts
    their operands read and every buffer the card allocates written."""
    T, d, E, f, top = 4, 8, 4, 6, 2
    x = _m(T, d)
    idx = _m(T, top, dtype=torch.long)
    gv = _m(T, top)
    w1, w2, w3 = _m(E, d, f), _m(E, d, f), _m(E, f, d)
    with D.ByteCounter() as c:
        y = KOPS.moe_decode(x, idx, gv, w1, w2, w3)
    C = GMM.decode_capacity(T)
    # x, the int64 expert ids, the f32 gates, the three weights
    reads = 4 * T * d + 8 * T * top + 4 * T * top + 4 * E * f * 3 * d
    # y, the int32 slots and counts, the dispatch buffer, gate/up, down
    writes = 4 * (T * d + E * C * (2 * d + f)) + 4 * (T * top + E)
    assert y.shape == (T, d) and c.bytes == reads + writes
    st, xs, dt = _m(2, 3, 4, 5), _m(2, 3, 4), _m(2, 3)
    with D.ByteCounter() as c:
        yy, new = KOPS.ssm_state_update(st, xs, dt, _m(3), _m(2, 5),
                                        _m(2, 5), _m(3))
    assert (yy.shape, new.shape) == ((2, 3, 4), (2, 3, 4, 5))
    assert new.dtype == yy.dtype == torch.float32


class _Launches(torch.utils._python_dispatch.TorchDispatchMode):
    """The heads of the meta K3 and K6 launches below it: (query heads,
    KV heads) of each flash forward, the heads of each SSD forward."""

    def __init__(self):
        super().__init__()
        self.flash, self.ssd = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro_meta.flash_fwd.default:
            self.flash.add((args[0].shape[1], args[1].shape[1]))
        if func is torch.ops.repro_meta.ssd_fwd.default:
            self.ssd.add(args[0].shape[1])
        return func(*args, **(kwargs or {}))


LAYOUT_ARCHS = ["yi-9b", "mamba2-370m", "zamba2-2.7b", "whisper-large-v3"]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_meta_layout_runs_rank0_at_the_local_heads(arch, mesh):
    """The estimate's train step through ``Layout`` on a mesh of names and
    sizes: K3 at rank 0's query heads and the KV heads they read
    (``local_heads``, as the gloo tests record them), K6 at nh / m, and
    the arguments are ``train_state_bytes`` plus rank 0's rows."""
    from repro_torch.train.parallel import local_heads
    from repro_torch.train.trainer import TrainHParams
    from repro_torch.utils.sharding import LogicalMesh

    cfg = get_config(arch).reduced()
    data, model = mesh
    lmesh = LogicalMesh(("data", "model"), (data, model))
    B, S = 4, 32
    batch = {"tokens": torch.zeros((B, S), dtype=torch.long)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.zeros((B, S))
    if cfg.kind == "encdec":
        batch["frame_embeds"] = torch.zeros((B, cfg.encoder_seq_len,
                                             cfg.d_model))
    with _Launches() as seen:
        est = MEM.peak_estimate(cfg, {"data": data, "model": model},
                                batch=batch, dtype=torch.float32,
                                hp=TrainHParams(n_microbatches=2,
                                                remat=True))
    want_flash = set()
    if cfg.num_heads and cfg.kind != "ssm":
        want_flash.add(local_heads(cfg.num_heads, cfg.num_kv_heads, model))
    assert seen.flash == want_flash
    nh = cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim if cfg.ssm else 0
    assert seen.ssd == ({nh // model} if nh else set())
    state = D.train_state_bytes(cfg, lmesh, torch.float32)
    rows = sum(t[: B // data].numel() * t.element_size()
               for t in batch.values())
    assert est.argument == state["param_bytes"] + state["opt_bytes"] + rows
    assert est.alias == state["param_bytes"] + state["opt_bytes"]
    assert est.peak > est.argument


def test_a_mesh_of_names_takes_meta_tensors_only():
    """The meta route's collectives allocate their results as nccl's and
    refuse a tensor with data."""
    from repro_torch.train import parallel as PAR

    g = PAR.MetaGroup(4)
    x = _m(3, 5)
    assert PAR.all_gather(x, 1, g).shape == (3, 20)
    assert PAR.reduce_scatter(_m(8, 5), 0, g).shape == (2, 5)
    with pytest.raises(ValueError, match="meta tensors"):
        PAR.all_gather(torch.zeros(3, 5), 0, g)


def test_act_spec_has_no_counterpart_and_the_microbatches_are_jaxs():
    """JAX's ``hparams_for`` (run in a subprocess: its module sets
    XLA_FLAGS at import) gives the same microbatches and remat, and a
    sequence-parallel ``act_spec`` at 16 x 16 that the port's hyper-
    parameters have no field for: rank 0 holds its rows' whole
    sequence."""
    from repro_torch.train.trainer import TrainHParams

    code = (
        "import json; from types import SimpleNamespace as N\n"
        "from repro.launch import dryrun as J\n"
        "from repro.configs import get_config, get_shape\n"
        "m = N(shape={'data': 16, 'model': 16}, axis_names=('data', "
        "'model'))\n"
        f"archs = {D.ASSIGNED_ARCHS!r}\n"
        "out = {a: [J.hparams_for(get_config(a), get_shape('train_4k'), "
        "m).n_microbatches, J.hparams_for(get_config(a), "
        "get_shape('train_4k'), m).remat, str(J.hparams_for(get_config(a),"
        " get_shape('train_4k'), m).act_spec)] for a in archs}\n"
        "print('JSON' + json.dumps(out))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "REPRO_DRYRUN_DEVICES": "1", "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JSON")]
    assert line, res.stdout + res.stderr
    jax_hp = json.loads(line[0][4:])
    mesh = make_production_mesh()
    for arch in D.ASSIGNED_ARCHS:
        hp = D.hparams_for(get_config(arch), get_shape("train_4k"), mesh)
        n, remat, act = jax_hp[arch]
        assert (hp.n_microbatches, hp.remat) == (n, remat), arch
        assert "model" in act  # JAX splits the sequence over "model"
    assert "act_spec" not in TrainHParams._fields


def test_workspace_shapes_are_the_linted_backward_launches():
    """``flash_bwd_shapes`` lists one shape a K3 backward that pass 3's
    registry lints (the card compares the workspace mirror there)."""
    from repro_torch.analysis import kernel_checks as kc

    dkdv = [inv for inv in kc.default_invocations()
            if inv.launch == "flash_bwd_dkdv_kernel"]
    shapes = kc.flash_bwd_shapes()
    assert len(dkdv) == len(shapes) == len(set(shapes))
    for inv, (B, H, KV, S, D, causal, _) in zip(dkdv, shapes):
        q = [op for op in inv.operands if op.name == "q"][0]
        assert q.operand_shape == (B, H, S, D)
        assert inv.grid[2] == B and inv.grid[1] % KV == 0


def test_decode_temporaries_are_whole_heads_on_rank0_rows():
    """A decode case, by design unlike JAX's: the port's ``decode_step``
    has no split over "model" and writes a new state.  So its
    temporaries are those of rank 0's rows with every head whole (the
    same at a model axis of 1 and 2, half at twice the data axis), its
    arguments and outputs the rules' shards, and only the leaves it
    passes through (whisper's cross K/V) alias, where JAX donates the
    whole state."""
    from repro_torch.models import model as M
    from repro_torch.train.sharding_rules import decode_state_specs
    from repro_torch.utils.roofline import per_device_bytes
    from repro_torch.utils.sharding import LogicalMesh

    def est(arch, data, model):
        return MEM.peak_estimate(get_config(arch).reduced(),
                                 {"data": data, "model": model},
                                 phase="decode", decode_rows=8,
                                 cache_len=64)

    one, split, rows = (est("yi-9b", 1, 1), est("yi-9b", 1, 2),
                        est("yi-9b", 2, 1))
    assert one.temp == split.temp == 2 * rows.temp > 0
    assert one.alias == split.alias == 0
    assert split.argument < one.argument
    cfg = get_config("whisper-large-v3").reduced()
    mesh = LogicalMesh(("data", "model"), (2, 2))
    state = M.init_decode_state(cfg, 8, 64, torch.bfloat16, META)
    specs = decode_state_specs(mesh, cfg, state)
    got = est("whisper-large-v3", 2, 2)
    assert got.alias == per_device_bytes(mesh, state.cross_kv,
                                         specs.cross_kv) > 0
    # bf16 logits of rank 0's 4 rows, the new self-attention cache
    assert got.output == got.alias + per_device_bytes(
        mesh, state.kv, specs.kv) + (8 // 2) * cfg.padded_vocab * 2


@pytest.mark.parametrize("mesh,stack_gb", [((4, 1), 37.29), ((2, 2), 37.30)],
                         ids=["4x1", "2x2"])
def test_deep_yi_peaks_in_adamw_past_the_unbind(mesh, stack_gb, monkeypatch):
    """yi-9b at all 48 layers as the launcher trains it on four cards (f32
    + AdamW, 4 x 1024 tokens, one microbatch, remat): the estimate's peak
    (44.030 GB a card) falls in AdamW's ``sqrt`` on the largest stacked
    leaf, and the live bytes at the backward of ``unstack_layers``'
    unbind (each stacked leaf's gradient stacked) stay below it."""
    from repro_torch.launch import train as T
    from repro_torch.train.trainer import lm_loss

    at_stack = [0]

    class Traced(MEM.LiveBytes):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func is torch.ops.aten.stack.default:
                at_stack[0] = max(at_stack[0], self.live)
            return out

    monkeypatch.setattr(MEM, "LiveBytes", Traced)
    args = T.parse_args(["--arch", "yi-9b", "--batch", "4", "--seq", "1024"])
    tokens = _m(4, 1024, dtype=torch.int64)
    data, model = mesh
    est = MEM.peak_estimate(get_config("yi-9b"),
                            {"data": data, "model": model},
                            batch={"tokens": tokens}, hp=T.hparams(args),
                            dtype=torch.float32, loss_fn=lm_loss)
    assert est.peak_op == "aten.sqrt.default"
    assert est.ops - est.peak_index < 64  # in the optimizer, at the end
    assert round(est.memory()["peak_est_bytes"] / 1e9, 3) == 44.030
    assert round(at_stack[0] / 1e9, 2) == stack_gb
    assert at_stack[0] < est.peak
