"""The port's dry-run (``repro_torch.launch.dryrun``, ``utils.roofline``,
``utils.hardware``) against the JAX package's: ``model_flops`` and the
roofline report's arithmetic equal JAX's, and the bytes a device holds
of the parameters, AdamW moments, decode state and batch equal what
JAX's sharding rules give for JAX's shapes on the same production mesh
(JAX's side through ``jax.eval_shape``: no devices needed, its rules
read only the mesh's names and sizes)."""
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


@pytest.mark.parametrize("arch,shape,multi_pod", CASES,
                         ids=[f"{a}-{s}-{'pod' if m else '16x16'}"
                              for a, s, m in CASES])
def test_bytes_a_device_equal_jax_rules(arch, shape, multi_pod):
    r = D.run_case(arch, shape, multi_pod=multi_pod, save=False,
                   verbose=False)
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
