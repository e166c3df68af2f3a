"""The port's launcher, process groups and resharding
(``repro_torch.launch``, ``comm.resharding``) against the JAX package's
launch tests: the launcher's ``--smoke`` run, a 2-rank ``gloo``
data-parallel run equal to the one-rank run on the whole batch, its
gradient reduce, and
``reshard`` between (data, model) and (model, None) on a 2 x 2 ``gloo``
mesh keeping the values.

Every process group lives in a subprocess (at most 4 ranks, 120 s),
started with a minimal environment and joined through a ``file://`` store
under ``tmp_path``; no process group is initialized in the pytest
worker, and nothing here writes ``os.environ``.  The multi-process tests
share this file so that ``--dist loadfile`` runs them one after another.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.cluster import maybe_init_distributed
from repro_torch.models import init_model
from repro_torch.train.checkpoint import load_checkpoint
from repro_torch.train.optimizer import init_adamw
from repro_torch.utils.treeutil import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _env(**extra) -> dict:
    """A minimal environment for a subprocess, one intra-op thread."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _ranks(argv, n: int, store: Path, cwd: Path):
    """Run ``argv`` as ``n`` ranks of one ``gloo`` group; returns their
    (returncode, stdout + stderr)."""
    procs = [subprocess.Popen(
        argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(REPRO_COORD_ADDR=f"file://{store}",
                            REPRO_NUM_PROCESSES=str(n),
                            REPRO_PROCESS_ID=str(r)))
        for r in range(n)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


LAUNCH = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
          "yi-9b", "--smoke", "--device", "cpu"]


def test_train_launcher_smoke(tmp_path):
    """python -m repro_torch.launch.train --smoke runs a few steps end to
    end (mesh, init, train loop, logging), as JAX's launcher test."""
    out = subprocess.run(
        LAUNCH + ["--steps", "3", "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env(),
        cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "step 0" in out.stdout and "tok/s" in out.stdout
    assert "mesh={'data': 1, 'model': 1}" in out.stdout


def _load(path: Path, cfg):
    params = init_model(None, cfg, device="cpu")
    tree, step, meta = load_checkpoint(
        str(path), {"params": params, "opt": init_adamw(params)})
    return tree, step, meta


_DP = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    rows, local_rows = [], T._local_rows

    def spy(batch, mesh):  # the token rows this rank takes, each step
        out = local_rows(batch, mesh)
        rows.append(out["tokens"].tolist())
        return out

    T._local_rows = spy
    args = T.parse_args(sys.argv[1:])
    run = T.run(get_config(args.arch).reduced(), args)
    print("RESULT " + json.dumps({"history": run.history, "rows": rows}))
""")


def _result(text: str) -> dict:
    line = [x for x in text.splitlines() if x.startswith("RESULT ")]
    assert len(line) == 1, text
    return json.loads(line[0][len("RESULT "):])


def test_data_parallel_step_equals_one_rank_step(tmp_path):
    """Two gloo ranks, each on its half of the batch with the gradients
    all-reduced, step as one rank on the whole batch: each rank takes
    the disjoint half of the rows ``array_batch_specs`` gives it, every
    step's loss and global grad norm equal the one rank's within rtol
    1e-6 (a sum in place of the mean doubles the norm), and the params
    and moments agree, each leaf within 1e-6 of its norm (the two sum
    the gradient in different orders, and AdamW's normalisation
    magnifies the last bits of a near-zero gradient element)."""
    steps, batch, seq = 2, 4, 32
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", str(batch), "--seq", str(seq),
            "--checkpoint"]
    one = subprocess.run([sys.executable, "-c", _DP] + args
                         + [str(tmp_path / "one")],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=_env(), cwd=tmp_path)
    assert one.returncode == 0, one.stdout + one.stderr
    runs = _ranks([sys.executable, "-c", _DP] + args
                  + [str(tmp_path / "two")], 2, tmp_path / "store", tmp_path)
    for rc, text in runs:
        assert rc == 0, text
    assert "world=2" in runs[0][1] and "mesh={'data': 2, 'model': 1}" \
        in runs[0][1]
    cfg = get_config("yi-9b").reduced()
    ref = _result(one.stdout)
    ranks = [_result(text) for _, text in runs]
    # each rank's rows: its half of every step's global batch, disjoint
    rng = np.random.default_rng(0)
    whole = [rng.integers(0, cfg.vocab_size, (batch, seq)).tolist()
             for _ in range(steps)]
    assert ref["rows"] == []  # one rank takes the batch whole
    half = batch // 2
    for r, got in enumerate(ranks):
        assert got["rows"] == [w[r * half:(r + 1) * half] for w in whole]
    # every step's loss and grad norm: the same on both ranks, and the
    # one rank's
    assert ranks[0]["history"] == ranks[1]["history"]
    assert len(ref["history"]) == steps
    for got, want in zip(ranks[0]["history"], ref["history"]):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
    a, step_a, meta = _load(tmp_path / "one", cfg)
    b, step_b, _ = _load(tmp_path / "two", cfg)
    assert step_a == step_b == steps and meta == {"arch": cfg.name}
    pa, pb = tree_paths(a), tree_paths(b)
    assert pa.keys() == pb.keys()
    norm = torch.linalg.vector_norm
    for k in pa:  # every leaf within rtol 1e-6 of its norm
        if isinstance(pa[k], torch.Tensor) and pa[k].is_floating_point():
            assert norm(pb[k] - pa[k]) <= 1e-6 * norm(pa[k]), k
    # the steps moved the weights: the comparison is not of two inits
    init = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert not all(torch.equal(x, y) for x, y in zip(
        tree_leaves(init), tree_leaves(a["params"])))


_REDUCE = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.cluster import maybe_init_distributed
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.parallel import Layout
    from repro_torch.utils.sharding import P

    assert maybe_init_distributed(device="cpu")
    r = dist.get_rank()
    g = torch.Generator().manual_seed(7)
    parts = [{"w": torch.randn(3, 5, generator=g),
              "blk": {"b": torch.randn(4, generator=g).bfloat16()}}
             for _ in range(2)]
    layout = Layout(make_local_mesh(model=1, data=2),
                    {"w": P(), "blk": {"b": P()}})
    out = layout.reduce(parts[r])
    want = (parts[0]["w"] + parts[1]["w"]) / 2
    assert torch.equal(out["w"], want), (out["w"], want)
    b = (parts[0]["blk"]["b"].float() + parts[1]["blk"]["b"].float()) / 2
    assert out["blk"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["blk"]["b"], b.bfloat16())
    dist.destroy_process_group()
    print("REDUCE_OK")
""")


def test_gradient_all_reduce_is_the_mean_over_ranks(tmp_path):
    """The launcher's gradient reduce (``Layout.reduce``) gives every rank
    the mean of the ranks' gradients of a leaf stored whole over
    "data", each leaf in its own type: one f32 bucket, one all-reduce,
    divided by the data ranks."""
    runs = _ranks([sys.executable, "-c", _REDUCE], 2, tmp_path / "store",
                  tmp_path)
    for rc, text in runs:
        assert rc == 0 and "REDUCE_OK" in text, text


def test_launcher_at_world_one_is_make_train_step():
    """At world size 1 the launcher is ``make_train_step`` on the local
    tensors, bit for bit (what chip_smoke.py holds on the card)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainHParams, lm_loss, \
        make_train_step

    args = launch_train.parse_args(["--steps", "2", "--batch", "2", "--seq",
                                    "16", "--smoke", "--device", "cpu"])
    cfg = get_config("yi-9b").reduced()
    run = launch_train.run(cfg, args)
    params, hist = run.params, run.history
    assert run.mesh_dims == {"data": 1, "model": 1}
    assert run.mesh_kind == "LogicalMesh"
    ref = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    ropt = init_adamw(ref)
    step = make_train_step(cfg, TrainHParams(
        optimizer=AdamWConfig(lr=3e-4, warmup_steps=10, clip_norm=1.0)),
        loss_fn=lm_loss)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
        ref, ropt, m = step(ref, ropt, {"tokens": tok})
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in hist] == losses
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(params),
                                                 tree_leaves(ref)))
    assert not dist.is_initialized()


def test_maybe_init_distributed_without_coordinator(monkeypatch):
    monkeypatch.delenv("REPRO_COORD_ADDR", raising=False)
    assert maybe_init_distributed(device="cpu") is False
    assert not dist.is_initialized()


_RESHARD = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.comm import resharding
    from repro_torch.launch.cluster import maybe_init_distributed
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.utils.sharding import NamedSharding, P, placements

    assert maybe_init_distributed(device="cpu")
    mesh = make_local_mesh(model=2, data=2)
    x = torch.arange(64.0).reshape(8, 8)
    a = distribute_tensor(x, mesh, placements(mesh, P("data", "model")))
    assert tuple(a.to_local().shape) == (4, 4)
    out = resharding.reshard({"w": a},
                             {"w": NamedSharding(mesh, P("model", None))})
    w = out["w"]
    assert tuple(w.placements) == (Replicate(), Shard(0)), w.placements
    assert tuple(w.to_local().shape) == (4, 8)
    assert torch.equal(w.full_tensor(), x)
    # a plain tensor is distributed, a spec tree through reshard_params
    tree = resharding.reshard_params({"b": x.clone(), "c": (x[0].clone(),)},
                                     mesh, {"b": P(None, ("data", "model")),
                                            "c": (P(),)})
    assert tuple(tree["b"].to_local().shape) == (8, 2)
    assert torch.equal(tree["b"].full_tensor(), x)
    assert torch.equal(tree["c"][0].full_tensor(), x[0])
    import torch.distributed as dist
    dist.destroy_process_group()
    print("RESHARD_OK")
""")


def test_resharding_between_specs_on_2x2_gloo_mesh(tmp_path):
    """reshard a tree from (data, model) to (model, None) on a 2 x 2 mesh
    of four gloo ranks, values kept (JAX's
    test_resharding_between_specs_subprocess on the port)."""
    runs = _ranks([sys.executable, "-c", _RESHARD], 4,
                  tmp_path / "store", tmp_path)
    for rc, text in runs:
        assert rc == 0 and "RESHARD_OK" in text, text
