"""Parameter layouts across ranks (``repro_torch.train.parallel`` through
``launch.train``) against one rank and against the JAX package: FSDP
over "data" (ZeRO moments), tensor parallelism over "model", replicas
over "pod", each step equal to the one-rank step on the whole batch.

Every process group lives in a subprocess (at most 4 ranks, ``TIMEOUT``),
started with a minimal environment and joined through a ``file://``
store under a temporary directory; nothing here initializes a process
group in the pytest worker or writes ``os.environ``.  Three groups run
once each (module-scoped fixtures) and the tests read their results:
  * 2 ranks: FSDP at (data, model) = (2, 1), tensor parallel at (1, 2),
    also with q/k/v biases and q/k norms;
  * 4 ranks: (2, 2) with remat and a checkpoint, ``--multi-pod`` (2, 1,
    2), (1, 4) (reduced yi-9b's 2 KV heads do not divide 4), (4, 1); the
    MoE, SSM, hybrid, encoder-decoder and VLM kinds at (2, 2); JAX's
    ``init_model`` weights bridged into (2, 2) for one step;
  * 2 ranks: the launcher's command line with ``--model-axis 2``.
Bars: FSDP as the data-parallel test's (loss and grad norm within rtol
1e-6, each leaf within 1e-6 of its norm).  Tensor parallel within 1e-5:
a row-parallel product sums its partial sums over the model ranks, in
another order than one rank's product sums its terms.
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

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import init_model
from repro_torch.train import checkpoint as tck
from repro_torch.train.optimizer import AdamWState, init_adamw
from repro_torch.train.parallel import tp_heads
from repro_torch.utils.treeutil import tree_paths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
BASE = ["--arch", "yi-9b", "--device", "cpu", "--steps", "2", "--batch",
        "4", "--seq", "32"]
SMOKE = BASE + ["--smoke"]
KINDS = ["granite-moe-3b-a800m", "mamba2-370m", "zamba2-2.7b",
         "whisper-large-v3", "llama-3.2-vision-90b"]


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


# Each rank runs the cases of a JSON file, each against the one-rank
# step on the whole batch, and rank 0 prints every case's result.
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.cluster import maybe_init_distributed
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_model
    from repro_torch.train import checkpoint as tck
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.parallel import Layout, shard_params
    from repro_torch.train.sharding_rules import param_specs
    from repro_torch.train.trainer import (TrainHParams, lm_loss,
                                           make_train_step, policy_loss)
    from repro_torch.utils.sharding import shard_shape
    from repro_torch.utils.treeutil import (tree_leaves, tree_map,
                                            tree_paths)

    torch.set_num_threads(1)
    assert maybe_init_distributed(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    norm = torch.linalg.vector_norm

    def leaf_errors(got, want):
        a, b = tree_paths(want), tree_paths(got)
        assert a.keys() == b.keys()
        return {k: float(norm(b[k] - a[k]) / norm(a[k])) for k in a}

    def world_mean(x):
        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t)
        return float(t[0]) / world

    def shards(run, cfg, hp_dtype=torch.float32):
        mesh, specs = run.layout.mesh, run.layout.specs
        whole = init_model(torch.Generator().manual_seed(0), cfg,
                           hp_dtype, "meta")
        ok = all(tuple(x.shape) == shard_shape(mesh, tuple(w.shape), s)
                 for x, w, s in zip(tree_leaves(run.params),
                                    tree_leaves(whole),
                                    tree_leaves(specs)))
        nbytes = sum(x.numel() * x.element_size() for t in
                     (run.params, run.opt.mu, run.opt.nu)
                     for x in tree_leaves(t))
        want = train_state_bytes(cfg, mesh, torch.float32)
        return {"shapes_ok": ok, "bytes": nbytes,
                "dryrun_bytes": want["param_bytes"] + want["opt_bytes"]}

    def launch_case(case):
        cfg = get_config(case["arch"]).reduced()
        if case.get("replace"):
            cfg = cfg.replace(**case["replace"])
        args = T.parse_args(case["argv"])
        run = T.run(cfg, args)
        full = run.layout.full(run.params)
        ref = init_model(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu")
        ropt = init_adamw(ref)
        step = make_train_step(cfg, TrainHParams(
            optimizer=AdamWConfig(lr=args.lr, warmup_steps=10,
                                  clip_norm=1.0),
            remat=not args.smoke), loss_fn=lm_loss)
        rng = np.random.default_rng(0)
        hist = []
        for _ in range(args.steps):
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq)))
            ref, ropt, m = step(ref, ropt, {"tokens": tok})
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
        init = init_model(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
        per_rank = [None] * world
        dist.all_gather_object(per_rank, shards(run, cfg))
        return {"mesh": run.mesh_dims, "history": run.history,
                "one_rank": hist, "errors": leaf_errors(full, ref),
                "moved": max(leaf_errors(full, init).values()),
                "shards": per_rank,
                "wk_spec": list(map(str, run.layout.specs["layers"]["attn"]
                                    ["wk"]))}

    def kind_batch(cfg, B, S, rng):
        batch = {
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S))),
            "old_logprobs": torch.zeros(B, S),
            "advantages": torch.from_numpy(
                rng.standard_normal((B, S)).astype(np.float32)),
            "loss_mask": torch.ones(B, S)}
        if cfg.kind == "vlm":
            batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
        if cfg.kind == "encdec":
            batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
        return batch

    def kind_case(case):
        cfg = get_config(case["arch"]).reduced()
        whole = init_model(torch.Generator().manual_seed(0), cfg,
                           torch.float32, "cpu")
        if cfg.kind == "vlm":  # open the cross layers (tanh(0) = 0)
            whole["cross_layers"]["gate"].fill_(0.5)
        ref = tree_map(torch.clone, whole)
        batch = kind_batch(cfg, 4, 16, np.random.default_rng(1))
        hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0))
        _, _, m1 = make_train_step(cfg, hp, policy_loss)(
            ref, init_adamw(ref), batch)
        mesh = make_local_mesh(model=2, data=2)
        layout = Layout(mesh, param_specs(mesh, cfg, whole))
        local = shard_params(whole, mesh, layout.specs)
        rows = T._local_rows(batch, mesh)
        _, _, m = make_train_step(cfg, hp, policy_loss, layout=layout)(
            local, init_adamw(local), rows)
        return {"loss": world_mean(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "one_rank": {"loss": float(m1["loss"]),
                             "grad_norm": float(m1["grad_norm"])}}

    def jax_case(case):
        cfg = get_config("yi-9b").reduced()
        template = init_model(None, cfg, torch.float32, "cpu")
        tree, _, _ = tck.load_checkpoint(case["weights"],
                                         {"params": template})
        whole = tree["params"]
        mesh = make_local_mesh(model=2, data=2)
        layout = Layout(mesh, param_specs(mesh, cfg, whole))
        local = shard_params(whole, mesh, layout.specs)
        tok = torch.from_numpy(np.load(case["tokens"]).astype(np.int64))
        rows = T._local_rows({"tokens": tok}, mesh)
        hp = TrainHParams(optimizer=AdamWConfig(
            lr=3e-4, warmup_steps=10, clip_norm=1.0))
        local, _, m = make_train_step(cfg, hp, lm_loss, layout=layout)(
            local, init_adamw(local), rows)
        full = layout.full(local, to_cpu=True)
        if rank == 0:
            tck.save_checkpoint(case["out"], {"params": full})
        return {"loss": world_mean(m["loss"]),
                "grad_norm": float(m["grad_norm"])}

    cases = json.loads(open(sys.argv[1]).read())
    out = {}
    for name, case in cases.items():
        out[name] = {"launch": launch_case, "kind": kind_case,
                     "jax": jax_case}[case["type"]](case)
    if rank == 0:
        print("RESULT " + json.dumps(out))
    dist.destroy_process_group()
""")


def _group(tmp: Path, n: int, cases: dict) -> dict:
    spec = tmp / "cases.json"
    spec.write_text(json.dumps(cases))
    runs = _ranks([sys.executable, "-c", _RANK, str(spec)], n,
                  tmp / "store", tmp)
    for rc, text in runs:
        assert rc == 0, text[-6000:]
    line = [x for x in runs[0][1].splitlines() if x.startswith("RESULT ")]
    assert len(line) == 1, runs[0][1][-6000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    return _group(tmp, 2, {
        "fsdp_2x1": {"type": "launch", "arch": "yi-9b", "argv": SMOKE},
        "tp_1x2": {"type": "launch", "arch": "yi-9b",
                   "argv": SMOKE + ["--model-axis", "2"]},
        "tp_1x2_bias_norm": {
            "type": "launch", "arch": "yi-9b",
            "replace": {"qkv_bias": True, "qk_norm": True},
            "argv": SMOKE + ["--model-axis", "2"]},
    })


def _jax_reference(tmp: Path):
    """JAX's reduced yi-9b weights bridged into the port's checkpoint, a
    batch, and JAX's one ``make_train_step`` with ``lm_loss`` on one CPU
    device from them: (loss, grad norm, params after the step)."""
    import jax
    import jax.numpy as jnp

    from repro import models as jmodels
    from repro.configs import get_config as jax_get_config
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrain
    from repro_torch.bridge import params_from_numpy

    jcfg = jax_get_config("yi-9b").reduced()
    jp = jmodels.init_model(jax.random.PRNGKey(11), jcfg)
    tck.save_checkpoint(str(tmp / "jax_init"), {"params": params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")})
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    hp = jtrain.TrainHParams(optimizer=jopt.AdamWConfig(
        lr=3e-4, warmup_steps=10, clip_norm=1.0))
    step = jax.jit(jtrain.make_train_step(jcfg, hp, loss_fn=jtrain.lm_loss))
    jp2, _, m = step(jp, jopt.init_adamw(jp), {"tokens": jnp.asarray(tokens)})
    return (float(m["loss"]), float(m["grad_norm"]),
            jax.tree.map(np.asarray, jp2))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    jloss, jnorm, jparams = _jax_reference(tmp)
    cases = {
        "tp_2x2": {"type": "launch", "arch": "yi-9b",
                   "argv": BASE + ["--model-axis", "2", "--checkpoint",
                                   str(tmp / "ck_2x2")]},
        "tp_2x1x2": {"type": "launch", "arch": "yi-9b",
                     "argv": SMOKE + ["--model-axis", "2", "--multi-pod"]},
        "tp_1x4": {"type": "launch", "arch": "yi-9b",
                   "argv": SMOKE + ["--model-axis", "4"]},
        "fsdp_4x1": {"type": "launch", "arch": "yi-9b", "argv": SMOKE},
        "jax_2x2": {"type": "jax", "weights": str(tmp / "jax_init"),
                    "tokens": str(tmp / "tokens.npy"),
                    "out": str(tmp / "jax_2x2_after")},
    }
    for arch in KINDS:
        cases[arch] = {"type": "kind", "arch": arch}
    out = _group(tmp, 4, cases)
    out["_tmp"] = str(tmp)
    out["_jax"] = {"loss": jloss, "grad_norm": jnorm, "params": jparams}
    return out


def _case(two, four, name):
    return (two if name in two else four)[name]


def _steps_agree(r, rtol):
    assert len(r["history"]) == len(r["one_rank"]) == 2
    for got, want in zip(r["history"], r["one_rank"]):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=rtol, abs=0), k
    worst = max(r["errors"].items(), key=lambda kv: kv[1])
    assert worst[1] <= rtol, worst
    assert r["moved"] > 1e-4  # the steps moved the weights


@pytest.mark.parametrize("name", ["fsdp_2x1", "fsdp_4x1"])
def test_fsdp_step_equals_one_rank_step(two, four, name):
    """FSDP (model axis 1): every leaf's d_model dimension sharded over
    "data", gathered a layer at a time and its gradient reduce-scattered
    back: every step's loss and grad norm within rtol 1e-6 of one
    rank's on the whole batch and every leaf within 1e-6 of its norm,
    the data-parallel test's bars (the shards' gradients add in another
    order; AdamW magnifies near-zero gradient elements)."""
    r = _case(two, four, name)
    assert r["mesh"] == {"data": int(name[-3]), "model": 1}
    _steps_agree(r, 1e-6)


@pytest.mark.parametrize("name", ["fsdp_2x1", "tp_1x2", "tp_2x2",
                                  "tp_2x1x2", "tp_1x4", "fsdp_4x1"])
def test_local_shards_are_the_specs_and_the_dry_run_bytes(two, four, name):
    """Each rank keeps ``shard_shape(mesh, shape, spec)`` of every leaf,
    and its params and AdamW moments (ZeRO: the moments mirror the
    shards) hold exactly the dry-run's bytes a device for its mesh
    (``train_state_bytes`` at f32, from ``per_device_bytes``)."""
    shards = _case(two, four, name)["shards"]
    assert len(shards) in (2, 4)
    for s in shards:
        assert s["shapes_ok"]
        assert s["bytes"] == s["dryrun_bytes"]
    whole = sum(x.numel() * 4 for x in tree_paths(init_model(
        torch.Generator().manual_seed(0), get_config("yi-9b").reduced(),
        torch.float32, "meta")).values()) * 3
    assert shards[0]["bytes"] < whole  # sharded, not whole


@pytest.mark.parametrize("name,mesh", [
    ("tp_1x2", {"data": 1, "model": 2}),
    ("tp_1x2_bias_norm", {"data": 1, "model": 2}),
    ("tp_2x2", {"data": 2, "model": 2}),
    ("tp_2x1x2", {"pod": 2, "data": 1, "model": 2}),
    ("tp_1x4", {"data": 1, "model": 4}),
])
def test_tensor_parallel_step_equals_one_rank_step(two, four, name, mesh):
    """Heads and d_ff split over "model" (column-parallel wq, wk, wv, gate,
    up; row-parallel wo, down; the input through "f", the output
    through "g"), FSDP and pods beside it: every step's loss and grad
    norm within rtol 1e-5 of one rank's, every leaf within 1e-5 of its
    norm.  A row-parallel product sums its partial sums over the model
    ranks in another order than one rank's product sums its terms.  A
    missing "f" leaves the norms' and biases' gradients partial: off by
    a factor, far past the bar."""
    r = _case(two, four, name)
    assert r["mesh"] == mesh
    _steps_agree(r, 1e-5)


def test_kv_heads_that_do_not_divide_the_model_axis_stay_whole(four):
    """The GQA trap: reduced yi-9b's 2 KV heads do not divide a model axis
    of 4, so ``spec_for`` keeps ``wk`` whole on "model" while its 4 query
    heads split one a rank; rank r's query head r reads KV head r // 2
    (its global index), which the (1, 4) step's equality to one rank's
    pins."""
    assert four["tp_1x4"]["wk_spec"] == ["None", "data", "None", "None"]
    assert four["tp_2x2"]["wk_spec"] == ["None", "data", "model", "None"]
    assert [tp_heads(4, 2, 4, r) for r in range(4)] == [
        (0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]


@pytest.mark.parametrize("H,KV,model,local", [
    (32, 4, 2, (16, 2)), (32, 4, 4, (8, 1)), (32, 4, 8, (4, 1)),
    (24, 8, 2, (12, 4)), (64, 8, 8, (8, 1)), (20, 20, 4, (5, 5))])
def test_tp_heads_local_counts_and_their_kv_heads(H, KV, model, local):
    """Every rank's query heads read the KV heads of their global index:
    yi-9b's 32 / 4 at model 2, 4, 8 give 16 / 2, 8 / 1 and 4 / 1 (the
    last with ``wk`` whole on "model" and two ranks a KV head)."""
    G = H // KV
    for r in range(model):
        h_lo, h_hi, kv_lo, kv_hi = tp_heads(H, KV, model, r)
        assert (h_hi - h_lo, kv_hi - kv_lo) == local
        Gl = (h_hi - h_lo) // (kv_hi - kv_lo)
        for j in range(h_hi - h_lo):  # the kernel's local map
            assert kv_lo + j // Gl == (h_lo + j) // G


def test_tp_heads_refuses_a_split_the_kernel_would_misread():
    """12 query heads over 4 KV heads (groups of 3) on 3 model ranks give
    4 a rank across two groups: the local map j // 2 would send local
    head 2 to the wrong KV head, so the layout raises (K106 in pass 3)."""
    with pytest.raises(ValueError, match="split groups"):
        tp_heads(12, 4, 3, 0)


@pytest.mark.parametrize("arch", KINDS)
def test_every_kind_steps_at_2x2_as_one_rank(four, arch):
    """The MoE (experts gathered whole, the dispatch on the whole batch's
    rows), SSM (the mixer whole), hybrid (the shared block split),
    encoder-decoder (encoder and cross-attention whole) and VLM (cross
    layers whole) kinds at (2, 2): step 1's loss and grad norm within
    the tensor-parallel bars of one rank's on the whole batch."""
    r = four[arch]
    for k in ("loss", "grad_norm"):
        assert r[k] == pytest.approx(r["one_rank"][k], rel=1e-5, abs=0), k


def test_2x2_step_from_jax_weights_matches_jax(four):
    """JAX's ``init_model`` weights bridged into the (2, 2) layout: step
    1's loss matches JAX's ``make_train_step`` with ``lm_loss`` on one
    CPU device at ``test_lm_loss_matches_jax``'s rtol 1e-5, the grad norm
    too, and the params after the step within
    ``test_adamw_update_matches_jax``'s tolerances."""
    r, j = four["jax_2x2"], four["_jax"]
    assert r["loss"] == pytest.approx(j["loss"], rel=1e-5, abs=0)
    assert r["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-5, abs=0)
    cfg = get_config("yi-9b").reduced()
    got, _, _ = tck.load_checkpoint(
        str(Path(four["_tmp"]) / "jax_2x2_after"),
        {"params": init_model(None, cfg, torch.float32, "cpu")})
    have, want = tree_paths(got["params"]), tree_paths(j["params"])
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_checkpoint_at_2x2_loads_into_one_rank_and_jax(four):
    """``--checkpoint`` at (2, 2) gathers the whole leaves to rank 0: the
    checkpoint loads into the one-rank run's template, its params within
    the tensor-parallel bar of the one-rank run's after the same steps,
    and into JAX's ``load_checkpoint`` (f32) bit for bit."""
    import jax

    from repro import models as jmodels
    from repro.configs import get_config as jax_get_config
    from repro.train import checkpoint as jck
    from repro.train import optimizer as jopt

    path = str(Path(four["_tmp"]) / "ck_2x2")
    cfg = get_config("yi-9b").reduced()
    args = launch_train.parse_args(BASE + ["--model-axis", "1"])
    one = launch_train.run(cfg, args)
    tree, step, meta = tck.load_checkpoint(path, {
        "params": init_model(None, cfg, torch.float32, "cpu"),
        "opt": init_adamw(init_model(None, cfg, torch.float32, "cpu"))})
    assert step == 2 and meta == {"arch": cfg.name}
    assert isinstance(tree["opt"], AdamWState) and tree["opt"].step == 2
    norm = torch.linalg.vector_norm
    want = tree_paths(one.params)
    for k, x in tree_paths(tree["params"]).items():
        assert norm(x - want[k]) <= 1e-5 * norm(want[k]), k
    jcfg = jax_get_config("yi-9b").reduced()
    jp = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    jtree, jstep, _ = jck.load_checkpoint(
        path, {"params": jp, "opt": jopt.init_adamw(jp)})
    assert jstep == 2 and int(jtree["opt"].step) == 2
    have = tree_paths(jax.tree.map(np.asarray, jtree))
    for k, x in tree_paths(tree).items():
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(have[k], x.numpy(), err_msg=k)


def test_launcher_command_line_with_a_model_axis_of_2(tmp_path):
    """``python -m repro_torch.launch.train --arch yi-9b --smoke --device
    cpu --model-axis 2`` under a 2-rank gloo group: the (1, 2) mesh, both
    ranks through to the end (nothing refuses a model axis above 1)."""
    runs = _ranks([sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", "yi-9b", "--smoke", "--device", "cpu",
                   "--model-axis", "2", "--steps", "2", "--batch", "2",
                   "--seq", "16"], 2, tmp_path / "store", tmp_path)
    for rc, text in runs:
        assert rc == 0, text
    assert "mesh={'data': 1, 'model': 2}" in runs[0][1]
    assert "step 1" in runs[0][1] and "tok/s" in runs[0][1]


def test_mesh_that_the_world_does_not_make_raises():
    """One process cannot hold a model axis of 2 or a pod axis of 2: a
    ValueError names the world and the axes (no process group starts)."""
    with pytest.raises(ValueError, match="multiple of 2"):
        launch_train.layout_mesh(1, 2, False, "cpu")
    with pytest.raises(ValueError, match="pod 2"):
        launch_train.layout_mesh(1, 1, True, "cpu")
