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
import dataclasses
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
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as T
    from repro_torch.launch.cluster import maybe_init_distributed
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_model
    from repro_torch.models import model as M
    from repro_torch.models.layers import (NEG_INF, VocabShard,
                                           token_entropy, token_logprobs)
    from repro_torch.train import checkpoint as tck
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.parallel import (Layout, ModelParallel,
                                            shard_params)
    from repro_torch.train.sharding_rules import param_specs
    from repro_torch.train.trainer import (TrainHParams, lm_loss,
                                           make_train_step, policy_loss)
    from repro_torch.utils.sharding import shard_shape, spec_axes
    from repro_torch.utils.treeutil import (tree_leaves, tree_map,
                                            tree_paths, tree_unflatten)

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

    def kind_config(case):
        cfg = get_config(case["arch"]).reduced()
        if case.get("moe"):
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      **case["moe"]))
        return cfg

    class Seen:
        '''The shapes the compute sees while in use: K3's (query heads,
        KV heads, causal), K6's heads, the expert products' weights.'''

        def __init__(self):
            self.flash, self.ssd, self.bmm = set(), set(), set()

        def __enter__(self):
            self.saved = (kops.flash_attention, kops.ssd_scan, torch.bmm)
            fa, ssd, bmm = self.saved

            def flash(q, k, v, **kw):
                self.flash.add((q.shape[2], k.shape[2],
                                kw.get("causal", True)))
                return fa(q, k, v, **kw)

            def scan(x, *a, **kw):
                self.ssd.add(x.shape[2])
                return ssd(x, *a, **kw)

            def mm(a, b, **kw):
                self.bmm.add(tuple(b.shape))
                return bmm(a, b, **kw)

            kops.flash_attention, kops.ssd_scan, torch.bmm = flash, scan, mm
            return self

        def __exit__(self, *exc):
            kops.flash_attention, kops.ssd_scan, torch.bmm = self.saved

        def dump(self):
            return {k: sorted(getattr(self, k))
                    for k in ("flash", "ssd", "bmm")}

    def model_gathered(layout, local):
        '''The leaves the layout hands the compute whole over "model":
        a dimension their spec puts on "model" at its whole size.'''
        groups = [(("embed",), {k: v}) for k, v in local["embed"].items()]
        for name in ("layers", "shared_attn", "cross_layers",
                     "enc_layers"):
            if name in local:
                tree = (local[name] if name == "shared_attn"
                        else M.unstack_layers(local[name])[0])
                groups.append(((name,), tree))
        out = set()
        for path, tree in groups:
            have = tree_paths(tree)
            for k, x in tree_paths(layout.gather(tree, *path)).items():
                if not isinstance(x, torch.Tensor) or k not in have:
                    continue
                spec = layout._spec(path + tuple(k.strip("/").split("/")))
                axes = spec_axes(spec)[len(spec) - x.dim():]
                for d, a in enumerate(axes):
                    if "model" in a and x.shape[d] != have[k].shape[d]:
                        out.add(k.strip("/"))
        return sorted(out)

    def kind_grads(cfg, hp, params, batch, gather=None):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        kw = {} if gather is None else {"gather": gather}
        loss, _ = policy_loss(cfg, hp, live, batch, **kw)
        return tree_unflatten(params, list(torch.autograd.grad(
            loss, tree_leaves(live))))

    def kind_case(case):
        cfg = kind_config(case)
        whole = init_model(torch.Generator().manual_seed(0), cfg,
                           torch.float32, "cpu")
        if cfg.kind == "vlm":  # open the cross layers (tanh(0) = 0)
            whole["cross_layers"]["gate"].fill_(0.5)
        ref = tree_map(torch.clone, whole)
        batch = kind_batch(cfg, 4, 16, np.random.default_rng(1))
        hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0),
                          entropy_coef=0.01)
        g1 = kind_grads(cfg, hp, whole, batch)
        g64 = None if cfg.moe is not None else kind_grads(
            cfg, hp, tree_map(lambda x: x.double(), whole),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()})
        _, _, m1 = make_train_step(cfg, hp, policy_loss)(
            ref, init_adamw(ref), batch)
        data, model = case.get("mesh", (2, 2))
        mesh = make_local_mesh(model=model, data=data)
        layout = Layout(mesh, param_specs(mesh, cfg, whole))
        local = shard_params(whole, mesh, layout.specs)
        rows = T._local_rows(batch, mesh)
        g2 = layout.full(layout.reduce(kind_grads(cfg, hp, local, rows,
                                                  layout.gather)))
        extra = {k: rows[k] for k in ("image_embeds", "frame_embeds")
                 if k in rows}
        with torch.no_grad():
            logits, _ = M.forward(local, cfg, rows["tokens"], extra or None,
                                  gather=layout.gather)
        gathered = model_gathered(layout, local)
        with Seen() as seen:
            _, _, m = make_train_step(cfg, hp, policy_loss, layout=layout)(
                local, init_adamw(local), rows)
        return {"loss": world_mean(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "one_rank": {"loss": float(m1["loss"]),
                             "grad_norm": float(m1["grad_norm"])},
                "grad_errors": leaf_errors(g2, g1),
                "f64_errors": None if g64 is None else {
                    "one_rank": leaf_errors(g1, g64),
                    "split": leaf_errors(g2, g64)},
                "logits": [type(logits).__name__,
                           getattr(logits, "local", logits).shape[-1]],
                "gathered": gathered,
                "seen": gathered_all(seen.dump())}

    def gathered_all(value):
        out = [None] * world
        dist.all_gather_object(out, value)
        return out

    def vocab_case(case):
        '''The vocab-parallel log-softmax and entropy on (1, world): rank
        r's slice of random logits over a padded vocabulary of 2048 with
        1000 real entries (rank 1's slice part padding, ranks 2 and 3
        all padding) against ``token_logprobs`` and ``log_softmax`` on
        the whole, values and gradients.'''
        V, vocab = 2048, 1000
        mesh = make_local_mesh(model=world, data=1)
        tp = ModelParallel(mesh.get_group("model"), rank, world)
        g = torch.Generator().manual_seed(3)
        logits = 3 * torch.randn(3, 7, V, generator=g)
        tokens = torch.randint(0, vocab, (3, 7), generator=g)
        tokens[0, :world] = torch.arange(world) * (vocab // world)
        w_lp, w_ent = torch.randn(2, 3, 7, generator=g)
        whole = logits.clone().requires_grad_()
        lp = token_logprobs(whole, tokens, vocab)
        masked = torch.where(torch.arange(V) < vocab, whole, NEG_INF)
        logp = torch.log_softmax(masked, dim=-1)
        ent = -(torch.exp(logp) * logp).sum(-1)
        (w_lp * lp + w_ent * ent).sum().backward()
        n = V // world
        local = logits[..., rank * n:(rank + 1) * n].clone().requires_grad_()
        shard = VocabShard(local, tp)[:, :]
        lp2 = token_logprobs(shard, tokens, vocab)
        ent2 = token_entropy(shard, vocab)
        (w_lp * lp2 + w_ent * ent2).sum().backward()
        want = whole.grad[..., rank * n:(rank + 1) * n]
        scale = float(whole.grad.abs().max())
        errs = {"lp": float((lp2 - lp).abs().max()),
                "entropy": float((ent2 - ent).abs().max()),
                "grad": float((local.grad - want).abs().max()) / scale,
                "padding": rank * n >= vocab,
                "grad_in_padding": float(local.grad[
                    ..., max(vocab - rank * n, 0):].abs().max()
                    if rank * n + n > vocab else 0.0)}
        return gathered_all(errs)

    def jax_case(case):
        cfg = get_config(case["arch"]).reduced()
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
        grads = {}
        for name, params, gather, batch in (
                ("split", local, layout.gather, rows),
                ("one", whole, None, {"tokens": tok})):
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = lm_loss(cfg, hp, live, batch, gather=gather)
            grads[name] = tree_unflatten(params, list(
                torch.autograd.grad(loss, tree_leaves(live))))
        grads["split"] = layout.full(layout.reduce(grads["split"]),
                                     to_cpu=True)
        local, _, m = make_train_step(cfg, hp, lm_loss, layout=layout)(
            local, init_adamw(local), rows)
        full = layout.full(local, to_cpu=True)
        if rank == 0:
            tck.save_checkpoint(case["out"], {
                "params": full, "grads": grads["split"],
                "one_rank_grads": grads["one"]})
        return {"loss": world_mean(m["loss"]),
                "grad_norm": float(m["grad_norm"])}

    cases = json.loads(open(sys.argv[1]).read())
    out = {}
    for name, case in cases.items():
        out[name] = {"launch": launch_case, "kind": kind_case,
                     "jax": jax_case, "vocab": vocab_case}[case["type"]](
                         case)
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


JAX_ARCHS = ["yi-9b", "granite-moe-3b-a800m", "mamba2-370m"]


def _jax_reference(tmp: Path, arch: str):
    """JAX's reduced ``arch`` weights bridged into the port's checkpoint,
    a batch, and JAX's one ``make_train_step`` with ``lm_loss`` on one
    CPU device from them: (loss, grad norm, params after the step, the
    gradient of ``lm_loss``)."""
    import jax
    import jax.numpy as jnp

    from repro import models as jmodels
    from repro.configs import get_config as jax_get_config
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrain
    from repro_torch.bridge import params_from_numpy

    jcfg = jax_get_config(arch).reduced()
    jp = jmodels.init_model(jax.random.PRNGKey(11), jcfg)
    tck.save_checkpoint(str(tmp / f"jax_init_{arch}"), {
        "params": params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")})
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    np.save(tmp / f"tokens_{arch}.npy", tokens)
    hp = jtrain.TrainHParams(optimizer=jopt.AdamWConfig(
        lr=3e-4, warmup_steps=10, clip_norm=1.0))
    batch = {"tokens": jnp.asarray(tokens)}
    step = jax.jit(jtrain.make_train_step(jcfg, hp, loss_fn=jtrain.lm_loss))
    jp2, _, m = step(jp, jopt.init_adamw(jp), batch)
    grads = jax.jit(jax.grad(
        lambda p: jtrain.lm_loss(jcfg, hp, p, batch)[0]))(jp)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": jax.tree.map(np.asarray, jp2),
            "grads": jax.tree.map(np.asarray, grads)}


# the kinds' cases at (data, model): every kind at (2, 2) and (1, 4), the
# MoE's d_ff branch (2 experts do not divide 4; a shared expert beside)
KIND_CASES = {f"{arch}@{d}x{m}": {"type": "kind", "arch": arch,
                                  "mesh": [d, m]}
              for d, m in ((2, 2), (1, 4)) for arch in ["yi-9b"] + KINDS}
KIND_CASES["granite-moe-dff@1x4"] = {
    "type": "kind", "arch": "granite-moe-3b-a800m", "mesh": [1, 4],
    "moe": {"num_experts": 2, "shared_expert_d_ff": 128}}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    jax = {arch: _jax_reference(tmp, arch) for arch in JAX_ARCHS}
    cases = {
        "tp_2x2": {"type": "launch", "arch": "yi-9b",
                   "argv": BASE + ["--model-axis", "2", "--checkpoint",
                                   str(tmp / "ck_2x2")]},
        "tp_2x1x2": {"type": "launch", "arch": "yi-9b",
                     "argv": SMOKE + ["--model-axis", "2", "--multi-pod"]},
        "tp_1x4": {"type": "launch", "arch": "yi-9b",
                   "argv": SMOKE + ["--model-axis", "4"]},
        "fsdp_4x1": {"type": "launch", "arch": "yi-9b", "argv": SMOKE},
        "vocab_1x4": {"type": "vocab"},
    }
    for arch in JAX_ARCHS:
        cases[f"jax_{arch}"] = {
            "type": "jax", "arch": arch,
            "weights": str(tmp / f"jax_init_{arch}"),
            "tokens": str(tmp / f"tokens_{arch}.npy"),
            "out": str(tmp / f"jax_2x2_after_{arch}")}
    cases.update(KIND_CASES)
    out = _group(tmp, 4, cases)
    out["_tmp"] = str(tmp)
    out["_jax"] = jax
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


def _kind_agrees(r):
    """Step 1's loss and grad norm within rtol 1e-5 of one rank's on the
    whole batch, and every leaf of the step's gradient (reduced, gathered
    whole) within 1e-5 of its norm.  The gradient, not the params after
    the step: AdamW's first step divides each element by its own size
    plus 1e-8, so elements below 1e-8 (zamba2's ``conv_b`` holds some at
    3e-9) carry their last bits' reordering into the params 1e4-fold."""
    for k in ("loss", "grad_norm"):
        assert r[k] == pytest.approx(r["one_rank"][k], rel=1e-5, abs=0), k
    worst = max(r["grad_errors"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-5, worst


@pytest.mark.parametrize("arch", ["yi-9b"] + KINDS)
def test_every_kind_steps_at_2x2_as_one_rank(four, arch):
    """Every kind at (2, 2), its compute split over "model" wherever the
    rules store a leaf split (the vocabulary, heads, d_ff, experts, SSM
    heads, the encoder, cross-attention), the MoE's dispatch on the whole
    batch's rows, ``policy_loss`` with its entropy term: within the
    tensor-parallel bars of one rank's step (:func:`_kind_agrees`)."""
    _kind_agrees(four[f"{arch}@2x2"])


@pytest.mark.parametrize("arch", ["yi-9b"] + KINDS + ["granite-moe-dff"])
def test_every_kind_steps_at_1x4_as_one_rank(four, arch):
    """Every kind at (1, 4) (reduced yi-9b's 2 KV heads whole on a model
    axis of 4; ``granite-moe-dff``: 2 experts that 4 does not divide, so
    each expert's d_ff splits, and a shared expert): within the
    tensor-parallel bars of one rank's step."""
    _kind_agrees(four[f"{arch}@1x4"])


@pytest.mark.parametrize("name", sorted(
    k for k in KIND_CASES if not k.startswith("granite")))
def test_split_gradient_rounds_as_one_rank_against_f64(four, name):
    """Against one rank's gradient in f64, every leaf of the split
    gradient is within twice one rank's own f32 distance, or 1e-6 of its
    norm: the split reorders sums (the norm's sum of squares, the heads'
    share of B and C, the row-parallel partial sums) no worse than one
    rank's f32 rounds them.  A leaf whose gradient sums with heavy
    cancellation (``A_log``, one value a head over every token) sits
    near 1e-5 from f64 in both, which four microbatches of one rank do
    not show (they reorder only the sum over rows).  Not for the MoE,
    whose routing f64 may change."""
    r = four[name]["f64_errors"]
    for k, e in r["split"].items():
        assert e <= max(2 * r["one_rank"][k], 1e-6), (k, e, r["one_rank"][k])


def _kind_config(name):
    cfg = get_config(KIND_CASES[name]["arch"]).reduced()
    moe = KIND_CASES[name].get("moe")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)) if moe \
        else cfg


@pytest.mark.parametrize("name", sorted(KIND_CASES))
def test_model_axis_splits_the_compute(four, name):
    """The split is real: on every rank the logits cover V / m of the
    padded vocabulary (a ``VocabShard``), K3's plain version sees H / m
    query heads (bidirectional in whisper's encoder), K6's nh / m heads,
    the expert products E / m experts (or every expert's d_ff / m), and
    the layout hands no leaf whole over "model" but a mixer's
    ``in_proj``, ``conv_w`` and ``conv_b``."""
    r, cfg = four[name], _kind_config(name)
    m = KIND_CASES[name]["mesh"][1]
    assert r["logits"] == ["VocabShard", cfg.padded_vocab // m]
    ssm = cfg.kind in ("ssm", "hybrid")
    assert r["gathered"] == (["mixer/conv_b", "mixer/conv_w",
                              "mixer/in_proj"] if ssm else [])
    for seen in r["seen"]:
        flash = seen["flash"]
        assert (not flash) == (cfg.kind == "ssm"), flash
        assert {h for h, _, _ in flash} <= {cfg.num_heads // m}, flash
        causal = {c for _, _, c in flash}
        assert causal == ({True, False} if cfg.kind == "encdec"
                          else set() if cfg.kind == "ssm" else {True})
        assert seen["ssd"] == ([cfg.num_ssm_heads // m] if ssm else [])
        if cfg.moe is not None:
            E, d, f = (cfg.moe.num_experts, cfg.d_model,
                       cfg.moe.expert_d_ff)
            want = ([[E // m, d, f], [E // m, f, d]] if E % m == 0
                    else [[E, d, f // m], [E, f // m, d]])
            assert sorted(seen["bmm"]) == sorted(want)


def test_vocab_parallel_log_softmax_matches_the_whole_vocab(four):
    """The vocab-parallel log-softmax on (1, 4) over a padded vocabulary of
    2048 with 1000 real entries (rank 1's slice part padding, ranks 2
    and 3 all padding): each rank's log-probabilities and entropies equal
    ``token_logprobs`` and an entropy from ``log_softmax`` on the whole
    vocabulary within 1e-5, and its slice of their weighted sum's
    gradient within 1e-5 of the largest, zero in the padding."""
    ranks = four["vocab_1x4"]
    assert [r["padding"] for r in ranks] == [False, False, True, True]
    for r in ranks:
        assert r["lp"] <= 1e-5 and r["entropy"] <= 1e-5, r
        assert r["grad"] <= 1e-5 and r["grad_in_padding"] == 0.0, r


def test_vocab_shard_is_read_only_through_the_log_softmax():
    """Logits split over the vocabulary are no tensor: indexing the
    leading dimensions keeps the slice and its offset, indexing into
    the vocabulary or reading them as a tensor raises."""
    from repro_torch.models.layers import VocabShard
    from repro_torch.train.parallel import ModelParallel

    shard = VocabShard(torch.zeros(2, 5, 8), ModelParallel(None, 3, 4))
    assert shard.offset == 24
    assert tuple(shard[:, :-1].local.shape) == (2, 4, 8)
    with pytest.raises(IndexError, match="vocabulary"):
        shard[..., :4]
    with pytest.raises(IndexError, match="vocabulary"):
        shard[:, :, 0]
    with pytest.raises(AttributeError):
        shard.float()


# Below this size of JAX's gradient element, the params after JAX's step
# are not held elementwise: AdamW's first step moves an element by
# lr g / (|g| + eps), eps 1e-8, so near eps it turns on the gradient's
# last bits, and one rank of the port misses 1-2 such elements of
# granite-moe's and mamba2's leaves too (gradients of 2e-9 to 4e-8).
# The gradient check holds them.  yi-9b holds every element.
JAX_STEP_EPS_ZONE = {"yi-9b": 0.0, "granite-moe-3b-a800m": 1e-7,
                     "mamba2-370m": 1e-7}


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_2x2_step_from_jax_weights_matches_jax(four, arch):
    """JAX's ``init_model`` weights bridged into the (2, 2) layout (yi-9b,
    granite-moe's experts split over "model", mamba2's SSM heads): step
    1's loss matches JAX's ``make_train_step`` with ``lm_loss`` on one
    CPU device at ``test_lm_loss_matches_jax``'s rtol 1e-5, the grad norm
    too; the gradient of ``lm_loss`` each leaf within 1e-5 of the norm of
    ``jax.grad``'s, or twice one rank of the port's own distance from it
    where that is larger (mamba2's ``A_log``, one value a head summed
    over every token: 1.2-1.5e-5 from JAX for both); the params after
    the step within ``test_adamw_update_matches_jax``'s tolerances at
    every element whose JAX gradient is at least ``JAX_STEP_EPS_ZONE``."""
    r, j = four[f"jax_{arch}"], four["_jax"][arch]
    assert r["loss"] == pytest.approx(j["loss"], rel=1e-5, abs=0)
    assert r["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-5, abs=0)
    cfg = get_config(arch).reduced()
    template = init_model(None, cfg, torch.float32, "cpu")
    names = ("params", "grads", "one_rank_grads")
    got, _, _ = tck.load_checkpoint(
        str(Path(four["_tmp"]) / f"jax_2x2_after_{arch}"),
        {k: template for k in names})
    have, grads, one = (tree_paths(got[k]) for k in names)
    want, jgrads = tree_paths(j["params"]), tree_paths(j["grads"])
    assert have.keys() == want.keys() == grads.keys() == jgrads.keys()
    norm = np.linalg.norm
    for k in want:
        bar = max(1e-5 * norm(jgrads[k]),
                  2 * norm(one[k].numpy() - jgrads[k]))
        assert norm(grads[k].numpy() - jgrads[k]) <= bar, k
        held = np.abs(jgrads[k]) >= JAX_STEP_EPS_ZONE[arch]
        np.testing.assert_allclose(have[k].numpy()[held], want[k][held],
                                   atol=1e-6, rtol=1e-5, err_msg=k)


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


def _misses(cfg, model):
    """``model_axis_misses`` of ``cfg`` cut to one layer (a group of a
    hybrid or VLM stack; the misses do not depend on depth) on a mesh of
    (1, model)."""
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.train.sharding_rules import model_axis_misses
    from repro_torch.utils.sharding import LogicalMesh

    cfg = cfg.replace(num_layers=cfg.attn_every or cfg.cross_attn_every or 1,
                      num_encoder_layers=min(cfg.num_encoder_layers, 1))
    return model_axis_misses(LogicalMesh(("data", "model"), (1, model)),
                             cfg, meta_params(cfg))


@pytest.mark.parametrize("arch,model,leaf", [
    ("whisper-large-v3", 8, "/layers/attn/wq"),  # 20 heads
    ("mamba2-370m", 32, "/layers/mixer/out_proj"),  # reduced: 16 SSM heads
    ("granite-moe-3b-a800m", 256, "/layers/moe/gate"),  # 4 experts, d_ff 128
])
def test_a_model_axis_the_rules_cannot_honour_is_named(arch, model, leaf):
    """``model_axis_misses`` (the launcher refuses a mesh that has any)
    names the leaves whose compute a model axis cannot split: the rules
    would keep them whole there."""
    cfg = get_config(arch)
    assert leaf in _misses(cfg if model == 8 else cfg.reduced(), model)


def test_the_zoo_kinds_split_at_model_axes_of_2_and_4():
    """No kind of the zoo misses at a model axis of 2 or 4, full size or
    reduced, nor yi-9b at 8, whose 4 KV heads stay whole beside split
    query heads (each rank reads the ones its queries map to)."""
    for name in ["yi-9b"] + KINDS:
        for cfg in (get_config(name), get_config(name).reduced()):
            for m in (2, 4):
                assert _misses(cfg, m) == [], (cfg.name, m)
    assert _misses(get_config("yi-9b"), 8) == []


def test_mesh_that_the_world_does_not_make_raises():
    """One process cannot hold a model axis of 2 or a pod axis of 2: a
    ValueError names the world and the axes (no process group starts)."""
    with pytest.raises(ValueError, match="multiple of 2"):
        launch_train.layout_mesh(1, 2, False, "cpu")
    with pytest.raises(ValueError, match="pod 2"):
        launch_train.layout_mesh(1, 1, True, "cpu")
