"""The port's sharding rules (``repro_torch.train.sharding_rules``,
``utils.sharding``) against the JAX package's: for every arch of the
zoo, ``param_specs``, ``decode_state_specs``, ``batch_spec`` and
``array_batch_specs`` equal JAX's on (2, 8) and (16, 16) meshes.  The
JAX side runs in a subprocess with forced host devices (as
``tests/test_hlo_and_sharding.py`` does), so this process keeps its one
CPU device; the port's side needs no devices (a ``LogicalMesh`` and
meta tensors)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_model
from repro_torch.models import model as M
from repro_torch.train import sharding_rules as R
from repro_torch.utils import sharding as S

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x8": (2, 8), "16x16": (16, 16)}
DECODE = (16, 4096)  # batch, cache length
BATCHES = (1, 2, 8, 16, 24, 256)

_JAX = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config, list_archs
    from repro.models import model as M
    from repro.train.sharding_rules import (
        array_batch_specs, batch_spec, decode_state_specs, param_specs)

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    def flat(tree, prefix="", out=None):
        out = {} if out is None else out
        if isinstance(tree, P):
            out[prefix] = [entry(e) for e in tree]
        elif isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f"{prefix}/{k}", out)
        elif hasattr(tree, "_fields"):
            for f in tree._fields:
                flat(getattr(tree, f), f"{prefix}/{f}", out)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                flat(v, f"{prefix}/{i}", out)
        return out

    B, W = %(decode)r
    out = {}
    for name, shape in %(meshes)r.items():
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        res = out[name] = {}
        for arch in list_archs():
            cfg = get_config(arch)
            sds = jax.eval_shape(lambda: M.init_model(
                jax.random.PRNGKey(0), cfg, jnp.bfloat16))
            st = jax.eval_shape(lambda: M.init_decode_state(
                cfg, B, W, jnp.bfloat16))
            res[arch] = {"params": flat(param_specs(mesh, cfg, sds)),
                         "decode": flat(decode_state_specs(mesh, cfg, st))}
        res["batch"] = {str(b): [entry(e) for e in batch_spec(mesh, b)]
                        for b in %(batches)r}
        res["arrays"] = flat(array_batch_specs(mesh, {
            "tokens": jax.ShapeDtypeStruct((16, 32), jnp.int32),
            "odd": jax.ShapeDtypeStruct((3, 5, 2), jnp.float32),
            "scalar": jax.ShapeDtypeStruct((), jnp.float32)}))
    print("JSON" + json.dumps(out))
""") % {"decode": DECODE, "meshes": MESHES, "batches": BATCHES}


@pytest.fixture(scope="module")
def jax_specs():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _JAX], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    line = [l for l in out.stdout.splitlines() if l.startswith("JSON")]
    assert out.returncode == 0 and line, out.stdout + out.stderr
    return json.loads(line[0][4:])


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _flat(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, S.PartitionSpec):
        out[prefix] = [_entry(e) for e in tree]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _flat(getattr(tree, f), f"{prefix}/{f}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    return out


def _mesh(name):
    return S.LogicalMesh(("data", "model"), MESHES[name])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_decode_specs_equal_jax(jax_specs, arch, mesh):
    cfg = get_config(arch)
    params = init_model(torch.Generator().manual_seed(0), cfg,
                        torch.bfloat16, "meta")
    state = M.init_decode_state(cfg, *DECODE, torch.bfloat16, "meta")
    want = jax_specs[mesh][arch]
    assert _flat(R.param_specs(_mesh(mesh), cfg, params)) == want["params"]
    assert _flat(R.decode_state_specs(_mesh(mesh), cfg, state)) \
        == want["decode"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_jax(jax_specs, mesh):
    m = _mesh(mesh)
    assert {str(b): [_entry(e) for e in R.batch_spec(m, b)]
            for b in BATCHES} == jax_specs[mesh]["batch"]
    arrays = {"tokens": torch.empty((16, 32), device="meta"),
              "odd": torch.empty((3, 5, 2), device="meta"),
              "scalar": torch.empty((), device="meta")}
    assert _flat(R.array_batch_specs(m, arrays)) == jax_specs[mesh]["arrays"]


def test_specs_read_only_names_and_sizes():
    """A DeviceMesh-like object and a LogicalMesh of the same axes give
    the same specs: the rules never touch devices."""
    class FakeDeviceMesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.empty((2, 16, 16), device="meta")

    pod = S.LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    assert S.mesh_shape(FakeDeviceMesh()) == pod.shape
    assert S.batch_axes(pod) == ("pod", "data")
    assert S.maybe_axis(pod, 16, ("pod", "data")) == "pod"
    assert S.maybe_axis(pod, 64, ("pod", "data")) == ("pod", "data")
    assert S.maybe_axis(pod, 3, ("pod", "data")) is None
    assert S.spec_for(pod, (64, 24), (("pod", "data"), "model")) \
        == S.P(("pod", "data"), None)
    assert S.shard_shape(pod, (64, 32), S.P(("pod", "data"), "model")) \
        == (2, 2)
    assert S.bytes_of({"a": torch.empty((4, 4), device="meta"),
                       "b": (torch.empty(2, dtype=torch.bfloat16,
                                         device="meta"),)}) == 64 + 4
