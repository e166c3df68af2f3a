"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, nor any third-party module the card's
machine lacks (only torch, numpy, triton and the standard library), the
port's entry points never fall back to the CPU on their own, and the
kernel dispatch has no fallback path."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "multicard_smoke.py"]


def _banned(name: str) -> bool:
    """jax, jax.*, repro and repro.* -- but not repro_torch."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


# what the card's machine has besides the standard library (it has no JAX,
# networkx or msgpack); scipy, einops, pytest and hypothesis are there for
# tests, which the port's package does not import
ALLOWED_THIRD_PARTY = ("torch", "numpy", "triton", "repro_torch")


def _allowed(name: str) -> bool:
    top = name.split(".")[0]
    return top in ALLOWED_THIRD_PARTY or top in sys.stdlib_module_names


def test_banned_pattern_tells_repro_torch_apart():
    assert _banned("repro") and _banned("repro.serve") and _banned("jax.numpy")
    assert not _banned("repro_torch") and not _banned("repro_torch.serve")


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path) if m and _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_allowed_pattern_knows_the_card_machines_modules():
    assert _allowed("torch.nn") and _allowed("numpy") and _allowed("triton")
    assert _allowed("itertools") and _allowed("concurrent.futures")
    assert _allowed("repro_torch.core.flowgraph")
    assert not _allowed("networkx") and not _allowed("msgpack")
    assert not _allowed("jax") and not _allowed("scipy")


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_only_torch_numpy_triton_and_stdlib(path):
    bad = [m for m in _imports(path) if m and not _allowed(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.serve, repro_torch.bridge, repro_torch.models\n"
        "import repro_torch.models.moe, repro_torch.kernels.moe_gmm\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.train, repro_torch.rl.advantage\n"
        "import repro_torch.utils.treeutil, repro_torch.utils.logging\n"
        "import repro_torch.core, repro_torch.comm, repro_torch.obs\n"
        "import repro_torch.rl, repro_torch.train.data\n"
        "import repro_torch.configs as c; c.get_config('yi-9b')\n"
        "import repro_torch.analysis.kernel_checks\n"
        "import repro_torch.analysis.__main__, repro_torch.configs.shapes\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.cluster\n"
        "import repro_torch.train.sharding_rules, repro_torch.utils.sharding\n"
        "import repro_torch.utils.roofline, repro_torch.utils.hardware\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_runtime_entry_points_raise_without_cuda_and_no_device(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import Worker
    from repro_torch.rl import (
        EmbodiedPPOConfig,
        EmbodiedPPORunner,
        GRPOConfig,
        GRPORunner,
        PPOConfig,
        RLHFRunner,
    )
    from repro_torch.rl.workers import ActorWorker, RolloutWorker
    from repro_torch.serve import Engine
    from repro_torch.train import TrainHParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b").reduced()
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        GRPORunner(cfg, rl)
    with pytest.raises(RuntimeError, match="CUDA"):
        RLHFRunner(cfg, PPOConfig(batch_size=8, iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbodiedPPORunner(EmbodiedPPOConfig(num_envs=4, iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
    assert Engine(cfg, device="cpu").device.type == "cpu"
    assert RLHFRunner(cfg, PPOConfig(batch_size=8, iterations=1),
                      device="cpu").reference.device.type == "cpu"
    assert EmbodiedPPORunner(EmbodiedPPOConfig(num_envs=4, iterations=1),
                             device="cpu").policy.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutWorker("r/0", cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ActorWorker("a/0", cfg=cfg, hp=TrainHParams())
    w = Worker("w/0", devices=(0,))  # a worker resolves its device lazily
    with pytest.raises(RuntimeError, match="CUDA"):
        w.device
    w.shutdown()
    assert GRPORunner(cfg, rl, device="cpu").actor.device.type == "cpu"


def test_entry_points_raise_without_cuda_and_no_device(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import PagedEngine, init_paged_cache
    from repro_torch.train import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(1, 2, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(None, cfg)
    # naming the CPU is the only way there
    assert PagedEngine(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", ["ops.py", "paged_attention.py",
                                    "sampling.py", "flash_attention.py",
                                    "moe_gmm.py"])
def test_kernel_dispatch_has_no_fallback(module):
    tree = ast.parse((PORT / "kernels" / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _calls(path: Path):
    """(dotted callee, node) of every call in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield ast.unparse(node.func), node


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_writes_no_environment_variable(path):
    """No module of the port (nor chip_smoke.py) sets an environment
    variable: ``os.environ`` is read only."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, (ast.AugAssign,
                                                      ast.AnnAssign))
                   else [])
        for t in targets:
            if isinstance(t, ast.Subscript) and \
                    ast.unparse(t.value) == "os.environ":
                bad.append(ast.unparse(t))
        if isinstance(node, ast.Delete):
            bad += [ast.unparse(t) for t in node.targets
                    if "os.environ" in ast.unparse(t)]
    bad += [name for name, _ in _calls(path)
            if name in ("os.putenv", "os.unsetenv", "os.environ.update",
                        "os.environ.setdefault", "os.environ.pop",
                        "os.environ.clear")]
    assert not bad, f"{path.relative_to(ROOT)} writes {bad}"


def test_only_the_cluster_module_initializes_a_process_group():
    """``launch.cluster.maybe_init_distributed`` is the one place that
    starts a ``torch.distributed`` process group."""
    where = sorted(str(p.relative_to(ROOT)) for p in SCANNED
                   for name, _ in _calls(p)
                   if name.endswith("init_process_group"))
    assert where == ["src/repro_torch/launch/cluster.py"], where
