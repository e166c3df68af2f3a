"""The port's GRPO runner learns on the CPU: the counterpart of the JAX
package's end-to-end learning check (``test_grpo_runner_learns_on_tiny_task``
in tests/test_rl.py), with its recipe and its bar, in a file of its own so
that it has a test worker to itself."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.rl import GRPOConfig, GRPORunner
from repro_torch.train import AdamWConfig, TrainHParams

torch.set_num_threads(1)


def test_grpo_runner_learns_on_tiny_task():
    """80 iterations must lift train accuracy well above random on
    single-digit addition."""
    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256)
    rl = GRPOConfig(batch_size=32, group_size=8, iterations=80,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(8,))
    runner = GRPORunner(
        cfg, rl, TrainHParams(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0),
                              entropy_coef=0.02), device="cpu")
    runner.data.max_operand = 3  # single-digit-answer curriculum
    runner.data.add_only = True
    stats = runner.run(verbose=False)
    first = np.mean([s.accuracy for s in stats[:10]])
    last = np.mean([s.accuracy for s in stats[-10:]])
    assert last > first + 0.1, (first, last)


def test_async_offpolicy_mode_learns_and_ratios_drift():
    """AReaL-style 1-step-stale rollouts (the JAX test's recipe and bar):
    the PPO ratios must move off 1 (staleness is real) yet training still
    improves accuracy."""
    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256)
    rl = GRPOConfig(batch_size=32, group_size=8, iterations=50,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(8,), async_offpolicy=True)
    runner = GRPORunner(
        cfg, rl, TrainHParams(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0),
                              entropy_coef=0.02), device="cpu")
    runner.data.max_operand = 3
    runner.data.add_only = True
    stats = runner.run(verbose=False)
    kls = [s.metrics.get("approx_kl", 0.0) for s in stats[2:] if s.metrics]
    assert max(kls) > 1e-5  # off-policy: ratios genuinely drift
    first = np.mean([s.accuracy for s in stats[:10]])
    last = np.mean([s.accuracy for s in stats[-10:]])
    assert last > first, (first, last)
