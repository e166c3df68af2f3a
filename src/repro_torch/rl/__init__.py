from repro_torch.rl.advantage import (  # noqa: F401
    gae_advantages,
    grpo_advantages,
    reinforce_pp_advantages,
    staleness_importance_weights,
    whiten,
)
from repro_torch.rl.env import EnvConfig, VecReachEnv  # noqa: F401
from repro_torch.rl.grpo_workflow import GRPOConfig, GRPORunner  # noqa: F401
from repro_torch.rl.reward import math_reward  # noqa: F401
from repro_torch.rl.workers import (  # noqa: F401
    ActorWorker,
    InferenceWorker,
    RewardWorker,
    RolloutWorker,
    SimulatorWorker,
)
from repro_torch.rl.embodied_workflow import (  # noqa: F401
    EmbodiedAdvantageWorker,
    EmbodiedIterStats,
    EmbodiedPPOConfig,
    EmbodiedPPORunner,
)
from repro_torch.rl.rlhf_workflow import (  # noqa: F401
    CriticWorker,
    PPOConfig,
    PPORewardWorker,
    ReferenceWorker,
    RLHFRunner,
)
from repro_torch.rl.runner import WorkflowRunner  # noqa: F401
