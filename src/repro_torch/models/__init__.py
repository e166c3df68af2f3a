from repro_torch.models.model import forward, init_model  # noqa: F401
