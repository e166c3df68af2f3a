from repro_torch.models.model import init_model  # noqa: F401
