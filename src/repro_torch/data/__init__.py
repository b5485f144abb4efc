from .pipeline import DataConfig, SyntheticLM, prefix_embeds_stub  # noqa: F401
