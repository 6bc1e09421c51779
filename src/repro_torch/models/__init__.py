"""The LM stack of the port: every family of the registry, on one device."""

from repro_torch.models.api import ModelBundle, build_model  # noqa: F401
