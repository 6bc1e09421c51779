"""The LM stack of the port: the transformer families on one device."""

from repro_torch.models.api import ModelBundle, build_model  # noqa: F401
