"""Model modules, each named after its reference counterpart."""

from cerberusnet_torch.models.cerberus import CerberusNet  # noqa: F401
