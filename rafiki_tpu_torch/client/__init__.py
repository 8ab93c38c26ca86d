"""The port's client SDK (``rafiki_tpu/client`` counterpart)."""

from rafiki_tpu_torch.client.client import Client

__all__ = ["Client"]
