"""The gang engine: K trials of one static knob bucket as K lanes of one
train step (``gang.py``)."""

from rafiki_tpu_torch.tuning.gang import GangEngine, supports_gang

__all__ = ["GangEngine", "supports_gang"]
