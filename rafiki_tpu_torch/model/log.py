"""Per-trial structured metric logging.

The port's own copy of ``ModelLogger`` from ``rafiki_tpu/model/log.py``:
records are buffered in-process; a worker may attach a ``sink``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class LogRecord:
    time: float
    kind: str          # "message" | "values" | "plot_def"
    data: Dict[str, Any]


@dataclass
class ModelLogger:
    """Collects messages, metric values, and plot definitions for one
    trial."""

    records: List[LogRecord] = field(default_factory=list)
    sink: Optional[Callable[[LogRecord], None]] = None

    def _emit(self, kind: str, data: Dict[str, Any]) -> None:
        rec = LogRecord(time=time.time(), kind=kind, data=data)
        self.records.append(rec)
        if self.sink is not None:
            self.sink(rec)

    def log(self, message: str = "", **values: Any) -> None:
        """Log a free-form message and/or named metric values
        (e.g. ``logger.log(epoch=3, loss=0.12)``)."""
        if message:
            self._emit("message", {"message": message})
        if values:
            self._emit("values", {k: _to_plain(v) for k, v in values.items()})

    def define_plot(self, title: str, metrics: List[str],
                    x_axis: str = "epoch") -> None:
        """Declare a plot over logged metric names."""
        self._emit("plot_def",
                   {"title": title, "metrics": metrics, "x_axis": x_axis})

    def get_values(self, name: str) -> List[Any]:
        return [r.data[name] for r in self.records
                if r.kind == "values" and name in r.data]


def _to_plain(v: Any) -> Any:
    """Numpy or torch scalars → plain Python, for JSON transport."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v
