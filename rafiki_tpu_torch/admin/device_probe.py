"""Card inventory probe, run as a throwaway subprocess.

The port's counterpart of ``rafiki_tpu/admin/device_probe.py``: the
services manager learns the host's cards without initializing CUDA in
its own process (the cards belong to the workers it spawns), so it execs
this module, which asks ``torch.cuda`` for each card's index, name and
memory, prints one JSON line and exits. ``platform`` is ``cuda``, or
``none`` when the host has no CUDA device (the manager then raises).
"""

from __future__ import annotations

import json
import sys


def probe() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "none", "devices": []}
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({"id": i, "platform": "cuda", "name": props.name,
                        "memory_bytes": int(props.total_memory)})
    return {"platform": "cuda", "devices": devices}


if __name__ == "__main__":
    json.dump(probe(), sys.stdout)
    sys.stdout.write("\n")
    sys.exit(0)
