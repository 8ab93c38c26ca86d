"""Disaggregated prefill/decode: the worker role.

The port's own copy of ``normalize_role`` from
``rafiki_tpu/serving/kv_transfer.py``. The KV blob format and its
checks (``leaf_signature``, ``check_kv_blob``) wait for the slice that
ports KV shipment; until then a worker with a role other than
``unified`` refuses to boot.
"""

from __future__ import annotations

from typing import Any

#: worker role knob values (the disaggregation switch). ``unified`` (the
#: default) is one worker that prefills AND decodes.
ROLES = ("unified", "prefill", "decode")


def normalize_role(value: Any) -> str:
    """``None``/empty → ``unified``; anything else must name a member of
    :data:`ROLES` — a typo'd role silently serving unified would defeat
    the placement policy."""
    if value is None:
        return "unified"
    s = str(value).strip().lower()
    if not s:
        return "unified"
    if s not in ROLES:
        raise ValueError(f"unknown worker role {value!r} "
                         f"(one of: {', '.join(ROLES)})")
    return s
