"""Deterministic fault injection for the serving data plane.

The port's own copy of ``rafiki_tpu/chaos/__init__.py``: ``ChaosConfig``
with its ``RAFIKI_CHAOS`` parse, ``ChaosInjector`` (seeded decisions and
the ``chaos_*`` counters), ``ChaosHub``, ``arm_admin_kill`` and
``arm_kvd_kill``. The injector draws from the same seeded
``random.Random`` stream in the same order as JAX's, so one seed and one
traffic order give the same drop, delay, corrupt and kill decisions in
both packages (``tests/test_torch_chaos.py``).

Fault tolerance that only real outages exercise is untested code. This
package injects the failure modes the request path claims to survive
(worker death mid-stream, dropped replies, delayed queues, corrupted
payloads) deterministically (a seeded RNG, token-count triggers):

- :class:`ChaosConfig`: the knob set, parseable from the ``RAFIKI_CHAOS``
  env var (``key=value`` pairs, comma or semicolon separated), so a
  spawned worker process can be made faulty without code changes::

      RAFIKI_CHAOS="kill_after_tokens=32,seed=7"      # die mid-stream
      RAFIKI_CHAOS="drop_reply_p=0.2,delay_queue_s=0.05"

- :class:`ChaosInjector`: the seeded decision core and its counters (a
  :class:`~rafiki_tpu_torch.obs.metrics.StatsMap`, on the worker's
  ``/metrics`` as ``chaos_*`` gauges);

- :class:`ChaosHub`: a :class:`~rafiki_tpu_torch.serving.queues.QueueHub`
  wrapper applying reply drop, delay and corruption at the hub boundary;
  the kill-after-N-tokens trigger sits in the inference worker's decode
  loop instead (death is a worker behaviour, not a queue one).

Injectors default to all-off; the worker wraps its hub only when at least
one fault is armed.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.serving.queues import QueueHub

#: the env var workers read at boot (see ChaosConfig.from_env)
CHAOS_ENV = "RAFIKI_CHAOS"


@dataclass
class ChaosConfig:
    """Injector knobs. All-off by default; every field is independent.

    - ``kill_after_tokens``: the worker dies (decode loop exits without
      replying or publishing, process exits non-zero) once its engine
      has generated this many tokens in total. The deterministic
      "worker killed mid-stream" trigger.
    - ``drop_reply_p``: each reply push (delta or final) is dropped
      with this probability — a lossy data plane / dying worker.
    - ``delay_queue_s``: every queue push sleeps this long first —
      transit latency / an overloaded hub.
    - ``corrupt_payload_p``: each reply push is bit-flipped with this
      probability — a torn write; consumers must fail structured, not
      crash.
    - ``kill_admin_after_s``: the ADMIN process SIGKILLs itself this
      many seconds after arming (:func:`arm_admin_kill` in the admin
      entrypoint) — the deterministic "control plane dies mid-load"
      drill behind the crash-recovery tests. SIGKILL on purpose: no
      graceful-shutdown path may run, exactly like an OOM-kill or a
      host reboot.
    - ``delay_kv_transfer_s``: every KV page shipment push (prefill →
      decode worker, disaggregated serving) sleeps this long first — a
      slow interconnect / overloaded hub. The decode side must degrade
      to a local re-prefill when its wait window expires, not hang the
      stream.
    - ``drop_kv_page_p``: each KV page shipment is dropped entirely
      with this probability — a lost shipment. Same contract: the
      decode worker's wait window expires and it re-prefills locally
      (token-exact, just slower).
    - ``kill_kvd_after_s``: SIGKILL the kvd DATA-PLANE process this
      many seconds after arming (:func:`arm_kvd_kill` — the admin
      holds the kvd's pid) — the deterministic "data plane dies
      mid-load" drill behind the WAL-replay/respawn machinery. SIGKILL
      on purpose: the
      graceful-shutdown fsync must NOT run; recovery has to come from
      the WAL alone.
    - ``drop_hub_conn_p``: each hub RPC first force-closes the calling
      thread's kvd client socket with this probability — a per-RPC
      connection drop (flaky network, dying server). The reconnect
      layer must retry idempotently: no lost durable blob, no
      double-delivered queue message (dedup ids), blocking pops
      resumed.
    - ``seed``: drives every probabilistic draw; same seed + same
      traffic order = same faults.
    """

    kill_after_tokens: int = 0
    drop_reply_p: float = 0.0
    delay_queue_s: float = 0.0
    corrupt_payload_p: float = 0.0
    kill_admin_after_s: float = 0.0
    delay_kv_transfer_s: float = 0.0
    drop_kv_page_p: float = 0.0
    kill_kvd_after_s: float = 0.0
    drop_hub_conn_p: float = 0.0
    seed: int = 0

    @property
    def armed(self) -> bool:
        return bool(self.kill_after_tokens > 0 or self.drop_reply_p > 0
                    or self.delay_queue_s > 0
                    or self.corrupt_payload_p > 0
                    or self.kill_admin_after_s > 0
                    or self.delay_kv_transfer_s > 0
                    or self.drop_kv_page_p > 0
                    or self.kill_kvd_after_s > 0
                    or self.drop_hub_conn_p > 0)

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """``"kill_after_tokens=8,drop_reply_p=0.5,seed=3"`` → config.
        Unknown keys and malformed values raise: a chaos run with a
        typo'd knob silently testing nothing is worse than no run."""
        kw: Dict[str, Any] = {}
        casts = {f.name: f.type for f in fields(cls)}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in casts:
                raise ValueError(
                    f"unknown chaos knob {key!r} (have: "
                    f"{sorted(casts)})")
            cast = int if casts[key] in (int, "int") else float
            kw[key] = cast(val.strip())
        return cls(**kw)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> Optional["ChaosConfig"]:
        """The ``RAFIKI_CHAOS`` config, or None when unset/empty."""
        spec = (env if env is not None else os.environ).get(
            CHAOS_ENV, "").strip()
        if not spec:
            return None
        cfg = cls.parse(spec)
        return cfg if cfg.armed else None


def arm_admin_kill(cfg: ChaosConfig) -> Optional["object"]:
    """Arm the control-plane suicide timer: SIGKILL this process
    ``cfg.kill_admin_after_s`` seconds from now. Called by the admin
    entrypoint when chaos is armed; returns the started timer (or None
    when the knob is off) so a test can cancel it. SIGKILL — not
    SIGTERM — because the drill exists to prove recovery WITHOUT the
    graceful-shutdown path ever running."""
    if cfg.kill_admin_after_s <= 0:
        return None
    import os
    import signal
    import threading

    def _die() -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    timer = threading.Timer(cfg.kill_admin_after_s, _die)
    timer.daemon = True
    timer.start()
    return timer


def arm_kvd_kill(cfg: ChaosConfig, get_pid,
                 injector: Optional["ChaosInjector"] = None
                 ) -> Optional["object"]:
    """Arm the data-plane kill timer: SIGKILL the kvd process
    ``cfg.kill_kvd_after_s`` seconds from now. ``get_pid`` is a
    zero-arg callable returning the kvd's CURRENT pid (the admin owns
    it; a callable, not a snapshot, so arming before the data plane
    boots still kills the right process). Returns the started timer
    (or None when the knob is off) so a test can cancel it. SIGKILL —
    not SHUTDOWN — because the drill exists to prove WAL replay,
    not the graceful-shutdown fsync."""
    if cfg.kill_kvd_after_s <= 0:
        return None
    import logging
    import os
    import signal
    import threading

    def _kill() -> None:
        pid = get_pid()
        if not pid:
            logging.getLogger(__name__).warning(
                "chaos kvd kill fired but no kvd pid is known")
            return
        if injector is not None:
            injector.counters.inc("kvd_kills")
        logging.getLogger(__name__).warning(
            "chaos: SIGKILLing kvd pid %d", pid)
        try:
            os.kill(int(pid), signal.SIGKILL)
        except OSError as e:
            logging.getLogger(__name__).warning(
                "chaos kvd kill of pid %s failed: %s", pid, e)

    timer = threading.Timer(cfg.kill_kvd_after_s, _kill)
    timer.daemon = True
    timer.start()
    return timer


class ChaosInjector:
    """Seeded decision core. One injector per faulty process; all
    decisions funnel through it so a (seed, traffic order) pair replays
    identically. Counters are exposed as ``chaos_*`` metrics by the
    owning worker."""

    def __init__(self, cfg: ChaosConfig) -> None:
        self.cfg = cfg
        self._rng = random.Random(cfg.seed)
        self.counters = StatsMap({"replies_dropped": 0,
                                  "payloads_corrupted": 0,
                                  "queue_delays": 0,
                                  "kills": 0,
                                  "kv_ships_dropped": 0,
                                  "kv_ship_delays": 0,
                                  "kvd_kills": 0,
                                  "hub_conn_drops": 0})

    def should_kill(self, tokens_generated: int) -> bool:
        """True once the cumulative generated-token count crosses the
        configured kill point (then latched: a killed worker stays
        killed)."""
        k = self.cfg.kill_after_tokens
        if k <= 0 or tokens_generated < k:
            return False
        if not self.counters["kills"]:
            self.counters.inc("kills")
        return True

    def mangle_reply(self, data: bytes) -> Optional[bytes]:
        """Apply drop/corrupt faults to a reply payload: None = dropped,
        otherwise the (possibly corrupted) bytes to push."""
        if self.cfg.drop_reply_p > 0 and \
                self._rng.random() < self.cfg.drop_reply_p:
            self.counters.inc("replies_dropped")
            return None
        if self.cfg.corrupt_payload_p > 0 and \
                self._rng.random() < self.cfg.corrupt_payload_p:
            self.counters.inc("payloads_corrupted")
            if data:
                i = self._rng.randrange(len(data))
                data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        return data

    def maybe_delay(self) -> None:
        d = self.cfg.delay_queue_s
        if d > 0:
            self.counters.inc("queue_delays")
            time.sleep(d)

    def should_drop_conn(self) -> bool:
        """Seeded per-RPC connection-drop decision (the fault behind
        ``drop_hub_conn_p``); counted so a chaos run's /metrics shows
        how many drops actually fired."""
        if self.cfg.drop_hub_conn_p <= 0:
            return False
        if self._rng.random() >= self.cfg.drop_hub_conn_p:
            return False
        self.counters.inc("hub_conn_drops")
        return True

    def mangle_kv_ship(self, data: bytes) -> Optional[bytes]:
        """Apply the KV-shipment faults: None = shipment dropped (the
        decode worker's wait window expires → local re-prefill);
        otherwise the bytes to push, after any configured transfer
        delay."""
        if self.cfg.drop_kv_page_p > 0 and \
                self._rng.random() < self.cfg.drop_kv_page_p:
            self.counters.inc("kv_ships_dropped")
            return None
        if self.cfg.delay_kv_transfer_s > 0:
            self.counters.inc("kv_ship_delays")
            time.sleep(self.cfg.delay_kv_transfer_s)
        return data


class ChaosHub(QueueHub):
    """A :class:`QueueHub` decorator applying the injector's queue
    faults. Reply/shipment faults live on the PUSH side (a worker
    failing to get its answer out), which is where the breaker/failover
    machinery must catch them; the per-RPC connection-drop fault
    (``drop_hub_conn_p``) applies to EVERY hub op — it force-closes the
    inner hub's thread-local socket right before the call, so the op
    itself lands on a dead transport and must come back through the
    reconnect + idempotent-replay layer. On a socketless inner hub
    (in-proc) the drop is a counted no-op."""

    def __init__(self, inner: QueueHub, injector: ChaosInjector) -> None:
        self.inner = inner
        self.injector = injector

    def _maybe_drop_conn(self) -> None:
        if self.injector.should_drop_conn():
            drop = getattr(self.inner, "drop_conn", None)
            if drop is not None:
                drop()

    def push_query(self, worker_id: str, data: bytes) -> None:
        self.injector.maybe_delay()
        self._maybe_drop_conn()
        self.inner.push_query(worker_id, data)

    def pop_query(self, worker_id: str, timeout: float):
        self._maybe_drop_conn()
        return self.inner.pop_query(worker_id, timeout)

    def push_prediction(self, query_id: str, data: bytes) -> None:
        self.injector.maybe_delay()
        mangled = self.injector.mangle_reply(data)
        if mangled is None:
            return  # dropped on the floor — the fault being injected
        self._maybe_drop_conn()
        self.inner.push_prediction(query_id, mangled)

    def pop_prediction(self, query_id: str, timeout: float):
        self._maybe_drop_conn()
        return self.inner.pop_prediction(query_id, timeout)

    def query_depth(self, worker_id: str) -> int:
        self._maybe_drop_conn()
        return self.inner.query_depth(worker_id)

    def discard_prediction_queue(self, query_id: str) -> None:
        self._maybe_drop_conn()
        self.inner.discard_prediction_queue(query_id)

    def arm_reply_ttl(self, query_id: str, ttl_s: float) -> None:
        self._maybe_drop_conn()
        self.inner.arm_reply_ttl(query_id, ttl_s)

    def put_worker_stats(self, worker_id: str, stats) -> None:
        self._maybe_drop_conn()
        self.inner.put_worker_stats(worker_id, stats)

    def get_worker_stats(self, worker_id: str):
        self._maybe_drop_conn()
        return self.inner.get_worker_stats(worker_id)

    def put_pool_members(self, pool_id: str, members) -> None:
        self._maybe_drop_conn()
        self.inner.put_pool_members(pool_id, members)

    def get_pool_members(self, pool_id: str):
        self._maybe_drop_conn()
        return self.inner.get_pool_members(pool_id)

    def push_kv(self, worker_id: str, data: bytes) -> None:
        mangled = self.injector.mangle_kv_ship(data)
        if mangled is None:
            return  # the lost shipment being injected: the decode
            #         side's wait window expires → local re-prefill
        self._maybe_drop_conn()
        self.inner.push_kv(worker_id, mangled)

    def pop_kv(self, worker_id: str, timeout: float):
        self._maybe_drop_conn()
        return self.inner.pop_kv(worker_id, timeout)

    def kv_depth(self, worker_id: str) -> int:
        self._maybe_drop_conn()
        return self.inner.kv_depth(worker_id)

    def put_blob(self, key: str, data: bytes) -> None:
        self._maybe_drop_conn()
        self.inner.put_blob(key, data)

    def get_blob(self, key: str):
        self._maybe_drop_conn()
        return self.inner.get_blob(key)

    def drop_conn(self) -> None:
        """Pass-through so stacked decorators keep the chaos surface."""
        drop = getattr(self.inner, "drop_conn", None)
        if drop is not None:
            drop()


__all__ = ["CHAOS_ENV", "ChaosConfig", "ChaosHub", "ChaosInjector",
           "arm_admin_kill", "arm_kvd_kill"]
