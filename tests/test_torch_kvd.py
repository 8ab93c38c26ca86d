"""The port's kv data plane against the JAX package's.

The port builds its own kvd from ``rafiki_tpu_torch/native/kv_server.cc``
into ``build/rafiki_tpu_torch/``. The same scripted calls run against the
port's server with the port's client and against the JAX server with the
JAX client, and both transcripts must be equal; the clients also cross
over (a port client on the JAX kvd, a JAX client on the port kvd), and a
data directory written by either kvd replays in the other. The cases
follow ``tests/test_native.py`` and ``tests/test_kvd_persistence.py``
where the port uses them: the verbs, binary safety, queues with blocking
pops and deadlines, TTLs, dedup pushes, restarts with WAL replay and
compaction.
"""

import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from rafiki_tpu.native import client as jclient
from rafiki_tpu_torch.native import client as pclient
from rafiki_tpu_torch.store.param_store import ParamStore

ROOT = Path(__file__).resolve().parent.parent

SIDES = {"port": pclient, "jax": jclient}
PAIRS = [("port", "port"), ("jax", "jax"), ("port", "jax"),
         ("jax", "port")]


@pytest.fixture(scope="module", autouse=True)
def _built():
    pclient.ensure_built()
    jclient.ensure_built()


def test_kvd_builds_from_the_ports_own_source():
    out = pclient.ensure_built()
    assert out == ROOT / "build" / "rafiki_tpu_torch" / "rafiki-kvd"
    assert pclient.SOURCE == ROOT / "rafiki_tpu_torch" / "native" / \
        "kv_server.cc"
    assert out.is_file() and os.access(out, os.X_OK)
    assert out.stat().st_mtime >= pclient.SOURCE.stat().st_mtime
    # the port's server really runs that binary
    s = pclient.KVServer()
    try:
        cmd = Path(f"/proc/{s._proc.pid}/cmdline").read_bytes()
        assert cmd.split(b"\0")[0] == str(out).encode()
    finally:
        s.stop()


#: the one rule the port's kvd changes: when a compaction runs
JAX_ROTATE = """  if (g_persist.enabled && !g_persist.in_replay &&
      g_persist.wal_bytes > g_persist.wal_rotate_bytes)
    CompactLocked();"""
PORT_ROTATE = """  if (g_persist.enabled && !g_persist.in_replay &&
      g_persist.wal_bytes > std::max(g_persist.wal_rotate_bytes,
                                     g_persist.snapshot_bytes))
    CompactLocked();"""


def test_kvd_source_is_the_jax_server_but_for_its_rotation_rule():
    """The port's copy differs from the JAX server in its comments and in
    one rule, when the WAL is compacted: the wire, WAL and snapshot
    formats are the same code."""
    def code(text):
        return [line for line in text.splitlines()
                if line.strip() and not line.lstrip().startswith("//")
                and line != "#include <algorithm>"]

    port = pclient.SOURCE.read_text()
    assert PORT_ROTATE in port
    jax = (ROOT / "rafiki_tpu" / "native" / "kv_server.cc").read_text()
    assert JAX_ROTATE in jax
    assert code(port.replace(PORT_ROTATE, JAX_ROTATE)) == code(jax)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_compaction_waits_for_the_wal_to_outgrow_the_snapshot(tmp_path,
                                                              side):
    """A 64 KB blob crosses a 1 KB rotation threshold: one compaction on
    either kvd. Then 40 KB of queue traffic: the JAX kvd compacts the
    whole store (the blob included) every 1 KB of it; the port's waits
    until the WAL has outgrown the 64 KB snapshot, then compacts each
    time the WAL outgrows the last snapshot (over 160 KB more: once or
    twice). Every write survives a restart on both."""
    mod = SIDES[side]
    s = mod.KVServer(data_dir=str(tmp_path / "dd"), wal_rotate_bytes=1024)
    try:
        c = mod.KVClient(s.host, s.port)
        c.set("params:t0", b"p" * 65536)
        st = c.stats()
        assert st["compactions"] == 1 and st["snapshot_bytes"] > 65536
        for i in range(40):
            c.rpush("q", b"m" * 1000)
        n40 = c.stats()["compactions"]
        for i in range(160):
            c.rpush("q", b"m" * 1000)
        n200 = c.stats()["compactions"]
    finally:
        _kill9(s)
    if side == "port":
        assert n40 == 1 and 2 <= n200 <= 3
    else:
        assert n40 > 30 and n200 > 150  # the whole store, every ~1 KB
    s2 = mod.KVServer(data_dir=str(tmp_path / "dd"), wal_rotate_bytes=1024)
    try:
        c2 = mod.KVClient(s2.host, s2.port)
        assert c2.get("params:t0") == b"p" * 65536 and c2.llen("q") == 200
    finally:
        s2.stop()


def test_ensure_built_rebuilds_through_a_temporary_name(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(pclient, "BUILD_DIR", tmp_path)
    out = pclient.ensure_built()
    assert out == tmp_path / "rafiki-kvd" and out.is_file()
    ino = out.stat().st_ino
    pclient.ensure_built(force=True)
    # renamed over, not rewritten in place: a running server keeps its
    # inode; no temporary file is left behind
    assert out.stat().st_ino != ino
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rafiki-kvd"]


def test_ensure_built_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(pclient, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises((RuntimeError, OSError)):
        pclient.ensure_built()


# ---- the verbs, scripted, on both kvds

def _verbs(c):
    out = [c.ping()]
    c.set("a", b"hello")
    out += [c.get("a"), c.get("missing"), c.exists("a"),
            c.exists("missing"), c.delete("a"), c.get("a")]
    blob = bytes(range(256)) * 1000 + b"\r\n$*"
    c.set("bin", blob)
    out.append(c.get("bin") == blob)
    for k in ["params:t1", "params:t2", "queue:q1"]:
        c.set(k, b"x")
    out += [c.keys("params:*"), c.keys("*")]
    out += [c.incr("ctr"), c.incr("ctr")]
    c.lpush("q", b"first")
    c.lpush("q", b"second")
    out += [c.llen("q"), c.brpop("q", 1.0), c.brpop("q", 1.0)]
    c.lpush("q2", b"v2")
    out.append(c.brpop(["q1", "q2"], 1.0))
    out += [c.rpush("r", b"a", b"b"), c.lpop("r"), c.rpop("r"),
            c.rpop("r")]
    out += [c.lpush_dedup("d", "id-1", b"m1"),
            c.lpush_dedup("d", "id-1", b"m1"),
            c.rpush_dedup("d", "id-2", b"m2"), c.llen("d")]
    out += [c.ttl("nope")]
    c.set("immortal", b"v")
    out.append(c.ttl("immortal"))
    c.expire("immortal", 30)
    out.append(c.ttl("immortal"))
    c.set("gone", b"v")
    c.expire("gone", 100)
    c.delete("gone")
    out.append(c.ttl("gone"))
    st = c.stats()
    out.append(sorted(st))
    out += [st["keys"], st["lists"], st["dedup_ids"]]
    return out


@pytest.mark.parametrize("server_side,client_side", PAIRS,
                         ids=[f"{s}-kvd-{c}-client" for s, c in PAIRS])
def test_verbs_equal_the_jax_kvd(server_side, client_side):
    with SIDES["jax"].KVServer() as js:
        want = _verbs(jclient.KVClient(js.host, js.port))
    with SIDES[server_side].KVServer() as s:
        got = _verbs(SIDES[client_side].KVClient(s.host, s.port))
    assert got == want


@pytest.mark.parametrize("side", sorted(SIDES))
def test_blocking_pop_waits_for_a_push_and_honors_its_deadline(side):
    mod = SIDES[side]
    with mod.KVServer() as s:
        c = mod.KVClient(s.host, s.port)
        t0 = time.monotonic()
        assert c.brpop("empty", 0.3) is None
        assert time.monotonic() - t0 >= 0.25
        got = {}

        def consumer():
            c2 = mod.KVClient(s.host, s.port)
            got["v"] = c2.brpop("bq", 30.0)
            c2.close()

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.1)
        c.lpush("bq", b"payload")
        t.join(timeout=30)
        assert got["v"] == ("bq", b"payload")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_expire_collects_a_reply_queue_recreated_after_delete(side):
    """The kvd's deliberate Redis delta: a TTL armed before the key
    exists outlives DEL and collects a late push."""
    mod = SIDES[side]
    with mod.KVServer() as s:
        c = mod.KVClient(s.host, s.port)
        c.expire("q:preds:q1", 0.15)
        c.lpush("q:preds:q1", b"late reply")
        assert c.llen("q:preds:q1") == 1
        deadline = time.monotonic() + 30
        while c.exists("q:preds:q1") and time.monotonic() < deadline:
            time.sleep(0.1)
            c.ping()  # any command triggers the purge scan
        assert not c.exists("q:preds:q1") and c.llen("q:preds:q1") == 0


def test_param_store_over_the_port_kvd():
    with pclient.KVServer() as s:
        store = ParamStore.from_uri(f"kv://{s.host}:{s.port}")
        params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "meta": {"n": 3}}
        store.save("trial-1", params)
        loaded = ParamStore.from_uri(
            f"kv://{s.host}:{s.port}").load("trial-1")
        np.testing.assert_array_equal(loaded["w"], params["w"])
        assert loaded["meta"] == {"n": 3}


# ---- persistence: restarts with WAL replay, across the two builds

def _write_state(c):
    c.set("params:t1", b"\x00blob\xff")
    c.set("doomed", b"x")
    c.delete("doomed")
    for v in (b"a", b"b", b"c", b"d"):
        c.rpush("q", v)
    assert c.brpop("q", 1.0) == ("q", b"d")
    assert c.lpop("q") == b"a"
    c.incr("ctr")
    c.incr("ctr")
    assert c.lpush_dedup("dq", "id-1", b"m1") == 1


def _read_state(c):
    return [c.get("params:t1"), c.get("doomed"), c.lpop("q"), c.lpop("q"),
            c.llen("q"), c.incr("ctr"), c.lpush_dedup("dq", "id-1", b"m1"),
            c.llen("dq")]


WANT_STATE = [b"\x00blob\xff", None, b"b", b"c", 0, 3, 1, 1]


def _kill9(server):
    os.kill(server._proc.pid, signal.SIGKILL)
    server._proc.wait()


@pytest.mark.parametrize("writer,reader", PAIRS,
                         ids=[f"{w}-wal-{r}-replay" for w, r in PAIRS])
@pytest.mark.parametrize("how", ["shutdown", "kill9"])
def test_restart_replays_the_wal(tmp_path, writer, reader, how):
    """SHUTDOWN or kill -9, then a boot on the same data dir restores
    blobs, list content and order, pops and deletes, counters and the
    dedup recent-set, whichever build wrote the WAL."""
    s = SIDES[writer].KVServer(data_dir=str(tmp_path / "dd"))
    try:
        _write_state(SIDES[writer].KVClient(s.host, s.port))
    finally:
        if how == "kill9":
            _kill9(s)
        else:
            s.stop()
    s2 = SIDES[reader].KVServer(data_dir=str(tmp_path / "dd"))
    try:
        c2 = SIDES[reader].KVClient(s2.host, s2.port)
        assert _read_state(c2) == WANT_STATE
        assert c2.stats()["replayed_records"] > 0
    finally:
        s2.stop()


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_compacted_snapshot_replays_in_the_other_build(tmp_path, writer,
                                                       reader):
    s = SIDES[writer].KVServer(data_dir=str(tmp_path / "dd"))
    try:
        c = SIDES[writer].KVClient(s.host, s.port)
        for i in range(50):
            c.set("hot", b"v%d" % i)
        c.rpush("q", b"a", b"b")
        c.compact()
        st = c.stats()
    finally:
        _kill9(s)
    assert st["compactions"] == 1 and st["snapshot_bytes"] > 0
    s2 = SIDES[reader].KVServer(data_dir=str(tmp_path / "dd"))
    try:
        c2 = SIDES[reader].KVClient(s2.host, s2.port)
        assert c2.get("hot") == b"v49"
        assert [c2.lpop("q"), c2.lpop("q")] == [b"a", b"b"]
    finally:
        s2.stop()


def test_corrupt_wal_refuses_the_port_kvds_boot(tmp_path):
    s = pclient.KVServer(data_dir=str(tmp_path / "dd"))
    c = pclient.KVClient(s.host, s.port)
    c.set("k", b"A" * 64)
    c.set("k2", b"B" * 64)
    s.stop()
    wal_path = tmp_path / "dd" / "wal"
    data = bytearray(wal_path.read_bytes())
    data[20] ^= 0xFF
    wal_path.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="kvd_wal_corrupt"):
        pclient.KVServer(data_dir=str(tmp_path / "dd"))


def test_fsync_policies(tmp_path):
    for i, policy in enumerate(("always", "everysec", "no")):
        with pclient.KVServer(data_dir=str(tmp_path / f"dd{i}"),
                              fsync=policy) as s:
            c = pclient.KVClient(s.host, s.port)
            c.set("k", b"v")
            assert c.stats()["fsync_policy"] == policy
    with pytest.raises(ValueError):
        pclient.KVServer(data_dir=str(tmp_path / "bad"), fsync="sometimes")


def test_reconnecting_client_rides_out_a_respawn(tmp_path):
    """The port client's reconnect layer: a retryable verb issued while
    the kvd is down lands once a kvd replays on the same port."""
    s = pclient.KVServer(data_dir=str(tmp_path / "dd"))
    host, port = s.host, s.port
    c = pclient.KVClient(host, port, retry_window_s=30.0)
    c.set("k", b"v")
    before = pclient.CLIENT_STATS["hub_reconnects_total"]
    _kill9(s)
    box = {}

    def respawn():
        time.sleep(0.3)
        box["s"] = pclient.KVServer(port=port,
                                    data_dir=str(tmp_path / "dd"))

    t = threading.Thread(target=respawn)
    t.start()
    try:
        assert c.get("k") == b"v"
    finally:
        t.join(timeout=30)
        box["s"].stop()
    assert pclient.CLIENT_STATS["hub_reconnects_total"] > before


def test_wait_for_server():
    with pclient.KVServer() as s:
        c = pclient.wait_for_server(s.host, s.port, timeout=30.0)
        assert c.ping()
        c.close()
    with pytest.raises(TimeoutError):
        pclient.wait_for_server("127.0.0.1", 1, timeout=0.3)


def test_bulk_replies_are_received_in_place():
    """A bulk reply is received straight into a buffer of its own size,
    not rebuilt from 64 KB chunks (the JAX client's reads are quadratic
    in the reply's size). Blobs, multi-bulk pops and lines around them
    come back intact."""
    with pclient.KVServer() as s:
        c = pclient.KVClient(s.host, s.port)
        blob = np.random.default_rng(0).bytes(32 << 20)
        c.set("blob", blob)
        c.rpush("q", b"x" * 70000, b"\r\n" * 40000)
        chunks = [0]
        recv_more = c._recv_more

        def counted():
            chunks[0] += 1
            recv_more()

        c._recv_more = counted
        assert c.get("blob") == blob
        assert chunks[0] <= 4  # the reply's header; the payload in place
        assert c.brpop("q", 5.0) == ("q", b"\r\n" * 40000)
        assert c.lpop("q") == b"x" * 70000
        assert "blob" in c.keys("*") and c.ping()
        with jclient.KVServer() as js:  # the JAX kvd, the same answers
            jc = pclient.KVClient(js.host, js.port)
            jc.set("blob", blob)
            assert jc.get("blob") == blob
