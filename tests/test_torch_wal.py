"""The port's WAL scanner (``rafiki_tpu_torch/native/wal.py``) against the
JAX package's (``rafiki_tpu/native/wal.py``), on data dirs the port's kvd
wrote.

Both scanners read the same files and must give the same answers, key
for key: ``scan_file``, ``iter_records``, ``dry_run_replay`` (the
doctor's verdict) and ``replay_state`` (what a boot restores). The
cases follow ``tests/test_kvd_persistence.py``: a clean WAL of every
record shape, a torn tail, a CRC-corrupt record, an empty dir, the
stale WAL left beside a new snapshot by a crash between the snapshot's
rename and the WAL's truncation, and a seeded corruption fuzz (random
truncations and single-bit flips) in which the scanners' verdict must
also be the port kvd's own: a mutant they call sound boots and serves,
one they call corrupt is refused with the kvd's structured exit 4.
"""

import os
import random
import signal
from pathlib import Path

import pytest

from rafiki_tpu.native import wal as jwal
from rafiki_tpu_torch.native import client as pclient
from rafiki_tpu_torch.native import wal as pwal


@pytest.fixture(scope="module", autouse=True)
def _built():
    pclient.ensure_built()


def _boot(data_dir, **kw):
    return pclient.KVServer(data_dir=str(data_dir), **kw)


def _kill9(server):
    os.kill(server._proc.pid, signal.SIGKILL)
    server._proc.wait()


def _same(dd):
    """Every answer of the two scanners over ``dd``, held equal; the
    port's verdict."""
    dd = Path(dd)
    for name in ("wal", "snapshot.wal"):
        assert pwal.scan_file(dd / name) == jwal.scan_file(dd / name)
    rep = pwal.dry_run_replay(str(dd))
    assert rep == jwal.dry_run_replay(str(dd))
    if rep["ok"]:
        for name in ("wal", "snapshot.wal"):
            assert pwal.iter_records(dd / name) == \
                jwal.iter_records(dd / name)
        assert pwal.replay_state(str(dd)) == jwal.replay_state(str(dd))
    return rep


def _healthy_wal(dd):
    """A WAL of every record shape: SET, pushes, a logged pop, a dedup
    push, INCR as SET, DEL."""
    s = _boot(dd)
    c = pclient.KVClient(s.host, s.port)
    c.set("k1", b"A" * 40)
    c.set("doomed", b"x")
    c.delete("doomed")
    c.rpush("q", b"m1", b"m2", b"m3")
    assert c.lpop("q") == b"m1"
    c.lpush_dedup("q", "id-1", b"m0")
    c.incr("ctr")
    c.set("bin", bytes(range(256)) * 3 + b"\r\n$*")
    c.shutdown()
    s._proc.wait(timeout=5)
    return (Path(dd) / "wal").read_bytes()


def test_clean_wal(tmp_path):
    _healthy_wal(tmp_path / "dd")
    rep = _same(tmp_path / "dd")
    assert rep["ok"] and rep["findings"] == []
    state = pwal.replay_state(str(tmp_path / "dd"))
    assert state["kv"]["k1"] == b"A" * 40 and "doomed" not in state["kv"]
    assert state["lists"]["q"] == [b"m0", b"m2", b"m3"]
    assert state["dedup"] == ["id-1"]
    # the port kvd restores what the scanners say it will
    s = _boot(tmp_path / "dd")
    c = pclient.KVClient(s.host, s.port)
    assert c.get("k1") == b"A" * 40 and c.llen("q") == 3
    s.stop()


def test_torn_tail(tmp_path):
    _healthy_wal(tmp_path / "dd")
    wal = tmp_path / "dd" / "wal"
    wal.write_bytes(wal.read_bytes() + b"\x01\x02\x03")
    rep = _same(tmp_path / "dd")
    assert rep["ok"] and rep["wal"]["torn_tail_bytes"] == 3
    assert any("torn tail of 3 byte(s)" in f for f in rep["findings"])


def test_crc_corrupt_record(tmp_path):
    _healthy_wal(tmp_path / "dd")
    wal = tmp_path / "dd" / "wal"
    data = bytearray(wal.read_bytes())
    data[9] ^= 0xFF  # inside the first record's payload
    wal.write_bytes(bytes(data))
    rep = _same(tmp_path / "dd")
    assert not rep["ok"] and rep["wal"]["corrupt_at"] == 0
    assert rep["wal"]["corrupt_detail"] == "crc mismatch"
    with pytest.raises(ValueError, match="corrupt record at offset 0"):
        pwal.iter_records(wal)
    with pytest.raises(RuntimeError, match="rc=4"):
        _boot(tmp_path / "dd")


def test_empty_dir(tmp_path):
    rep = _same(tmp_path / "empty")
    assert not rep["ok"]
    assert any("cold-starts empty" in f for f in rep["findings"])


def test_stale_wal_after_snapshot_rename(tmp_path):
    """A kill between the snapshot's rename and the WAL's truncation
    leaves the new snapshot beside the whole pre-compaction WAL: both
    scanners, like the boot, discard that WAL instead of applying it
    twice."""
    dd = tmp_path / "dd"
    s = _boot(dd)
    c = pclient.KVClient(s.host, s.port)
    c.rpush("q", b"m1", b"m2")
    c.set("k", b"v")
    c.shutdown()
    s._proc.wait(timeout=5)
    stale = (dd / "wal").read_bytes()
    s = _boot(dd)
    pclient.KVClient(s.host, s.port).compact()
    _kill9(s)
    (dd / "wal").write_bytes(stale)
    rep = _same(dd)
    assert rep["ok"] and any("unpaired pre-compaction residue" in f
                             for f in rep["findings"])
    assert rep["replayable_records"] == rep["snapshot"]["records"]
    assert pwal.replay_state(str(dd))["lists"]["q"] == [b"m1", b"m2"]
    s = _boot(dd)
    c = pclient.KVClient(s.host, s.port)
    assert c.llen("q") == 2 and c.get("k") == b"v"
    s.stop()


#: the fuzz: 10 truncations and 14 single-bit flips of one healthy WAL,
#: drawn from one seeded generator (the JAX persistence test's mix)
FUZZ_SEED = 0xC0FFEE
FUZZ_CASES = [("trunc", i) for i in range(10)] + \
    [("flip", i) for i in range(14)]


@pytest.fixture(scope="module")
def healthy(tmp_path_factory):
    return _healthy_wal(tmp_path_factory.mktemp("wal_seed") / "dd")


def _mutant(good, kind, i):
    rng = random.Random(FUZZ_SEED * 100 + (kind == "flip") * 50 + i)
    if kind == "trunc":
        return good[:rng.randrange(len(good))]
    data = bytearray(good)
    data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
    return bytes(data)


@pytest.mark.parametrize("kind,i", FUZZ_CASES,
                         ids=[f"{k}{i}" for k, i in FUZZ_CASES])
def test_corruption_fuzz_scanners_and_kvd_agree(tmp_path, healthy, kind,
                                                i):
    dd = tmp_path / "dd"
    dd.mkdir()
    (dd / "wal").write_bytes(_mutant(healthy, kind, i))
    rep = _same(dd)
    try:
        s = _boot(dd)
    except RuntimeError as e:
        assert "rc=4" in str(e), str(e)  # the structured refusal
        booted = False
    else:
        booted = True
        s.stop()
    assert rep["ok"] == booted, (rep["findings"], booted)
