"""Read-only WAL and snapshot inspection of the kvd's persistence files.

The port's own copy of ``rafiki_tpu/native/wal.py`` (``scan_file``,
``iter_records``, ``dry_run_replay``, ``replay_state``, ``_apply``). The
doctor's data-plane check and the recovery tests judge a kvd's durable
state without booting a server on it: a dry-run replay that validates
framing and CRCs, counts what a boot would restore, and reports torn
tails and corruption as ``native/kv_server.cc``'s loader does. The port's
kvd writes the JAX kvd's formats, so either scanner reads either
server's files. Pure reads: it never truncates, repairs or writes, so it
is safe against a live data dir (a scan racing an append sees at worst a
torn tail).

The verdicts, records and states are JAX's; the work is not. JAX's
``dry_run_replay`` reads and CRCs each file five times and copies every
record twice; here each file is read and checked once, and the dry run
replays over views of that one buffer (``_read``). At phase 23's 3.4 GB
of kvd files that is the doctor's whole cost.

Record framing (as ``kv_server.cc`` writes it): ``[u32 len][u32
crc32(payload)][payload]`` with payload ``[u32 nargs]([u32 len][bytes])*``,
little-endian.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

#: mutating verbs a WAL record may carry (anything else is corruption or
#: a WAL from a newer server: a boot refuses it either way). EPOCH and
#: WALHDR pair a snapshot with its WAL (kv_server.cc CompactLocked):
#: no-ops on the state that gate what replays.
_KNOWN_VERBS = frozenset({
    "SET", "DEL", "LPUSH", "RPUSH", "LPUSHD", "RPUSHD", "LPOP", "RPOP",
    "EXPIRE", "DEDUP", "FLUSHALL", "EPOCH", "WALHDR"})


def _str(arg) -> str:
    """A record argument (bytes or a view of them) as latin-1 text."""
    return bytes(arg).decode("latin-1")


def _pairing_epochs(snap_records, wal_records) -> Tuple[int, int]:
    """(snapshot epoch, wal header epoch); 0 = absent. Mirrors the
    boot loader's gate: a snapshot-bearing data dir only replays a WAL
    whose first record is a matching WALHDR."""
    snap_epoch = wal_epoch = 0
    if snap_records and _str(snap_records[0][0]).upper() == "EPOCH":
        snap_epoch = int(_str(snap_records[0][1]))
    if wal_records and _str(wal_records[0][0]).upper() == "WALHDR":
        wal_epoch = int(_str(wal_records[0][1]))
    return snap_epoch, wal_epoch


def scan_file(path: Path) -> Dict[str, Any]:
    """Scan one persistence file. Returns::

        {"path", "exists", "bytes", "records", "torn_tail_bytes",
         "corrupt_at": Optional[int], "corrupt_detail": Optional[str]}

    ``corrupt_at`` is the offset of the first CRC-corrupt/undecodable
    record (a real boot fails there with a structured error);
    ``torn_tail_bytes`` counts an incomplete record at EOF (a real boot
    truncates it loudly and serves)."""
    return _read(path)[0]


def _read(path: Path, keep: bool = False):
    """One pass over a persistence file: :func:`scan_file`'s report and,
    with ``keep``, the records up to the first corrupt one, each a list
    of views into the file's buffer."""
    out: Dict[str, Any] = {
        "path": str(path), "exists": path.exists(), "bytes": 0,
        "records": 0, "torn_tail_bytes": 0, "corrupt_at": None,
        "corrupt_detail": None}
    records: List[List[memoryview]] = []
    if not out["exists"]:
        return out, records
    buf = memoryview(path.read_bytes())
    out["bytes"] = len(buf)
    off = 0
    while off < len(buf):
        if off + 8 > len(buf):
            break  # torn header
        length, crc = struct.unpack_from("<II", buf, off)
        if length > (1 << 30):
            out["corrupt_at"] = off
            out["corrupt_detail"] = \
                f"record length {length} exceeds 1GiB bound"
            return out, records
        if off + 8 + length > len(buf):
            break  # torn payload
        payload = buf[off + 8:off + 8 + length]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            out["corrupt_at"] = off
            out["corrupt_detail"] = "crc mismatch"
            return out, records
        args = _decode_args(payload)
        if args is None or not args or \
                _str(args[0]).upper() not in _KNOWN_VERBS:
            out["corrupt_at"] = off
            out["corrupt_detail"] = "undecodable record"
            return out, records
        out["records"] += 1
        if keep:
            records.append(args)
        off += 8 + length
    out["torn_tail_bytes"] = len(buf) - off
    return out, records


def _decode_args(payload: memoryview) -> Optional[List[memoryview]]:
    if len(payload) < 4:
        return None
    (nargs,) = struct.unpack_from("<I", payload, 0)
    args: List[memoryview] = []
    p = 4
    for _ in range(nargs):
        if p + 4 > len(payload):
            return None
        (alen,) = struct.unpack_from("<I", payload, p)
        p += 4
        if p + alen > len(payload):
            return None
        args.append(payload[p:p + alen])
        p += alen
    return args


def iter_records(path: Path) -> List[List[bytes]]:
    """Decoded records of one clean file (raises ValueError at the
    first corrupt record — callers wanting a verdict use
    :func:`scan_file`)."""
    rep, records = _read(path, keep=True)
    if rep["corrupt_at"] is not None:
        raise ValueError(
            f"{path}: corrupt record at offset {rep['corrupt_at']} "
            f"({rep['corrupt_detail']})")
    return [[bytes(a) for a in args] for args in records]


def dry_run_replay(data_dir: str) -> Dict[str, Any]:
    """The doctor's data-plane integrity verdict: scan snapshot + WAL
    like a boot would, WITHOUT writing anything, and summarize what a
    replay restores. ``ok`` is False when a real boot would REFUSE
    (corrupt records); a torn WAL tail is reported but not fatal —
    boots truncate it loudly and serve."""
    dd = Path(data_dir)
    snap, snap_recs = _read(dd / "snapshot.wal", keep=True)
    wal, wal_recs = _read(dd / "wal", keep=True)
    report: Dict[str, Any] = {
        "data_dir": str(dd), "snapshot": snap, "wal": wal,
        "findings": [], "ok": True}
    for part in (snap, wal):
        if part["corrupt_at"] is not None:
            report["findings"].append(
                f"{Path(part['path']).name}: corrupt record at offset "
                f"{part['corrupt_at']} ({part['corrupt_detail']}) — a "
                "kvd boot will REFUSE this file (restore from backup "
                "or move it aside for a cold start)")
            report["ok"] = False
    if snap["exists"] and snap["torn_tail_bytes"]:
        # snapshots are written whole + atomically renamed: a torn one
        # means something else scribbled on it
        report["findings"].append(
            f"snapshot.wal has a torn tail of "
            f"{snap['torn_tail_bytes']} byte(s) — snapshots are "
            "atomic-rename artifacts and should never be torn")
        report["ok"] = False
    if wal["torn_tail_bytes"]:
        report["findings"].append(
            f"wal has a torn tail of {wal['torn_tail_bytes']} byte(s) "
            "(normal residue of kill -9 mid-append; the next boot "
            "truncates it loudly)")
    if not snap["exists"] and not wal["exists"]:
        report["findings"].append(
            "no snapshot.wal or wal under the data dir — a respawn "
            "here cold-starts empty")
        report["ok"] = False
    report["replayable_records"] = \
        int(snap["records"]) + int(wal["records"])
    # what a replay would restore, summarized by key class (durable
    # blobs vs queues) — the doctor's "is the durable state actually
    # in there" line. Only computed for clean files.
    if report["ok"]:
        snap_epoch, wal_epoch = _pairing_epochs(snap_recs, wal_recs)
        if snap_epoch and wal_epoch != snap_epoch:
            # same verdict as the boot loader: records already folded
            # into the snapshot — reported, not fatal
            report["findings"].append(
                "wal is unpaired pre-compaction residue (crash "
                "between snapshot rename and WAL truncate); a boot "
                "discards it instead of double-applying")
            report["replayable_records"] = int(snap["records"])
        state = _replay(snap_recs, wal_recs)
        report["restored_keys"] = len(state["kv"])
        report["restored_lists"] = len(state["lists"])
        report["restored_queued_msgs"] = \
            sum(len(v) for v in state["lists"].values())
    return report


def replay_state(data_dir: str) -> Dict[str, Any]:
    """Apply snapshot + WAL records to an in-memory model (the same
    semantics as kv_server.cc's ApplyRecord) and return
    ``{"kv": {key: bytes}, "lists": {key: [bytes]}, "dedup": [ids]}``.
    Raises ValueError on corruption (use :func:`dry_run_replay` for a
    verdict instead of an exception)."""
    dd = Path(data_dir)
    return _replay(iter_records(dd / "snapshot.wal"),
                   iter_records(dd / "wal"))


def _replay(snap_recs, wal_recs) -> Dict[str, Any]:
    kv: Dict[str, Any] = {}
    lists: Dict[str, List[Any]] = {}
    dedup: List[str] = []
    snap_epoch, wal_epoch = _pairing_epochs(snap_recs, wal_recs)
    if snap_epoch and wal_epoch != snap_epoch:
        wal_recs = []  # unpaired pre-compaction residue: boot
        #                discards it (already folded into the snapshot)
    for args in snap_recs + wal_recs:
        _apply(kv, lists, dedup, args)
    return {"kv": kv, "lists": lists, "dedup": dedup}


def _apply(kv: Dict[str, Any], lists: Dict[str, List[Any]],
           dedup: List[str], args: List[Any]) -> None:
    verb = _str(args[0]).upper()
    key = _str(args[1]) if len(args) > 1 else ""
    if verb == "SET" and len(args) == 3:
        kv[key] = args[2]
    elif verb == "DEL":
        for k in args[1:]:
            kv.pop(_str(k), None)
            lists.pop(_str(k), None)
    elif verb in ("LPUSH", "RPUSH") and len(args) >= 3:
        dq = lists.setdefault(key, [])
        for v in args[2:]:
            dq.insert(0, v) if verb == "LPUSH" else dq.append(v)
    elif verb in ("LPUSHD", "RPUSHD") and len(args) >= 4:
        dedup.append(_str(args[2]))
        dq = lists.setdefault(key, [])
        for v in args[3:]:
            dq.insert(0, v) if verb == "LPUSHD" else dq.append(v)
    elif verb in ("LPOP", "RPOP") and len(args) == 2:
        dq = lists.get(key)
        if dq:
            dq.pop(0) if verb == "LPOP" else dq.pop()
    elif verb == "DEDUP" and len(args) == 2:
        dedup.append(_str(args[1]))
    elif verb == "FLUSHALL":
        kv.clear()
        lists.clear()
        dedup.clear()
    # EXPIRE: TTLs re-arm at boot time; the dry run has no clock to
    # judge them against, so they are framing-validated and skipped


__all__ = ["scan_file", "iter_records", "dry_run_replay",
           "replay_state"]
