// rafiki-kvd — the native kv/queue data-plane server.
//
// The PyTorch/CUDA port's own copy of rafiki_tpu/native/kv_server.cc,
// the same wire protocol, WAL record format and snapshot format, so a
// data directory either build wrote replays in the other. One small
// server on the host carrying (a) trial parameter blobs and (b) the
// predictor's per-worker query/prediction queues. Speaks a
// RESP-compatible subset so the Python client stays trivial
// (thread-per-connection, one store mutex, condition variable for
// blocking pops — the right scale for tens of workers on one host, not
// thousands). rafiki_tpu_torch/native/client.py builds it with g++ at
// first use.
//
// Commands: PING, SET, GET, DEL, EXISTS, KEYS <glob>, INCR,
//           LPUSH, RPUSH, LPUSHD/RPUSHD <key> <dedup_id> <value...>,
//           BRPOP <key...> <timeout_s>, LPOP, RPOP, LLEN,
//           EXPIRE <key> <seconds>, TTL <key>, STATS, COMPACT,
//           FLUSHALL, SHUTDOWN.
//
// EXPIRE delta vs Redis: the TTL survives key deletion/recreation until
// it fires. That is deliberate — the predictor sets a TTL on each
// transient reply queue (q:preds:<query_id>), and a worker's LATE push
// after the gather's discard must not resurrect an immortal key (query
// ids are never reused, so a lingering TTL can only ever collect
// garbage). Without this, every late reply leaked a list forever.
//
// Persistence (--data-dir DIR): every mutating command is appended to an
// append-only WAL of length-prefixed, CRC32-checksummed records, fsynced
// per --fsync policy (always / everysec / no). The WAL is periodically
// compacted into a snapshot (the whole store re-encoded as one batch of
// records, written to a temp file and atomically renamed — the Redis AOF
// rewrite idea), after which the live WAL restarts empty. A compaction
// runs once the WAL outgrows both --wal-rotate-bytes and the last
// snapshot (Redis's auto-aof-rewrite-percentage 100), so its cost is
// amortized over as many bytes of new writes as it rewrites: with
// hundreds of MB of trial parameters stored, a fixed threshold would
// rewrite them all, under the store lock, every few MB of queue traffic
// (the JAX package's copy of this server does). Boot replays
// snapshot then WAL: a torn tail (incomplete record at EOF — the normal
// residue of kill -9 mid-append) is truncated LOUDLY; a CRC-corrupt
// record with its full length present means disk/operator damage, and
// the server refuses to boot with a structured JSON error on stdout
// (exit 4) rather than serve silently-wrong state.
//
// Deduplicated pushes (LPUSHD/RPUSHD): queue pushes from reconnecting
// clients carry a client-minted dedup id; the server keeps a bounded
// recent-set (also WAL-logged and snapshot-carried, so it survives
// restart) and answers a repeated id with the current queue length
// WITHOUT pushing — a retried push after a connection drop or a server
// respawn never double-delivers.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Store {
  std::mutex mu;
  std::condition_variable list_cv;  // signalled on any list push
  std::unordered_map<std::string, std::string> kv;
  std::unordered_map<std::string, std::deque<std::string>> lists;
  // key → absolute expiry; purged opportunistically (throttled scan at
  // command dispatch). Only transient queue keys carry TTLs, so the
  // scan is O(outstanding queries), not O(all blobs).
  std::unordered_map<std::string,
                     std::chrono::steady_clock::time_point> ttl;
  // bounded dedup recent-set for LPUSHD/RPUSHD (insertion-ordered
  // eviction)
  std::deque<std::string> dedup_fifo;
  std::unordered_set<std::string> dedup_set;
};

constexpr size_t kDedupCap = 8192;

Store g_store;
std::atomic<bool> g_shutdown{false};
std::atomic<int64_t> g_last_purge_ms{0};
int g_listen_fd = -1;

// live connection fds, force-shutdown on SHUTDOWN so ServeConn threads
// blocked in read() unblock and the process exits promptly instead of
// waiting for every idle client to hang up
std::mutex g_conns_mu;
std::vector<int> g_conn_fds;

void RegisterConn(int fd) {
  std::lock_guard<std::mutex> l(g_conns_mu);
  g_conn_fds.push_back(fd);
}

void UnregisterConn(int fd) {
  std::lock_guard<std::mutex> l(g_conns_mu);
  for (auto it = g_conn_fds.begin(); it != g_conn_fds.end(); ++it)
    if (*it == fd) { g_conn_fds.erase(it); break; }
}

void ShutdownAllConns() {
  std::lock_guard<std::mutex> l(g_conns_mu);
  for (int fd : g_conn_fds) shutdown(fd, SHUT_RDWR);
}

// ---- crc32 (IEEE 802.3 polynomial, table-driven) ---------------------------
uint32_t Crc32(const char* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = table[(crc ^ static_cast<unsigned char>(data[i])) & 0xFF] ^
          (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---- persistence -----------------------------------------------------------
//
// WAL record framing: [u32 payload_len][u32 crc32(payload)][payload]
// where payload = [u32 nargs] then per arg [u32 len][bytes]. All
// little-endian host order (the WAL never leaves the machine that
// wrote it).

struct Persist {
  bool enabled = false;
  std::string dir;
  int fsync_policy = 1;       // 0 = no, 1 = everysec, 2 = always
  int64_t wal_rotate_bytes = 64LL << 20;
  int wal_fd = -1;
  int64_t wal_bytes = 0;
  int64_t snapshot_bytes = 0;
  std::atomic<bool> dirty{false};
  std::chrono::steady_clock::time_point last_fsync =
      std::chrono::steady_clock::now();
  std::chrono::steady_clock::time_point snapshot_at =
      std::chrono::steady_clock::now();
  bool has_snapshot = false;
  // boot-replay bookkeeping (surfaced via STATS)
  double replay_seconds = 0.0;
  int64_t replayed_records = 0;
  int64_t truncated_bytes = 0;
  int64_t compactions = 0;
  bool in_replay = false;  // replay applies via Execute-side helpers;
  //                          it must never re-log what it reads
  // snapshot/WAL pairing: a snapshot's first record is `EPOCH <id>`
  // and the WAL the SAME compaction reset starts with `WALHDR <id>`.
  // Boot only replays a WAL whose header matches the snapshot's epoch
  // — a crash between the snapshot rename and the WAL truncate leaves
  // the PRE-compaction WAL behind, and replaying it on top of the
  // snapshot that already folded it in would double-deliver every
  // queued message since the previous compaction.
  uint64_t snapshot_epoch = 0;  // expected pairing (0 = no snapshot)
  uint64_t wal_epoch = 0;       // header seen in the WAL (0 = none)
};

Persist g_persist;

std::string WalPath() { return g_persist.dir + "/wal"; }
std::string SnapshotPath() { return g_persist.dir + "/snapshot.wal"; }

void AppendU32(std::string* out, uint32_t v) {
  out->append(reinterpret_cast<const char*>(&v), 4);
}

std::string EncodeRecord(const std::vector<std::string>& args) {
  std::string payload;
  AppendU32(&payload, static_cast<uint32_t>(args.size()));
  for (const auto& a : args) {
    AppendU32(&payload, static_cast<uint32_t>(a.size()));
    payload += a;
  }
  std::string rec;
  AppendU32(&rec, static_cast<uint32_t>(payload.size()));
  AppendU32(&rec, Crc32(payload.data(), payload.size()));
  rec += payload;
  return rec;
}

bool WriteAllFd(int fd, const char* data, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t w = write(fd, data + sent, n - sent);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    sent += static_cast<size_t>(w);
  }
  return true;
}

void MkdirP(const std::string& path) {
  std::string cur;
  for (size_t i = 0; i <= path.size(); ++i) {
    if (i == path.size() || path[i] == '/') {
      if (!cur.empty()) mkdir(cur.c_str(), 0755);
      if (i < path.size()) cur += '/';
    } else {
      cur += path[i];
    }
  }
}

void FsyncDir(const std::string& dir) {
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
}

// forward decl (compaction re-encodes the whole store)
void CompactLocked();

// Append one mutation record. Caller holds g_store.mu so WAL order is
// exactly application order. Deliberately does NOT rotate: several
// command sites log BEFORE applying (so the record can use the args
// pre-move), and an inline compaction here would snapshot the store
// WITHOUT the pending mutation while truncating the WAL record that
// carries it — a durably lost acknowledged write. Rotation runs via
// MaybeRotateLocked() at the END of each mutating branch, after the
// mutation has landed in the store.
void LogLocked(const std::vector<std::string>& args) {
  if (!g_persist.enabled || g_persist.in_replay) return;
  std::string rec = EncodeRecord(args);
  if (!WriteAllFd(g_persist.wal_fd, rec.data(), rec.size())) {
    // an unwritable WAL means durability is gone: better to die loudly
    // (the supervisor respawns and replays what WAS written) than to
    // keep acking writes that will not survive
    fprintf(stderr, "rafiki-kvd: WAL write failed (%s) — aborting\n",
            strerror(errno));
    _exit(5);
  }
  g_persist.wal_bytes += static_cast<int64_t>(rec.size());
  if (g_persist.fsync_policy == 2) {
    fsync(g_persist.wal_fd);
    g_persist.last_fsync = std::chrono::steady_clock::now();
  } else {
    g_persist.dirty.store(true, std::memory_order_relaxed);
  }
}

// Rotation check — call ONLY after the branch's mutation has been
// applied to the store (see LogLocked). The WAL must outgrow the last
// snapshot too: a compaction rewrites the whole store, so it waits until
// at least as many new bytes have been logged.
void MaybeRotateLocked() {
  if (g_persist.enabled && !g_persist.in_replay &&
      g_persist.wal_bytes > std::max(g_persist.wal_rotate_bytes,
                                     g_persist.snapshot_bytes))
    CompactLocked();
}

// Re-encode the whole store as one record batch → temp file → fsync →
// atomic rename over snapshot.wal → truncate the live WAL. Caller
// holds g_store.mu (mutations pause for the duration — acceptable at
// this server's scale, and the only way the snapshot is a consistent
// cut without a fork).
//
// Crash-consistency: the snapshot's first record is `EPOCH <id>` (a
// fresh random 64-bit id per compaction — random, not a counter, so
// an id can never repeat across restarts) and the truncated WAL's
// first record is `WALHDR <id>`. A crash between the rename and the
// truncate leaves the new snapshot next to the PRE-compaction WAL —
// whose header (if any) names a DIFFERENT epoch, so the next boot
// discards it instead of double-applying records the snapshot already
// folded in.
void CompactLocked() {
  if (!g_persist.enabled) return;
  std::string tmp = SnapshotPath() + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    fprintf(stderr, "rafiki-kvd: cannot write snapshot %s: %s\n",
            tmp.c_str(), strerror(errno));
    return;  // keep the WAL growing — durable, just not compact
  }
  std::string buf;
  auto flush = [&]() -> bool {
    if (buf.empty()) return true;
    bool ok = WriteAllFd(fd, buf.data(), buf.size());
    buf.clear();
    return ok;
  };
  bool ok = true;
  int64_t bytes = 0;
  auto add = [&](const std::vector<std::string>& args) {
    std::string rec = EncodeRecord(args);
    bytes += static_cast<int64_t>(rec.size());
    buf += rec;
    if (buf.size() > (1u << 20)) ok = ok && flush();
  };
  uint64_t epoch = 0;
  {
    FILE* ur = fopen("/dev/urandom", "rb");
    if (ur != nullptr) {
      if (fread(&epoch, sizeof(epoch), 1, ur) != 1) epoch = 0;
      fclose(ur);
    }
    if (epoch == 0)  // urandom unavailable: clock ticks still never
      epoch = static_cast<uint64_t>(  // repeat across restarts
          std::chrono::steady_clock::now().time_since_epoch().count())
          ^ (static_cast<uint64_t>(getpid()) << 48);
  }
  add({"EPOCH", std::to_string(epoch)});
  for (const auto& [k, v] : g_store.kv) add({"SET", k, v});
  for (const auto& [k, dq] : g_store.lists) {
    if (dq.empty()) continue;
    std::vector<std::string> rec = {"RPUSH", k};
    for (const auto& v : dq) rec.push_back(v);
    add(rec);
  }
  auto now = std::chrono::steady_clock::now();
  for (const auto& [k, dl] : g_store.ttl) {
    double remain =
        std::chrono::duration<double>(dl - now).count();
    if (remain < 0.0) remain = 0.0;
    add({"EXPIRE", k, std::to_string(remain)});
  }
  for (const auto& id : g_store.dedup_fifo) add({"DEDUP", id});
  ok = ok && flush();
  ok = ok && fsync(fd) == 0;
  close(fd);
  if (!ok) {
    fprintf(stderr, "rafiki-kvd: snapshot write failed: %s\n",
            strerror(errno));
    unlink(tmp.c_str());
    return;
  }
  if (rename(tmp.c_str(), SnapshotPath().c_str()) != 0) {
    fprintf(stderr, "rafiki-kvd: snapshot rename failed: %s\n",
            strerror(errno));
    unlink(tmp.c_str());
    return;
  }
  FsyncDir(g_persist.dir);
  // snapshot durable: the WAL restarts with the pairing header
  if (g_persist.wal_fd >= 0) close(g_persist.wal_fd);
  g_persist.wal_fd =
      open(WalPath().c_str(), O_WRONLY | O_CREAT | O_TRUNC | O_APPEND,
           0644);
  if (g_persist.wal_fd < 0) {
    fprintf(stderr, "rafiki-kvd: cannot reopen WAL after compaction: "
            "%s — aborting\n", strerror(errno));
    _exit(5);
  }
  std::string hdr = EncodeRecord({"WALHDR", std::to_string(epoch)});
  if (!WriteAllFd(g_persist.wal_fd, hdr.data(), hdr.size())) {
    fprintf(stderr, "rafiki-kvd: cannot write WAL header after "
            "compaction: %s — aborting\n", strerror(errno));
    _exit(5);
  }
  fsync(g_persist.wal_fd);
  g_persist.snapshot_epoch = epoch;
  g_persist.wal_epoch = epoch;
  g_persist.wal_bytes = static_cast<int64_t>(hdr.size());
  g_persist.snapshot_bytes = bytes;
  g_persist.has_snapshot = true;
  g_persist.snapshot_at = std::chrono::steady_clock::now();
  g_persist.last_fsync = g_persist.snapshot_at;
  g_persist.compactions += 1;
}

// ---- replay ----------------------------------------------------------------

void NoteDedupLocked(const std::string& id) {
  if (g_store.dedup_set.insert(id).second) {
    g_store.dedup_fifo.push_back(id);
    while (g_store.dedup_fifo.size() > kDedupCap) {
      g_store.dedup_set.erase(g_store.dedup_fifo.front());
      g_store.dedup_fifo.pop_front();
    }
  }
}

void ArmTtlLocked(const std::string& key, double secs) {
  g_store.ttl[key] =
      std::chrono::steady_clock::now() +
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(secs));
}

// Apply one already-decoded record to the store (no logging, no
// locking — replay runs single-threaded before the listener starts).
// Returns false for a record that cannot be applied (unknown verb =
// a WAL from a newer server, refuse rather than half-replay).
bool ApplyRecord(const std::vector<std::string>& args) {
  if (args.empty()) return false;
  std::string cmd = args[0];
  for (auto& c : cmd) c = static_cast<char>(toupper(c));
  if (cmd == "SET" && args.size() == 3) {
    g_store.kv[args[1]] = args[2];
    return true;
  }
  if (cmd == "DEL" && args.size() >= 2) {
    for (size_t i = 1; i < args.size(); ++i) {
      g_store.kv.erase(args[i]);
      g_store.lists.erase(args[i]);
    }
    return true;
  }
  if ((cmd == "LPUSH" || cmd == "RPUSH") && args.size() >= 3) {
    auto& dq = g_store.lists[args[1]];
    for (size_t i = 2; i < args.size(); ++i) {
      if (cmd == "LPUSH") dq.push_front(args[i]);
      else dq.push_back(args[i]);
    }
    return true;
  }
  if ((cmd == "LPUSHD" || cmd == "RPUSHD") && args.size() >= 4) {
    NoteDedupLocked(args[2]);
    auto& dq = g_store.lists[args[1]];
    for (size_t i = 3; i < args.size(); ++i) {
      if (cmd == "LPUSHD") dq.push_front(args[i]);
      else dq.push_back(args[i]);
    }
    return true;
  }
  if ((cmd == "LPOP" || cmd == "RPOP") && args.size() == 2) {
    auto it = g_store.lists.find(args[1]);
    if (it != g_store.lists.end() && !it->second.empty()) {
      if (cmd == "LPOP") it->second.pop_front();
      else it->second.pop_back();
    }
    return true;
  }
  if (cmd == "EXPIRE" && args.size() == 3) {
    ArmTtlLocked(args[1], strtod(args[2].c_str(), nullptr));
    return true;
  }
  if (cmd == "DEDUP" && args.size() == 2) {
    NoteDedupLocked(args[1]);
    return true;
  }
  if (cmd == "FLUSHALL") {
    g_store.kv.clear();
    g_store.lists.clear();
    g_store.ttl.clear();
    g_store.dedup_fifo.clear();
    g_store.dedup_set.clear();
    return true;
  }
  if (cmd == "EPOCH" && args.size() == 2) {
    g_persist.snapshot_epoch = strtoull(args[1].c_str(), nullptr, 10);
    return true;
  }
  if (cmd == "WALHDR" && args.size() == 2) {
    g_persist.wal_epoch = strtoull(args[1].c_str(), nullptr, 10);
    return true;
  }
  return false;
}

uint32_t ReadU32(const std::string& buf, size_t off) {
  uint32_t v;
  memcpy(&v, buf.data() + off, 4);
  return v;
}

// Replay one persistence file. Returns false on CRC corruption (boot
// must fail); a torn tail is truncated in place and reported.
bool ReplayFile(const std::string& path, bool truncate_torn) {
  FILE* f = fopen(path.c_str(), "rb");
  if (f == nullptr) return true;  // absent = nothing to replay
  std::string buf;
  char chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), f)) > 0) buf.append(chunk, n);
  fclose(f);
  size_t off = 0;
  while (off < buf.size()) {
    if (off + 8 > buf.size()) break;  // torn header
    uint32_t len = ReadU32(buf, off);
    if (len > (1u << 30)) {
      // an absurd length is indistinguishable from scribbled-over
      // framing: corruption, not a torn append
      fprintf(stdout,
              "{\"error\": \"kvd_wal_corrupt\", \"file\": \"%s\", "
              "\"offset\": %zu, \"detail\": \"record length %u "
              "exceeds 1GiB bound\"}\n",
              path.c_str(), off, len);
      return false;
    }
    if (off + 8 + len > buf.size()) break;  // torn payload
    uint32_t crc = ReadU32(buf, off + 4);
    if (Crc32(buf.data() + off + 8, len) != crc) {
      fprintf(stdout,
              "{\"error\": \"kvd_wal_corrupt\", \"file\": \"%s\", "
              "\"offset\": %zu, \"detail\": \"crc mismatch\"}\n",
              path.c_str(), off);
      return false;
    }
    // decode args
    std::vector<std::string> args;
    size_t p = off + 8;
    size_t end = off + 8 + len;
    bool ok = len >= 4;
    if (ok) {
      uint32_t nargs = ReadU32(buf, p);
      p += 4;
      for (uint32_t i = 0; i < nargs && ok; ++i) {
        if (p + 4 > end) { ok = false; break; }
        uint32_t alen = ReadU32(buf, p);
        p += 4;
        if (p + alen > end) { ok = false; break; }
        args.emplace_back(buf.data() + p, alen);
        p += alen;
      }
    }
    if (!ok || !ApplyRecord(args)) {
      fprintf(stdout,
              "{\"error\": \"kvd_wal_corrupt\", \"file\": \"%s\", "
              "\"offset\": %zu, \"detail\": \"undecodable record\"}\n",
              path.c_str(), off);
      return false;
    }
    g_persist.replayed_records += 1;
    off += 8 + len;
  }
  if (off < buf.size()) {
    // torn tail: the normal residue of kill -9 mid-append. Truncate
    // LOUDLY — the lost suffix was never acknowledged as durable
    // under any fsync policy weaker than the crash.
    fprintf(stderr,
            "rafiki-kvd: truncating torn tail of %s: %zu byte(s) "
            "past the last complete record at offset %zu\n",
            path.c_str(), buf.size() - off, off);
    g_persist.truncated_bytes +=
        static_cast<int64_t>(buf.size() - off);
    if (truncate_torn) {
      if (truncate(path.c_str(), static_cast<off_t>(off)) != 0)
        fprintf(stderr, "rafiki-kvd: truncate(%s) failed: %s\n",
                path.c_str(), strerror(errno));
    }
  }
  return true;
}

// Decode the WAL's first record WITHOUT applying it; returns its
// WALHDR epoch, or 0 when the file is absent/empty/not-a-header (the
// gating caller treats 0 as "unpaired").
uint64_t PeekWalEpoch(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (f == nullptr) return 0;
  char hdr[8];
  uint64_t out = 0;
  std::string payload;
  do {
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len, crc;
    memcpy(&len, hdr, 4);
    memcpy(&crc, hdr + 4, 4);
    if (len < 8 || len > 256) break;  // WALHDR records are tiny
    payload.resize(len);
    if (fread(payload.data(), 1, len, f) != len) break;
    if (Crc32(payload.data(), len) != crc) break;
    uint32_t nargs, a0len;
    memcpy(&nargs, payload.data(), 4);
    memcpy(&a0len, payload.data() + 4, 4);
    if (nargs != 2 || a0len != 6 ||
        payload.compare(8, 6, "WALHDR") != 0)
      break;
    uint32_t a1len;
    memcpy(&a1len, payload.data() + 14, 4);
    if (18 + a1len > len) break;
    out = strtoull(payload.substr(18, a1len).c_str(), nullptr, 10);
  } while (false);
  fclose(f);
  return out;
}

// Returns false when boot must fail (corrupt records).
bool LoadPersisted() {
  auto t0 = std::chrono::steady_clock::now();
  g_persist.in_replay = true;
  struct stat st;
  if (stat(SnapshotPath().c_str(), &st) == 0) {
    g_persist.snapshot_bytes = st.st_size;
    g_persist.has_snapshot = true;
    g_persist.snapshot_at = std::chrono::steady_clock::now();
    if (!ReplayFile(SnapshotPath(), /*truncate_torn=*/false))
      return false;
  }
  bool wal_paired = true;
  if (g_persist.snapshot_epoch != 0 &&
      PeekWalEpoch(WalPath()) != g_persist.snapshot_epoch) {
    // the WAL does not belong to this snapshot: a crash landed
    // between the snapshot rename and the WAL truncate, so every
    // record in it is ALREADY folded into the snapshot — replaying
    // would double-deliver. Discard it loudly.
    wal_paired = false;
    if (stat(WalPath().c_str(), &st) == 0 && st.st_size > 0) {
      fprintf(stderr,
              "rafiki-kvd: discarding stale pre-compaction WAL "
              "(%lld byte(s), unpaired with snapshot epoch %llu) — "
              "its records are already in the snapshot\n",
              static_cast<long long>(st.st_size),
              static_cast<unsigned long long>(
                  g_persist.snapshot_epoch));
      g_persist.truncated_bytes += st.st_size;
      if (truncate(WalPath().c_str(), 0) != 0) {
        fprintf(stdout,
                "{\"error\": \"kvd_wal_unwritable\", \"file\": "
                "\"%s\", \"detail\": \"cannot discard stale WAL: "
                "%s\"}\n",
                WalPath().c_str(), strerror(errno));
        return false;
      }
    }
  }
  if (wal_paired &&
      !ReplayFile(WalPath(), /*truncate_torn=*/true))
    return false;
  g_persist.in_replay = false;
  if (stat(WalPath().c_str(), &st) == 0)
    g_persist.wal_bytes = st.st_size;
  g_persist.wal_fd =
      open(WalPath().c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (g_persist.wal_fd < 0) {
    fprintf(stdout,
            "{\"error\": \"kvd_wal_unwritable\", \"file\": \"%s\", "
            "\"detail\": \"%s\"}\n",
            WalPath().c_str(), strerror(errno));
    return false;
  }
  if (g_persist.snapshot_epoch != 0 &&
      g_persist.wal_epoch != g_persist.snapshot_epoch) {
    // discarded-stale or crashed-before-header case: re-pair the live
    // WAL with the snapshot NOW, or the records appended from here on
    // would themselves read as unpaired at the next boot
    std::string rec = EncodeRecord(
        {"WALHDR", std::to_string(g_persist.snapshot_epoch)});
    if (!WriteAllFd(g_persist.wal_fd, rec.data(), rec.size())) {
      fprintf(stdout,
              "{\"error\": \"kvd_wal_unwritable\", \"file\": \"%s\", "
              "\"detail\": \"cannot write pairing header: %s\"}\n",
              WalPath().c_str(), strerror(errno));
      return false;
    }
    fsync(g_persist.wal_fd);
    g_persist.wal_epoch = g_persist.snapshot_epoch;
    g_persist.wal_bytes += static_cast<int64_t>(rec.size());
  }
  g_persist.replay_seconds =
      std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                    t0)
          .count();
  if (g_persist.replayed_records > 0)
    fprintf(stderr,
            "rafiki-kvd: replayed %lld record(s) in %.3fs "
            "(%lld truncated byte(s))\n",
            static_cast<long long>(g_persist.replayed_records),
            g_persist.replay_seconds,
            static_cast<long long>(g_persist.truncated_bytes));
  return true;
}

void FsyncLoop() {
  int ticks = 0;
  while (!g_shutdown.load()) {
    // 100ms ticks so process exit never waits out a full second, but
    // the fsync itself still runs at the policy's 1s cadence
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    if (++ticks < 10) continue;
    ticks = 0;
    if (g_persist.dirty.exchange(false, std::memory_order_relaxed)) {
      // fsync OUTSIDE g_store.mu: a slow-disk fsync must not pause
      // every command for its duration. dup() under the lock pins the
      // same open file description, so a concurrent compaction
      // swapping wal_fd can't invalidate the fd mid-fsync (flushing
      // the pre-compaction file late is harmless — compaction fsyncs
      // its replacement itself).
      int dupfd = -1;
      {
        std::lock_guard<std::mutex> l(g_store.mu);
        if (g_persist.wal_fd >= 0) dupfd = dup(g_persist.wal_fd);
      }
      if (dupfd >= 0) {
        fsync(dupfd);
        close(dupfd);
        std::lock_guard<std::mutex> l(g_store.mu);
        g_persist.last_fsync = std::chrono::steady_clock::now();
      }
    }
  }
}

void PurgeExpiredLocked() {
  auto now = std::chrono::steady_clock::now();
  for (auto it = g_store.ttl.begin(); it != g_store.ttl.end();) {
    if (it->second <= now) {
      g_store.kv.erase(it->first);
      g_store.lists.erase(it->first);
      it = g_store.ttl.erase(it);
    } else {
      ++it;
    }
  }
}

void MaybePurgeExpired() {
  // throttle the scan: correctness only needs eventual collection
  int64_t now_ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                       std::chrono::steady_clock::now().time_since_epoch())
                       .count();
  int64_t last = g_last_purge_ms.load(std::memory_order_relaxed);
  if (now_ms - last < 50) return;
  if (!g_last_purge_ms.compare_exchange_strong(last, now_ms)) return;
  std::lock_guard<std::mutex> l(g_store.mu);
  PurgeExpiredLocked();
}

// ---- glob match (supports * and ?) ----------------------------------------
bool GlobMatch(const char* p, const char* s) {
  for (; *p; ++p, ++s) {
    if (*p == '*') {
      while (*(p + 1) == '*') ++p;
      for (const char* t = s + strlen(s); t >= s; --t)
        if (GlobMatch(p + 1, t)) return true;
      return false;
    }
    if (*s == '\0' || (*p != '?' && *p != *s)) return false;
  }
  return *s == '\0';
}

// ---- socket io ------------------------------------------------------------
bool ReadN(int fd, char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = read(fd, buf + got, n - got);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

bool ReadLine(int fd, std::string* out) {
  // RESP lines are short (headers only); read byte-wise up to CRLF.
  out->clear();
  char c;
  while (true) {
    if (!ReadN(fd, &c, 1)) return false;
    if (c == '\r') {
      if (!ReadN(fd, &c, 1) || c != '\n') return false;
      return true;
    }
    out->push_back(c);
    if (out->size() > 1 << 16) return false;  // header bomb guard
  }
}

bool WriteAll(int fd, const std::string& data) {
  size_t sent = 0;
  while (sent < data.size()) {
    ssize_t w = write(fd, data.data() + sent, data.size() - sent);
    if (w <= 0) return false;
    sent += static_cast<size_t>(w);
  }
  return true;
}

std::string Bulk(const std::string& s) {
  return "$" + std::to_string(s.size()) + "\r\n" + s + "\r\n";
}
const std::string kNil = "$-1\r\n";
const std::string kNilArray = "*-1\r\n";
std::string Int(long long v) { return ":" + std::to_string(v) + "\r\n"; }
std::string Err(const std::string& m) { return "-ERR " + m + "\r\n"; }

std::string StatsReply() {
  std::lock_guard<std::mutex> l(g_store.mu);
  auto now = std::chrono::steady_clock::now();
  auto age = [&](std::chrono::steady_clock::time_point t) {
    return std::chrono::duration<double>(now - t).count();
  };
  const char* pol = g_persist.fsync_policy == 2   ? "always"
                    : g_persist.fsync_policy == 1 ? "everysec"
                                                  : "no";
  char line[256];
  std::string out;
  auto addi = [&](const char* k, long long v) {
    snprintf(line, sizeof(line), "%s %lld\n", k, v);
    out += line;
  };
  auto addf = [&](const char* k, double v) {
    snprintf(line, sizeof(line), "%s %.6f\n", k, v);
    out += line;
  };
  addi("persist_enabled", g_persist.enabled ? 1 : 0);
  out += std::string("fsync_policy ") + pol + "\n";
  addi("wal_bytes", g_persist.wal_bytes);
  addi("snapshot_bytes", g_persist.snapshot_bytes);
  addf("snapshot_age_s",
       g_persist.has_snapshot ? age(g_persist.snapshot_at) : -1.0);
  addf("last_fsync_age_s",
       g_persist.enabled ? age(g_persist.last_fsync) : -1.0);
  addf("replay_seconds", g_persist.replay_seconds);
  addi("replayed_records", g_persist.replayed_records);
  addi("wal_truncated_bytes", g_persist.truncated_bytes);
  addi("compactions", g_persist.compactions);
  addi("dedup_ids", static_cast<long long>(g_store.dedup_fifo.size()));
  addi("keys", static_cast<long long>(g_store.kv.size()));
  addi("lists", static_cast<long long>(g_store.lists.size()));
  return Bulk(out);
}

// ---- command dispatch ------------------------------------------------------
std::string Execute(std::vector<std::string>& args) {
  std::string cmd = args[0];
  for (auto& c : cmd) c = static_cast<char>(toupper(c));
  MaybePurgeExpired();

  if (cmd == "PING") return "+PONG\r\n";
  if (cmd == "SHUTDOWN") {
    {
      // make everything acknowledged so far durable before the
      // graceful exit (kill -9 skips this path by definition)
      std::lock_guard<std::mutex> l(g_store.mu);
      if (g_persist.enabled && g_persist.wal_fd >= 0) {
        fsync(g_persist.wal_fd);
        g_persist.last_fsync = std::chrono::steady_clock::now();
      }
    }
    g_shutdown.store(true);
    if (g_listen_fd >= 0) shutdown(g_listen_fd, SHUT_RDWR);
    ShutdownAllConns();
    return "+OK\r\n";
  }
  if (cmd == "STATS" || cmd == "INFO") return StatsReply();
  if (cmd == "COMPACT") {
    std::lock_guard<std::mutex> l(g_store.mu);
    if (!g_persist.enabled) return Err("no --data-dir configured");
    CompactLocked();
    return "+OK\r\n";
  }
  if (cmd == "FLUSHALL") {
    std::lock_guard<std::mutex> l(g_store.mu);
    g_store.kv.clear();
    g_store.lists.clear();
    g_store.ttl.clear();
    g_store.dedup_fifo.clear();
    g_store.dedup_set.clear();
    LogLocked({"FLUSHALL"});
    MaybeRotateLocked();
    return "+OK\r\n";
  }
  if (cmd == "TTL" && args.size() == 2) {
    // redis semantics: -2 missing key, -1 no expiry, else seconds left
    // (rounded UP, like redis). A key DEL'd while its TTL survives
    // (the kvd reply-queue deviation) reports -2 here — the armed TTL
    // is an internal condemnation, not key liveness.
    std::lock_guard<std::mutex> l(g_store.mu);
    bool exists = g_store.kv.count(args[1]) || g_store.lists.count(args[1]);
    if (!exists) return Int(-2);
    auto it = g_store.ttl.find(args[1]);
    if (it == g_store.ttl.end()) return Int(-1);
    auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                  it->second - std::chrono::steady_clock::now())
                  .count();
    return Int(ms <= 0 ? 0 : (ms + 999) / 1000);
  }
  if (cmd == "EXPIRE" && args.size() == 3) {
    double secs = strtod(args[2].c_str(), nullptr);
    std::lock_guard<std::mutex> l(g_store.mu);
    // unlike Redis, the key need not exist yet: the predictor arms the
    // TTL when it ISSUES a query, so even a reply that arrives after
    // the gather's discard is already condemned
    ArmTtlLocked(args[1], secs);
    LogLocked({"EXPIRE", args[1], args[2]});
    MaybeRotateLocked();
    return Int(1);
  }
  if (cmd == "SET" && args.size() == 3) {
    std::lock_guard<std::mutex> l(g_store.mu);
    LogLocked({"SET", args[1], args[2]});
    g_store.kv[args[1]] = std::move(args[2]);
    MaybeRotateLocked();
    return "+OK\r\n";
  }
  if (cmd == "GET" && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    auto it = g_store.kv.find(args[1]);
    return it == g_store.kv.end() ? kNil : Bulk(it->second);
  }
  if (cmd == "DEL" && args.size() >= 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    long long n = 0;
    for (size_t i = 1; i < args.size(); ++i) {
      n += g_store.kv.erase(args[i]);
      n += g_store.lists.erase(args[i]);
    }
    if (n > 0) {
      LogLocked(args);
      MaybeRotateLocked();
    }
    return Int(n);
  }
  if (cmd == "EXISTS" && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    return Int(g_store.kv.count(args[1]) || g_store.lists.count(args[1]));
  }
  if (cmd == "KEYS" && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    std::string out;
    long long n = 0;
    for (auto& [k, _] : g_store.kv)
      if (GlobMatch(args[1].c_str(), k.c_str())) { out += Bulk(k); ++n; }
    for (auto& [k, _] : g_store.lists)
      if (GlobMatch(args[1].c_str(), k.c_str())) { out += Bulk(k); ++n; }
    return "*" + std::to_string(n) + "\r\n" + out;
  }
  if (cmd == "INCR" && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    auto& v = g_store.kv[args[1]];
    long long n = v.empty() ? 0 : strtoll(v.c_str(), nullptr, 10);
    v = std::to_string(n + 1);
    // logged as SET-of-result: replaying an INCR record twice (or
    // against a snapshot that already holds the result) must not
    // double-count
    LogLocked({"SET", args[1], v});
    MaybeRotateLocked();
    return Int(n + 1);
  }
  if ((cmd == "LPUSH" || cmd == "RPUSH") && args.size() >= 3) {
    std::lock_guard<std::mutex> l(g_store.mu);
    LogLocked(args);
    auto& dq = g_store.lists[args[1]];
    for (size_t i = 2; i < args.size(); ++i) {
      if (cmd == "LPUSH") dq.push_front(std::move(args[i]));
      else dq.push_back(std::move(args[i]));
    }
    g_store.list_cv.notify_all();
    MaybeRotateLocked();
    return Int(static_cast<long long>(dq.size()));
  }
  if ((cmd == "LPUSHD" || cmd == "RPUSHD") && args.size() >= 4) {
    // deduplicated push: <key> <dedup_id> <value...>. A repeated id
    // (client retry after a connection drop / server respawn) answers
    // with the current length WITHOUT pushing or logging.
    std::lock_guard<std::mutex> l(g_store.mu);
    auto& dq = g_store.lists[args[1]];
    if (g_store.dedup_set.count(args[2]))
      return Int(static_cast<long long>(dq.size()));
    LogLocked(args);
    NoteDedupLocked(args[2]);
    for (size_t i = 3; i < args.size(); ++i) {
      if (cmd == "LPUSHD") dq.push_front(std::move(args[i]));
      else dq.push_back(std::move(args[i]));
    }
    g_store.list_cv.notify_all();
    MaybeRotateLocked();
    return Int(static_cast<long long>(dq.size()));
  }
  if ((cmd == "LPOP" || cmd == "RPOP") && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    auto it = g_store.lists.find(args[1]);
    if (it == g_store.lists.end() || it->second.empty()) return kNil;
    std::string v;
    if (cmd == "LPOP") {
      v = std::move(it->second.front());
      it->second.pop_front();
    } else {
      v = std::move(it->second.back());
      it->second.pop_back();
    }
    LogLocked({cmd, args[1]});
    MaybeRotateLocked();
    return Bulk(v);
  }
  if (cmd == "LLEN" && args.size() == 2) {
    std::lock_guard<std::mutex> l(g_store.mu);
    auto it = g_store.lists.find(args[1]);
    return Int(it == g_store.lists.end()
                   ? 0
                   : static_cast<long long>(it->second.size()));
  }
  if (cmd == "BRPOP" && args.size() >= 3) {
    // BRPOP key [key...] timeout_seconds — pops the *tail* of the first
    // non-empty key; replies *2 [key, value] or nil-array on timeout.
    double timeout_s = strtod(args.back().c_str(), nullptr);
    std::vector<std::string> keys(args.begin() + 1, args.end() - 1);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(timeout_s));
    std::unique_lock<std::mutex> l(g_store.mu);
    auto try_pop = [&](std::string* out) -> bool {
      for (auto& k : keys) {
        auto it = g_store.lists.find(k);
        if (it != g_store.lists.end() && !it->second.empty()) {
          std::string v = std::move(it->second.back());
          it->second.pop_back();
          LogLocked({"RPOP", k});  // the pop is the mutation; replay
          //                          must not re-deliver it
          MaybeRotateLocked();
          *out = "*2\r\n" + Bulk(k) + Bulk(v);
          return true;
        }
      }
      return false;
    };
    std::string reply;
    while (true) {
      if (try_pop(&reply)) return reply;
      if (g_shutdown.load()) return kNilArray;
      if (timeout_s <= 0) {  // 0 = wait forever (redis semantics)
        g_store.list_cv.wait_for(l, std::chrono::milliseconds(100));
      } else {
        if (g_store.list_cv.wait_until(l, deadline) ==
            std::cv_status::timeout) {
          // re-check once after timeout, then give up
          if (try_pop(&reply)) return reply;
          return kNilArray;
        }
      }
    }
  }
  return Err("unknown command or wrong arity: " + cmd);
}

void ServeConn(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  RegisterConn(fd);
  std::string line;
  while (!g_shutdown.load()) {
    if (!ReadLine(fd, &line) || line.empty() || line[0] != '*') break;
    long n = strtol(line.c_str() + 1, nullptr, 10);
    if (n <= 0 || n > 1 << 20) break;
    std::vector<std::string> args;
    args.reserve(static_cast<size_t>(n));
    bool ok = true;
    for (long i = 0; i < n && ok; ++i) {
      if (!ReadLine(fd, &line) || line.empty() || line[0] != '$') {
        ok = false;
        break;
      }
      long len = strtol(line.c_str() + 1, nullptr, 10);
      if (len < 0 || len > (1L << 31)) { ok = false; break; }
      std::string payload(static_cast<size_t>(len), '\0');
      if (!ReadN(fd, payload.data(), static_cast<size_t>(len))) {
        ok = false;
        break;
      }
      char crlf[2];
      if (!ReadN(fd, crlf, 2)) { ok = false; break; }
      args.push_back(std::move(payload));
    }
    if (!ok || args.empty()) break;
    if (!WriteAll(fd, Execute(args))) break;
  }
  UnregisterConn(fd);
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 6399;
  const char* host = "127.0.0.1";
  for (int i = 1; i < argc - 1; ++i) {
    if (!strcmp(argv[i], "--port")) port = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--host")) host = argv[i + 1];
    if (!strcmp(argv[i], "--data-dir")) g_persist.dir = argv[i + 1];
    if (!strcmp(argv[i], "--wal-rotate-bytes"))
      g_persist.wal_rotate_bytes = strtoll(argv[i + 1], nullptr, 10);
    if (!strcmp(argv[i], "--fsync")) {
      std::string p = argv[i + 1];
      if (p == "always") g_persist.fsync_policy = 2;
      else if (p == "everysec") g_persist.fsync_policy = 1;
      else if (p == "no") g_persist.fsync_policy = 0;
      else {
        fprintf(stderr, "rafiki-kvd: bad --fsync %s "
                "(always|everysec|no)\n", p.c_str());
        return 2;
      }
    }
  }
  signal(SIGPIPE, SIG_IGN);

  std::thread fsync_thread;
  if (!g_persist.dir.empty()) {
    g_persist.enabled = true;
    MkdirP(g_persist.dir);
    if (!LoadPersisted()) {
      // the structured JSON error is already on stdout: a corrupt WAL
      // must fail the boot, not silently serve wrong state
      fflush(stdout);
      return 4;
    }
    // the everysec fsync thread starts only after listen() succeeds
    // below: a bind failure's `return 1` with a joinable thread would
    // std::terminate instead of exiting cleanly for the supervisor
  }

  g_listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(g_listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (bind(g_listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
      0) {
    perror("bind");
    return 1;
  }
  // port 0 → kernel-assigned; report the real one for the spawner
  socklen_t alen = sizeof(addr);
  getsockname(g_listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  if (listen(g_listen_fd, 128) < 0) {
    perror("listen");
    return 1;
  }
  if (g_persist.enabled && g_persist.fsync_policy == 1)
    fsync_thread = std::thread(FsyncLoop);
  fprintf(stdout, "rafiki-kvd listening on %s:%d\n", host,
          ntohs(addr.sin_port));
  fflush(stdout);

  std::vector<std::thread> conns;
  while (!g_shutdown.load()) {
    int fd = accept(g_listen_fd, nullptr, nullptr);
    if (fd < 0) break;
    conns.emplace_back(ServeConn, fd);
  }
  g_store.list_cv.notify_all();
  close(g_listen_fd);
  for (auto& t : conns)
    if (t.joinable()) t.join();
  if (fsync_thread.joinable()) fsync_thread.join();
  {
    std::lock_guard<std::mutex> l(g_store.mu);
    if (g_persist.enabled && g_persist.wal_fd >= 0) {
      fsync(g_persist.wal_fd);
      close(g_persist.wal_fd);
    }
  }
  return 0;
}
