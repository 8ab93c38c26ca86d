// Native byte-level BPE chunk encoder (a shared library loaded with
// ctypes by rafiki_tpu_torch/data/bpe.py).
//
// The serving host tokenizes every request on the CPU before anything
// reaches the card; the merge loop (find the best-ranked adjacent pair,
// splice, repeat) is that path's hotspot and pure integer work. The
// algorithm is rafiki_tpu_torch/data/bpe.py::_bpe_chunk's, token for
// token: the same id layout (specials, 256 byte ids, one id per merge in
// training order) and the same lowest-rank-first merge policy, so the
// Python loop and this encoder are interchangeable (the tests hold them
// identical).
//
// C ABI (loaded through ctypes):
//   rbpe_create(pairs, n_merges) -> handle   (pairs: 2*n_merges int32)
//   rbpe_encode_chunk(handle, bytes, len, out, cap) -> n ids (or -1
//     if cap is too small; out is never overrun)
//   rbpe_free(handle)
//
// Built with g++ at first use (native/client.py ensure_built).

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

using std::size_t;

namespace {

constexpr int32_t kNSpecial = 3;   // PAD/BOS/EOS: bpe.py N_SPECIAL
constexpr int32_t kNBytes = 256;

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct Encoder {
  // (left, right) -> merge rank; merge r produces id kNSpecial+kNBytes+r
  std::unordered_map<uint64_t, int32_t> rank;
};

}  // namespace

extern "C" {

void* rbpe_create(const int32_t* pairs, int32_t n_merges) {
  auto* enc = new Encoder();
  enc->rank.reserve(static_cast<size_t>(n_merges) * 2);
  for (int32_t i = 0; i < n_merges; ++i) {
    enc->rank.emplace(pair_key(pairs[2 * i], pairs[2 * i + 1]), i);
  }
  return enc;
}

void rbpe_free(void* handle) { delete static_cast<Encoder*>(handle); }

int32_t rbpe_encode_chunk(void* handle, const uint8_t* chunk,
                          int32_t len, int32_t* out, int32_t cap) {
  const auto* enc = static_cast<Encoder*>(handle);
  if (len > cap) return -1;
  std::vector<int32_t> ids(static_cast<size_t>(len));
  for (int32_t i = 0; i < len; ++i) ids[i] = kNSpecial + chunk[i];

  // classic BPE: repeatedly merge the lowest-ranked adjacent pair, one
  // splice pass per round, as the Python loop does.
  while (ids.size() > 1) {
    int32_t best_rank = INT32_MAX;
    uint64_t best = 0;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      auto it = enc->rank.find(pair_key(ids[i], ids[i + 1]));
      if (it != enc->rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best = pair_key(ids[i], ids[i + 1]);
      }
    }
    if (best_rank == INT32_MAX) break;
    const int32_t merged = kNSpecial + kNBytes + best_rank;
    size_t w = 0;
    for (size_t i = 0; i < ids.size();) {
      if (i + 1 < ids.size() && pair_key(ids[i], ids[i + 1]) == best) {
        ids[w++] = merged;
        i += 2;
      } else {
        ids[w++] = ids[i++];
      }
    }
    ids.resize(w);
  }
  if (static_cast<int32_t>(ids.size()) > cap) return -1;
  for (size_t i = 0; i < ids.size(); ++i) out[i] = ids[i];
  return static_cast<int32_t>(ids.size());
}

}  // extern "C"
