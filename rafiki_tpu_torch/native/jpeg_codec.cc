// Native JPEG codec (a shared library loaded with ctypes by
// rafiki_tpu_torch/data/jpeg.py).
//
// The JAX package reads and writes JPEG through PIL, which runs
// libjpeg-turbo with its defaults. The card's machine has no PIL, so the
// port keeps its own codec, written to give the same integers:
//
// Decoder: baseline and extended sequential (SOF0, SOF1) and progressive
// (SOF2) Huffman-coded files with 8-bit samples, one component
// (greyscale) or three (YCbCr, or RGB under an Adobe APP14 marker with
// transform 0 or the component ids 'R','G','B'), sampling factors up to
// 4 and restart intervals. Every step is libjpeg's integer arithmetic:
// the ISLOW inverse DCT (jidctint.c; its output clamped as the SIMD
// build's saturating packs clamp), "fancy" triangular upsampling for
// h2v1, h1v2 and h2v2 (jdsample.c; plain replication when the
// downsampled width is 2 or less, and for other integral factors), edge
// rows and columns replicated as jdmainct.c's context pointers replicate
// them, and the fixed-point YCbCr->RGB tables of jdcolor.c. Refused by
// name: 4 components (CMYK/YCCK), arithmetic coding, lossless,
// hierarchical, and samples of other than 8 bits.
//
// Encoder: what PIL's Image.save(format="JPEG") writes with its defaults
// and nothing more: quality 75 (jcparam.c's scaled Annex K tables),
// 4:2:0 YCbCr for RGB input and one component for greyscale, baseline,
// the standard Huffman tables, a JFIF 1.01 APP0, and libjpeg's marker
// order. The pixel path is jccolor.c's RGB->YCbCr tables, jcsample.c's
// h2v2 average with its alternating 1,2 bias, edge replication to whole
// MCUs (jcprepct.c), dummy blocks holding only the previous block's DC
// (jccoefct.c), the ISLOW forward DCT (jfdctint.c) and jcdctmgr.c's
// reciprocal quantization.
//
// C ABI (loaded through ctypes; every call is reentrant):
//   rjpeg_header(data, n, dims[3], err, errlen) -> 0, or -1 for a feature
//     that is not ported, -2 for a file that is not valid JPEG; dims gets
//     height, width and output channels (1 or 3)
//   rjpeg_decode(data, n, out, out_len, err, errlen) -> 0 / -1 / -2;
//     out gets height x width x channels bytes
//   rjpeg_encode(img, h, w, c, out, cap, err, errlen) -> bytes written,
//     or -2 (bad input) / -3 (cap too small)
//
// Built with g++ at first use (native/client.py ensure_built).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNotPorted = -1;
constexpr int kInvalid = -2;
// 2 x PIL's Image.MAX_IMAGE_PIXELS
constexpr int64_t kMaxPixels = 2 * 89478485LL;

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Failure{code, msg};
}

// zigzag index -> natural index, with libjpeg's 16 guard entries so a
// corrupt run length cannot index past the block
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---- Annex K tables (jcparam.c, jstdhuff.c)

constexpr uint16_t kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint16_t kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

constexpr uint8_t kBitsDcLuminance[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                          1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kValDcLuminance[12] = {0, 1, 2, 3, 4,  5,
                                         6, 7, 8, 9, 10, 11};
constexpr uint8_t kBitsDcChrominance[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                            1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kValDcChrominance[12] = {0, 1, 2, 3, 4,  5,
                                           6, 7, 8, 9, 10, 11};
constexpr uint8_t kBitsAcLuminance[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                          5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kValAcLuminance[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kBitsAcChrominance[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                            7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kValAcChrominance[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---- fixed-point constants (jidctint.c / jfdctint.c, CONST_BITS 13)

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t kFix_0_298631336 = 2446;
constexpr int64_t kFix_0_390180644 = 3196;
constexpr int64_t kFix_0_541196100 = 4433;
constexpr int64_t kFix_0_765366865 = 6270;
constexpr int64_t kFix_0_899976223 = 7373;
constexpr int64_t kFix_1_175875602 = 9633;
constexpr int64_t kFix_1_501321110 = 12299;
constexpr int64_t kFix_1_847759065 = 15137;
constexpr int64_t kFix_1_961570560 = 16069;
constexpr int64_t kFix_2_053119869 = 16819;
constexpr int64_t kFix_2_562915447 = 20995;
constexpr int64_t kFix_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdcolor.c / jccolor.c: SCALEBITS 16
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t{1} << (kScaleBits - 1);
constexpr int64_t fix16(double x) {
  return static_cast<int64_t>(x * (int64_t{1} << kScaleBits) + 0.5);
}

inline uint8_t clamp255(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---- Huffman tables

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  // decoding (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  static constexpr int kLookBits = 9;
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol; 0: none
  // encoding (jchuff.c jpeg_make_c_derived_tbl)
  uint32_t ehufco[256] = {};
  uint8_t ehufsi[256] = {};

  void set(const uint8_t* b, const uint8_t* v, bool is_dc) {
    std::memcpy(bits, b, 17);
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) fail(kInvalid, "bad Huffman table (over 256 codes)");
    std::memset(vals, 0, sizeof(vals));
    std::memcpy(vals, v, count);
    derive(count, is_dc);
    defined = true;
  }

  void derive(int count, bool is_dc) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = static_cast<uint8_t>(l);
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (uint32_t{1} << si))
        fail(kInvalid, "bad Huffman table (code lengths overflow)");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        uint32_t lookbits = huffcode[p] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (is_dc) {
      for (int i = 0; i < count; ++i)
        if (vals[i] > 15) fail(kInvalid, "bad Huffman table (DC symbol > 15)");
    }
    std::memset(ehufsi, 0, sizeof(ehufsi));
    for (int i = 0; i < count; ++i) {
      ehufco[vals[i]] = huffcode[i];
      ehufsi[vals[i]] = huffsize[i];
    }
  }
};

// ---- the entropy-coded segment reader (jdhuff.c jpeg_fill_bit_buffer)

struct BitReader {
  const uint8_t* data;
  size_t pos;
  size_t end;  // one past the segment's last byte
  uint64_t buf = 0;
  int nbits = 0;
  int marker = 0;  // the marker that stopped the reader (0: none yet)
  int64_t zero_bits = 0;  // bits supplied past the data, as zeros

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      if (marker == 0 && pos < end) {
        c = data[pos++];
        if (c == 0xFF) {
          uint32_t nxt = 0xFF;
          while (pos < end && (nxt = data[pos++]) == 0xFF) {
          }
          if (nxt == 0) {
            c = 0xFF;
          } else {
            marker = static_cast<int>(nxt);
            c = 0;
            zero_bits += 8;
          }
        }
      } else {
        zero_bits += 8;
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }
  // bits consumed beyond the data: a truncated or corrupt segment
  void check() const {
    if (zero_bits > nbits)
      fail(kInvalid, "corrupt JPEG data: the entropy-coded segment ends "
                     "early");
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    if (nbits < 16) fill();
    uint32_t e = t.look[buf >> (64 - HuffTable::kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = HuffTable::kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    fail(kInvalid, "corrupt JPEG data: bad Huffman code");
  }
  // jdhuff.c process_restart + jdmarker.c read_restart_marker
  void restart(int expected) {
    buf = 0;
    nbits = 0;
    zero_bits = 0;
    if (marker == 0) {
      while (pos < end && data[pos] != 0xFF) ++pos;
      while (pos < end && data[pos] == 0xFF) ++pos;
      marker = pos < end ? data[pos++] : 0;
    }
    if (marker != 0xD0 + expected)
      fail(kInvalid, "corrupt JPEG data: missing restart marker");
    marker = 0;
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (uint32_t{1} << (s - 1)))
             ? static_cast<int>(v) - (1 << s) + 1
             : static_cast<int>(v);
}

// ---- the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int wb = 0, hb = 0;  // blocks holding image data
  int bw = 0, bh = 0;  // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;  // downsampled width and height
  bool latched = false;
  uint16_t quant[64] = {};  // natural order, latched at the first scan
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  int dc_pred = 0;
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * bw + col) * 64;
  }
};

struct QuantTable {
  bool defined = false;
  uint16_t val[64] = {};  // natural order
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;

  int precision = 0, height = 0, width = 0;
  bool have_frame = false, progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1, mcus_per_row = 0, mcu_rows = 0;
  QuantTable qt[4];
  HuffTable dc[4], ac[4];
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail(kInvalid, "JPEG file ends inside a marker segment");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // jdmarker.c next_marker: skip garbage up to 0xFF, then any fill bytes
  int next_marker() {
    while (pos < n && data[pos] != 0xFF) ++pos;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) fail(kInvalid, "JPEG file ends before its EOI marker");
    return data[pos++];
  }

  void read_frame(int marker) {
    if (have_frame) fail(kInvalid, "JPEG file has two frame headers");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      fail(kNotPorted, "lossless JPEG (SOF" + std::to_string(marker - 0xC0) +
                           ") decoding is not ported");
    if ((marker >= 0xC5 && marker <= 0xC7) ||
        (marker >= 0xCD && marker <= 0xCF))
      fail(kNotPorted, "hierarchical (differential) JPEG (SOF" +
                           std::to_string(marker - 0xC0) +
                           ") decoding is not ported");
    if (marker >= 0xC9)
      fail(kNotPorted, "arithmetic-coded JPEG (SOF" +
                           std::to_string(marker - 0xC0) +
                           ") decoding is not ported");
    progressive = marker == 0xC2;
    size_t start = pos;
    int len = u16();
    precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (len != 8 + 3 * nc) fail(kInvalid, "bad JPEG frame header length");
    if (precision != 8)
      fail(kNotPorted, std::to_string(precision) +
                           "-bit JPEG samples are not ported (8-bit only)");
    if (height == 0)
      fail(kInvalid, "JPEG with a DNL-defined height is not supported");
    if (width == 0) fail(kInvalid, "JPEG with zero width");
    // PIL's Image.open refuses the same (DecompressionBombError)
    if (static_cast<int64_t>(width) * height > kMaxPixels)
      fail(kInvalid, "JPEG of " + std::to_string(width) + "x" +
                         std::to_string(height) +
                         " pixels is over PIL's decompression-bomb limit");
    if (nc == 4)
      fail(kNotPorted, "4-component (CMYK/YCCK) JPEG decoding is not ported");
    if (nc != 1 && nc != 3)
      fail(kInvalid, "cannot handle a " + std::to_string(nc) +
                         "-component JPEG");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kInvalid, "bad JPEG sampling factors or quant table");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    pos = start + len;
    mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
    mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.wb = static_cast<int>((static_cast<int64_t>(width) * c.h +
                               8 * max_h - 1) / (8 * max_h));
      c.hb = static_cast<int>((static_cast<int64_t>(height) * c.v +
                               8 * max_v - 1) / (8 * max_v));
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h - 1) /
                              max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v -
                               1) / max_v);
      c.bw = mcus_per_row * c.h;
      c.bh = mcu_rows * c.v;
    }
    have_frame = true;
  }

  int channels() const { return comps.size() == 1 ? 1 : 3; }

  // jdapimin.c default_decompress_parms: JFIF first, then Adobe, then ids
  bool is_rgb() const {
    if (comps.size() != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  void read_dqt() {
    size_t start = pos;
    int len = u16();
    size_t stop = start + len;
    while (pos < stop) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) fail(kInvalid, "bad JPEG quantization table");
      for (int i = 0; i < 64; ++i)
        qt[id].val[kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      qt[id].defined = true;
    }
    pos = stop;
  }

  void read_dht() {
    size_t start = pos;
    int len = u16();
    size_t stop = start + len;
    while (pos < stop) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail(kInvalid, "bad JPEG Huffman table index");
      uint8_t bits[17] = {};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        count += bits[l];
      }
      if (count > 256) fail(kInvalid, "bad Huffman table (over 256 codes)");
      uint8_t vals[256] = {};
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      (cls ? ac[id] : dc[id]).set(bits, vals, cls == 0);
    }
    pos = stop;
  }

  void read_app(int marker) {
    size_t start = pos;
    int len = u16();
    if (len < 2) fail(kInvalid, "bad JPEG marker length");
    size_t datalen = len - 2;
    const uint8_t* d = data + pos;
    if (start + len > n) fail(kInvalid, "JPEG file ends inside a marker");
    if (marker == 0xE0 && datalen >= 14 && std::memcmp(d, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && datalen >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    pos = start + len;
  }

  void skip_segment() {
    size_t start = pos;
    int len = u16();
    if (len < 2) fail(kInvalid, "bad JPEG marker length");
    pos = start + len;
  }

  // Reads markers up to the frame header (for the dimensions) or, with
  // decode, through every scan to EOI.
  void run(bool decode) {
    if (n < 3 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kInvalid, "not a JPEG file (no SOI marker)");
    pos = 2;
    // the standard tables stand in for missing ones, as jdhuff.c's
    // std_huff_tables does for motion-JPEG frames
    dc[0].set(kBitsDcLuminance, kValDcLuminance, true);
    ac[0].set(kBitsAcLuminance, kValAcLuminance, false);
    dc[1].set(kBitsDcChrominance, kValDcChrominance, true);
    ac[1].set(kBitsAcChrominance, kValAcChrominance, false);
    for (;;) {
      int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_frame(m);
        if (!decode) return;
        for (auto& c : comps)
          c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        fail(kNotPorted, "arithmetic-coded JPEG (DAC marker) decoding is "
                         "not ported");
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        int len = u16();
        if (len != 4) fail(kInvalid, "bad JPEG DRI marker");
        restart_interval = u16();
      } else if (m == 0xDE || m == 0xDF) {
        fail(kNotPorted, "hierarchical JPEG (DHP/EXP marker) decoding is "
                         "not ported");
      } else if (m == 0xDA) {
        if (!have_frame) fail(kInvalid, "JPEG scan before its frame header");
        read_scan();
      } else if (m == 0xD9) {
        if (!have_frame) fail(kInvalid, "JPEG file without a frame header");
        return;
      } else if (m == 0xD8) {
        fail(kInvalid, "JPEG file with a second SOI marker");
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker between segments carries nothing
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0x01) {
        // TEM: no parameters
      } else {
        skip_segment();
      }
    }
  }

  // the end of the entropy-coded segment that starts at pos: the next
  // marker that is not a restart marker
  size_t segment_end(size_t p) const {
    while (p < n) {
      if (data[p] != 0xFF) {
        ++p;
        continue;
      }
      size_t q = p + 1;
      while (q < n && data[q] == 0xFF) ++q;
      if (q >= n) return p;
      if (data[q] == 0 || (data[q] >= 0xD0 && data[q] <= 0xD7)) {
        p = q + 1;
        continue;
      }
      return p;
    }
    return n;
  }

  void read_scan() {
    size_t start = pos;
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
      fail(kInvalid, "bad JPEG scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail(kInvalid, "JPEG scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3)
        fail(kInvalid, "bad JPEG Huffman table index in scan");
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    pos = start + len;
    if (progressive) {
      bool bad = ss > se || se > 63 || ah > 13 || al > 13;
      if (ss == 0 ? se != 0 : ns != 1) bad = true;
      if (bad) fail(kInvalid, "bad progressive JPEG scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      // jdinput.c accepts and ignores these for sequential files
    }
    // jdinput.c latch_quant_tables: a component's table is copied at its
    // first scan
    for (Component* c : sc) {
      if (!c->latched) {
        if (!qt[c->tq].defined)
          fail(kInvalid, "JPEG component uses an undefined quant table");
        std::memcpy(c->quant, qt[c->tq].val, sizeof(c->quant));
        c->latched = true;
      }
      c->dc_pred = 0;
    }
    for (Component* c : sc) {
      bool need_dc = progressive ? (ss == 0 && ah == 0) : true;
      bool need_ac = progressive ? ss != 0 : true;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        fail(kInvalid, "JPEG scan uses an undefined Huffman table");
    }
    size_t end = segment_end(pos);
    BitReader br{data, pos, end};
    eobrun = 0;
    int mpr, rows;
    if (ns == 1) {
      mpr = sc[0]->wb;
      rows = sc[0]->hb;
    } else {
      mpr = mcus_per_row;
      rows = mcu_rows;
    }
    int64_t total = static_cast<int64_t>(mpr) * rows;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        eobrun = 0;
        for (Component* c : sc) c->dc_pred = 0;
      }
      int mrow = static_cast<int>(m / mpr), mcol = static_cast<int>(m % mpr);
      if (ns == 1) {
        decode_block(br, *sc[0], sc[0]->block(mrow, mcol), ss, se, ah, al);
      } else {
        for (Component* c : sc)
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x)
              decode_block(br, *c,
                           c->block(mrow * c->v + y, mcol * c->h + x), ss, se,
                           ah, al);
      }
      br.check();
    }
    pos = end;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                    int ah, int al) {
    if (!progressive) {  // jdhuff.c decode_mcu_slow
      int s = br.decode(dc[c.td]);
      int diff = s ? extend(br.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = static_cast<int16_t>(c.dc_pred);
      const HuffTable& t = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    // jdphuff.c
    if (ss == 0) {
      if (ah == 0) {  // decode_mcu_DC_first
        int s = br.decode(dc[c.td]);
        int diff = s ? extend(br.get(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
      } else if (br.get(1)) {  // decode_mcu_DC_refine
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const HuffTable& t = ac[c.ta];
    if (ah == 0) {  // decode_mcu_AC_first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          int val = extend(br.get(s), s);
          blk[kNatural[k]] =
              static_cast<int16_t>(static_cast<uint32_t>(val) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          --eobrun;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine
    int p1 = 1 << al;
    int m1 = -1 * (1 << al);
    int k = ss;
    auto refine = [&](int16_t* coefp) {
      if (br.get(1) && (*coefp & p1) == 0)
        *coefp = static_cast<int16_t>(*coefp + (*coefp >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          break;
        }
        do {
          int16_t* coefp = blk + kNatural[k];
          if (*coefp != 0) {
            refine(coefp);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coefp = blk + kNatural[k];
        if (*coefp != 0) refine(coefp);
      }
      --eobrun;
    }
  }

  // jidctint.c jpeg_idct_islow; the final clamp saturates, as the SIMD
  // build's packs do
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    int64_t ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int64_t dcval = static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1Bits);
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dcval;
        continue;
      }
      int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
      int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * kFix_0_541196100;
      int64_t tmp2 = z1 + z3 * -kFix_1_847759065;
      int64_t tmp3 = z1 + z2 * kFix_0_765366865;
      z2 = static_cast<int64_t>(ip[0]) * qp[0];
      z3 = static_cast<int64_t>(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
      int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
      tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
      tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
      tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * kFix_1_175875602;
      tmp0 *= kFix_0_298631336;
      tmp1 *= kFix_2_053119869;
      tmp2 *= kFix_3_072711026;
      tmp3 *= kFix_1_501321110;
      z1 *= -kFix_0_899976223;
      z2 *= -kFix_2_562915447;
      z3 *= -kFix_1_961570560;
      z4 *= -kFix_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      ws[0 * 8 + col] = descale(tmp10 + tmp3, sh);
      ws[7 * 8 + col] = descale(tmp10 - tmp3, sh);
      ws[1 * 8 + col] = descale(tmp11 + tmp2, sh);
      ws[6 * 8 + col] = descale(tmp11 - tmp2, sh);
      ws[2 * 8 + col] = descale(tmp12 + tmp1, sh);
      ws[5 * 8 + col] = descale(tmp12 - tmp1, sh);
      ws[3 * 8 + col] = descale(tmp13 + tmp0, sh);
      ws[4 * 8 + col] = descale(tmp13 - tmp0, sh);
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; ++row) {
      const int64_t* w = ws + row * 8;
      uint8_t* op = out + static_cast<size_t>(row) * stride;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * kFix_0_541196100;
      int64_t tmp2 = z1 + z3 * -kFix_1_847759065;
      int64_t tmp3 = z1 + z2 * kFix_0_765366865;
      int64_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
      int64_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * kFix_1_175875602;
      tmp0 *= kFix_0_298631336;
      tmp1 *= kFix_2_053119869;
      tmp2 *= kFix_3_072711026;
      tmp3 *= kFix_1_501321110;
      z1 *= -kFix_0_899976223;
      z2 *= -kFix_2_562915447;
      z3 *= -kFix_1_961570560;
      z4 *= -kFix_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = clamp255(descale(tmp10 + tmp3, sh) + 128);
      op[7] = clamp255(descale(tmp10 - tmp3, sh) + 128);
      op[1] = clamp255(descale(tmp11 + tmp2, sh) + 128);
      op[6] = clamp255(descale(tmp11 - tmp2, sh) + 128);
      op[2] = clamp255(descale(tmp12 + tmp1, sh) + 128);
      op[5] = clamp255(descale(tmp12 - tmp1, sh) + 128);
      op[3] = clamp255(descale(tmp13 + tmp0, sh) + 128);
      op[4] = clamp255(descale(tmp13 - tmp0, sh) + 128);
    }
  }

  // One component's samples at full size (height x width), from its
  // downsampled plane (stride = wb * 8), as jdsample.c upsamples them.
  std::vector<uint8_t> upsample(const Component& c,
                                const std::vector<uint8_t>& plane) const {
    const int stride = c.wb * 8;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto at = [&](int r, int x) -> int {
      r = std::min(std::max(r, 0), c.dh - 1);
      return plane[static_cast<size_t>(r) * stride + x];
    };
    const int hf = max_h / c.h, vf = max_v / c.v;
    if (max_h % c.h || max_v % c.v)
      fail(kNotPorted, "fractional JPEG sampling ratios are not ported");
    const bool fancy_h2 = hf == 2 && c.dw > 2;
    if (hf == 1 && vf == 1) {  // fullsize_upsample
      for (int y = 0; y < height; ++y)
        std::memcpy(&out[static_cast<size_t>(y) * width],
                    &plane[static_cast<size_t>(y) * stride], width);
    } else if (hf == 2 && vf == 1 && fancy_h2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> row(2 * static_cast<size_t>(c.dw));
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = &plane[static_cast<size_t>(y) * stride];
        for (int x = 0; x < c.dw; ++x) {
          int v3 = in[x] * 3;
          int left = in[x > 0 ? x - 1 : 0];
          int right = in[x + 1 < c.dw ? x + 1 : c.dw - 1];
          row[2 * x] = static_cast<uint8_t>((v3 + left + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((v3 + right + 2) >> 2);
        }
        std::memcpy(&out[static_cast<size_t>(y) * width], row.data(), width);
      }
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int r = y >> 1;
        int other = (y & 1) ? r + 1 : r - 1;
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          out[static_cast<size_t>(y) * width + x] = static_cast<uint8_t>(
              (at(r, x) * 3 + at(other, x) + bias) >> 2);
      }
    } else if (hf == 2 && vf == 2 && fancy_h2) {  // h2v2_fancy_upsample
      std::vector<int> colsum(c.dw);
      std::vector<uint8_t> row(2 * static_cast<size_t>(c.dw));
      for (int y = 0; y < height; ++y) {
        int r = y >> 1;
        int other = (y & 1) ? r + 1 : r - 1;
        for (int x = 0; x < c.dw; ++x) colsum[x] = at(r, x) * 3 + at(other, x);
        for (int x = 0; x < c.dw; ++x) {
          int t3 = colsum[x] * 3;
          int last = colsum[x > 0 ? x - 1 : 0];
          int next = colsum[x + 1 < c.dw ? x + 1 : c.dw - 1];
          row[2 * x] = static_cast<uint8_t>((t3 + last + 8) >> 4);
          row[2 * x + 1] = static_cast<uint8_t>((t3 + next + 7) >> 4);
        }
        std::memcpy(&out[static_cast<size_t>(y) * width], row.data(), width);
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = &plane[static_cast<size_t>(y / vf) * stride];
        for (int x = 0; x < width; ++x)
          out[static_cast<size_t>(y) * width + x] = in[x / hf];
      }
    }
    return out;
  }

  void output(uint8_t* out) {
    for (auto& c : comps)
      if (!c.latched) fail(kInvalid, "JPEG component without a scan");
    std::vector<std::vector<uint8_t>> full;
    for (auto& c : comps) {
      const int stride = c.wb * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.hb * 8);
      for (int r = 0; r < c.hb; ++r)
        for (int x = 0; x < c.wb; ++x)
          idct_islow(c.block(r, x), c.quant,
                     &plane[static_cast<size_t>(r) * 8 * stride + x * 8],
                     stride);
      full.push_back(upsample(c, plane));
    }
    const size_t npix = static_cast<size_t>(width) * height;
    if (comps.size() == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
    }
    if (is_rgb()) {
      for (size_t i = 0; i < npix; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
    }
    for (size_t i = 0; i < npix; ++i) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = clamp255(y + cr_r[cr]);
      out[3 * i + 1] =
          clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScaleBits));
      out[3 * i + 2] = clamp255(y + cb_b[cb]);
    }
  }
};

// ---- the encoder

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int nbits = 0;
  void emit_byte(uint8_t b) {
    out.push_back(b);
    if (b == 0xFF) out.push_back(0);
  }
  void put(uint32_t code, int size) {
    if (size == 0) return;
    buf = (buf << size) | (code & ((uint32_t{1} << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      emit_byte(static_cast<uint8_t>(buf >> nbits));
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with ones
    if (nbits) put(0x7F, 8 - nbits);
  }
};

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

// jfdctint.c jpeg_fdct_islow, in place on samples - 128
void fdct_islow(int32_t* d) {
  for (int row = 0; row < 8; ++row) {
    int32_t* p = d + row * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int sh = kConstBits - kPass1Bits;
    p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * kFix_0_541196100;
    p[2] = static_cast<int32_t>(descale(z1 + tmp13 * kFix_0_765366865, sh));
    p[6] = static_cast<int32_t>(descale(z1 + tmp12 * -kFix_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp4 *= kFix_0_298631336;
    tmp5 *= kFix_2_053119869;
    tmp6 *= kFix_3_072711026;
    tmp7 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 *= -kFix_1_961570560;
    z4 *= -kFix_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int32_t>(descale(tmp4 + z1 + z3, sh));
    p[5] = static_cast<int32_t>(descale(tmp5 + z2 + z4, sh));
    p[3] = static_cast<int32_t>(descale(tmp6 + z2 + z3, sh));
    p[1] = static_cast<int32_t>(descale(tmp7 + z1 + z4, sh));
  }
  for (int col = 0; col < 8; ++col) {
    int32_t* p = d + col;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int sh = kConstBits + kPass1Bits;
    p[0] = static_cast<int32_t>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int32_t>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * kFix_0_541196100;
    p[16] = static_cast<int32_t>(descale(z1 + tmp13 * kFix_0_765366865, sh));
    p[48] = static_cast<int32_t>(descale(z1 + tmp12 * -kFix_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp4 *= kFix_0_298631336;
    tmp5 *= kFix_2_053119869;
    tmp6 *= kFix_3_072711026;
    tmp7 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 *= -kFix_1_961570560;
    z4 *= -kFix_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int32_t>(descale(tmp4 + z1 + z3, sh));
    p[40] = static_cast<int32_t>(descale(tmp5 + z2 + z4, sh));
    p[24] = static_cast<int32_t>(descale(tmp6 + z2 + z3, sh));
    p[8] = static_cast<int32_t>(descale(tmp7 + z1 + z4, sh));
  }
}

// jcdctmgr.c compute_reciprocal and quantize, with 16-bit DCTELEMs
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor;
  uint64_t fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq & 0xFFFF), c & 0xFFFF, r - 16};
}

inline int quantize(int32_t x, const Divisor& d) {
  uint32_t t = static_cast<uint32_t>(x < 0 ? -x : x);
  uint32_t product = ((t + d.corr) & 0xFFFF) * d.recip;
  int q = static_cast<int>(product >> (d.shift + 16));
  return x < 0 ? -q : q;
}

struct EncComp {
  int id, h, v, tq, tbl;
  int wb, hb;   // blocks with image data
  int stride;   // padded plane width: wb * 8
  int rows;     // padded plane height: whole iMCU rows
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

void encode_block(BitWriter& bw, const int* blk, int& dc_pred,
                  const HuffTable& dct, const HuffTable& act) {
  int temp = blk[0] - dc_pred, temp2 = temp;
  dc_pred = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw.put(dct.ehufco[nbits], dct.ehufsi[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(act.ehufco[0xF0], act.ehufsi[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while (temp >>= 1) ++nbits;
    int i = (r << 4) + nbits;
    bw.put(act.ehufco[i], act.ehufsi[i]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(act.ehufco[0], act.ehufsi[0]);
}

std::vector<uint8_t> encode(const uint8_t* img, int height, int width,
                            int channels) {
  if (height < 1 || width < 1 || height > 65500 || width > 65500)
    fail(kInvalid, "JPEG dimensions must be 1..65500");
  if (channels != 1 && channels != 3)
    fail(kInvalid, "cannot write a " + std::to_string(channels) +
                       "-channel image as JPEG (greyscale or RGB only)");
  // jcparam.c jpeg_set_quality(75, force_baseline): scale factor 50
  uint16_t quant[2][64];
  for (int i = 0; i < 64; ++i) {
    const uint16_t* base[2] = {kStdLuminanceQuant, kStdChrominanceQuant};
    for (int t = 0; t < 2; ++t) {
      int64_t temp = (static_cast<int64_t>(base[t][i]) * 50 + 50) / 100;
      temp = std::min<int64_t>(std::max<int64_t>(temp, 1), 255);
      quant[t][i] = static_cast<uint16_t>(temp);
    }
  }
  HuffTable dct[2], act[2];
  dct[0].set(kBitsDcLuminance, kValDcLuminance, true);
  act[0].set(kBitsAcLuminance, kValAcLuminance, false);
  dct[1].set(kBitsDcChrominance, kValDcChrominance, true);
  act[1].set(kBitsAcChrominance, kValAcChrominance, false);

  const int max_h = channels == 3 ? 2 : 1, max_v = max_h;
  const int mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
  const int mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
  std::vector<EncComp> comps;
  if (channels == 1) {
    comps.push_back({1, 1, 1, 0, 0, 0, 0, 0, 0, {}});
  } else {
    comps.push_back({1, 2, 2, 0, 0, 0, 0, 0, 0, {}});
    comps.push_back({2, 1, 1, 1, 1, 0, 0, 0, 0, {}});
    comps.push_back({3, 1, 1, 1, 1, 0, 0, 0, 0, {}});
  }
  for (auto& c : comps) {
    c.wb = (width * c.h + 8 * max_h - 1) / (8 * max_h);
    c.hb = (height * c.v + 8 * max_v - 1) / (8 * max_v);
    c.stride = c.wb * 8;
    c.rows = mcu_rows * c.v * 8;
    c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
  }
  // colour conversion at full size, edges replicated to the padded size
  // (jcprepct.c expand_bottom_edge, jcsample.c expand_right_edge)
  const int full_w = channels == 1 ? comps[0].stride
                                   : std::max(comps[0].stride,
                                              comps[1].stride * 2);
  const int full_h = mcu_rows * max_v * 8;
  std::vector<std::vector<uint8_t>> full(
      channels, std::vector<uint8_t>(static_cast<size_t>(full_w) * full_h));
  if (channels == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(&full[0][static_cast<size_t>(y) * full_w],
                  img + static_cast<size_t>(y) * width, width);
  } else {  // jccolor.c rgb_ycc_convert
    const int64_t cbcr_offset = int64_t{128} << kScaleBits;
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = img + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        int64_t r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
        size_t o = static_cast<size_t>(y) * full_w + x;
        full[0][o] = static_cast<uint8_t>(
            (fix16(0.29900) * r + fix16(0.58700) * g + fix16(0.11400) * b +
             kOneHalf) >> kScaleBits);
        full[1][o] = static_cast<uint8_t>(
            (-fix16(0.16874) * r - fix16(0.33126) * g + fix16(0.50000) * b +
             cbcr_offset + kOneHalf - 1) >> kScaleBits);
        full[2][o] = static_cast<uint8_t>(
            (fix16(0.50000) * r - fix16(0.41869) * g - fix16(0.08131) * b +
             cbcr_offset + kOneHalf - 1) >> kScaleBits);
      }
    }
  }
  for (auto& f : full) {
    for (int y = 0; y < height; ++y) {
      uint8_t* row = &f[static_cast<size_t>(y) * full_w];
      std::fill(row + width, row + full_w, row[width - 1]);
    }
  }
  // rows: the input is padded to whole row groups (max_v rows) with its
  // last row; each component's downsampled plane is then padded to whole
  // iMCU rows with its own last row
  const int padded_h = (height + max_v - 1) / max_v * max_v;
  for (auto& f : full)
    for (int y = height; y < padded_h; ++y)
      std::memcpy(&f[static_cast<size_t>(y) * full_w],
                  &f[static_cast<size_t>(height - 1) * full_w], full_w);
  for (size_t ci = 0; ci < comps.size(); ++ci) {
    EncComp& c = comps[ci];
    const std::vector<uint8_t>& f = full[ci];
    const int real_rows = padded_h * c.v / max_v;
    if (c.h == max_h) {  // fullsize_downsample
      for (int y = 0; y < real_rows; ++y)
        std::memcpy(&c.plane[static_cast<size_t>(y) * c.stride],
                    &f[static_cast<size_t>(y) * full_w], c.stride);
    } else {  // h2v2_downsample
      for (int y = 0; y < real_rows; ++y) {
        const uint8_t* in0 = &f[static_cast<size_t>(2 * y) * full_w];
        const uint8_t* in1 = in0 + full_w;
        uint8_t* o = &c.plane[static_cast<size_t>(y) * c.stride];
        int bias = 1;
        for (int x = 0; x < c.stride; ++x) {
          o[x] = static_cast<uint8_t>((in0[2 * x] + in0[2 * x + 1] +
                                       in1[2 * x] + in1[2 * x + 1] + bias) >>
                                      2);
          bias ^= 3;
        }
      }
    }
    for (int y = real_rows; y < c.rows; ++y)
      std::memcpy(&c.plane[static_cast<size_t>(y) * c.stride],
                  &c.plane[static_cast<size_t>(real_rows - 1) * c.stride],
                  c.stride);
  }

  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(width) * height * channels / 4 + 1024);
  out.push_back(0xFF);
  out.push_back(0xD8);
  // jcmarker.c emit_jfif_app0: JFIF 1.01, no density unit, 1:1
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0,
                          1,    1,    0,    0,    1,   0,   1,   0,   0};
  out.insert(out.end(), app0, app0 + sizeof(app0));
  const int ntables = channels == 3 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {  // emit_dqt, 8-bit entries
    out.push_back(0xFF);
    out.push_back(0xDB);
    put_u16(out, 64 + 1 + 2);
    out.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) out.push_back(
        static_cast<uint8_t>(quant[t][kNatural[i]]));
  }
  out.push_back(0xFF);  // emit_sof: SOF0
  out.push_back(0xC0);
  put_u16(out, 3 * channels + 2 + 5 + 1);
  out.push_back(8);
  put_u16(out, height);
  put_u16(out, width);
  out.push_back(static_cast<uint8_t>(channels));
  for (auto& c : comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.h << 4) + c.v));
    out.push_back(static_cast<uint8_t>(c.tq));
  }
  for (int t = 0; t < ntables; ++t) {  // emit_dht: DC then AC per table
    for (int cls = 0; cls < 2; ++cls) {
      const HuffTable& ht = cls ? act[t] : dct[t];
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += ht.bits[l];
      out.push_back(0xFF);
      out.push_back(0xC4);
      put_u16(out, 2 + 1 + 16 + count);
      out.push_back(static_cast<uint8_t>(t + (cls << 4)));
      for (int l = 1; l <= 16; ++l) out.push_back(ht.bits[l]);
      out.insert(out.end(), ht.vals, ht.vals + count);
    }
  }
  out.push_back(0xFF);  // emit_sos
  out.push_back(0xDA);
  put_u16(out, 2 * channels + 2 + 1 + 3);
  out.push_back(static_cast<uint8_t>(channels));
  for (auto& c : comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.tbl << 4) + c.tbl));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  Divisor div[2][64];
  for (int t = 0; t < ntables; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(quant[t][i] << 3);
  BitWriter bw{out};
  int32_t work[64];
  int coefs[64];
  // a single-component scan is non-interleaved: one block per MCU
  const int rows_of_mcus = channels == 1 ? comps[0].hb : mcu_rows;
  const int mcus_in_row = channels == 1 ? comps[0].wb : mcus_per_row;
  for (int my = 0; my < rows_of_mcus; ++my) {
    for (int mx = 0; mx < mcus_in_row; ++mx) {
      for (auto& c : comps) {
        const int mh = channels == 1 ? 1 : c.h, mv = channels == 1 ? 1 : c.v;
        int prev_row_last_dc = 0;
        for (int y = 0; y < mv; ++y) {
          int by = my * mv + y;
          int prev_dc = 0;
          for (int x = 0; x < mh; ++x) {
            int bx = mx * mh + x;
            if (by >= c.hb) {  // a dummy row: DC only, the row above's
              std::fill(coefs, coefs + 64, 0);
              coefs[0] = prev_row_last_dc;
            } else if (bx >= c.wb) {  // a dummy column: the left block's DC
              std::fill(coefs, coefs + 64, 0);
              coefs[0] = prev_dc;
            } else {
              for (int r = 0; r < 8; ++r) {
                const uint8_t* p = &c.plane[static_cast<size_t>(by * 8 + r) *
                                                c.stride + bx * 8];
                for (int k = 0; k < 8; ++k) work[r * 8 + k] = p[k] - 128;
              }
              fdct_islow(work);
              for (int i = 0; i < 64; ++i)
                coefs[i] = quantize(work[i], div[c.tq][i]);
            }
            prev_dc = coefs[0];
            encode_block(bw, coefs, c.dc_pred, dct[c.tbl], act[c.tbl]);
          }
          prev_row_last_dc = prev_dc;
        }
      }
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t n = std::min(msg.size(), static_cast<size_t>(errlen - 1));
    std::memcpy(err, msg.data(), n);
    err[n] = 0;
  }
}

}  // namespace

extern "C" {

int32_t rjpeg_header(const uint8_t* data, int64_t n, int32_t* dims,
                     char* err, int32_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run(false);
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.channels();
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kInvalid;
  }
}

int32_t rjpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                     int64_t out_len, char* err, int32_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run(true);
    int64_t need = static_cast<int64_t>(d.height) * d.width * d.channels();
    if (out_len != need) fail(kInvalid, "output buffer of the wrong size");
    d.output(out);
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kInvalid;
  }
}

int64_t rjpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t c,
                     uint8_t* out, int64_t cap, char* err, int32_t errlen) {
  try {
    std::vector<uint8_t> bytes = encode(img, h, w, c);
    if (static_cast<int64_t>(bytes.size()) > cap) {
      set_error(err, errlen, std::to_string(bytes.size()));
      return -3;
    }
    std::memcpy(out, bytes.data(), bytes.size());
    return static_cast<int64_t>(bytes.size());
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kInvalid;
  }
}

}  // extern "C"
