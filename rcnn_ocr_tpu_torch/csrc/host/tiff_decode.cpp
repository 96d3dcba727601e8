// TIFF LZW decoding (compression 5), byte for byte what libtiff's LZWDecode
// gives: codes of 9 to 12 bits read most significant bit first, Clear (256)
// resetting the table, EOI (257) ending the strip or tile, and the code
// width growing one code early (when the next free entry reaches 2^n - 1),
// as TIFF 6.0 specifies it.  A string longer
// than the output left is cut where the output ends, as libtiff cuts it.
//
// Errors, where libtiff fails the strip (and OpenCV's decode with it):
// return -1 with a message: a code past the table, a table entry used
// before it is defined, a first code that is not Clear, or data that ends
// (with or without EOI) before `dst_len` bytes are out.  The old-style LZW
// of writers before TIFF 6.0 (least significant bit first), which libtiff
// also reads, returns -2.  The decoder never reads past `n` bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12, kSize = 1 << kMaxBits;

void set_message(char* msg, int64_t msg_len, const std::string& text) {
  if (msg != nullptr && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", text.c_str());
  }
}

struct Entry {
  int32_t next = -1;   // the prefix's entry, -1 for a single byte
  uint16_t length = 0;  // 0: not defined
  uint8_t value = 0, first = 0;
};

}  // namespace

// Decodes the LZW strip or tile `src[0:n]` into `dst[0:dst_len]`.  Returns
// dst_len, or -1 (damaged) / -2 (old-style LZW) with a message.
extern "C" int64_t rcnn_tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                                        int64_t dst_len, char* msg, int64_t msg_len) {
  if (src == nullptr || dst == nullptr || n < 0 || dst_len < 0) return -1;
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) {
    set_message(msg, msg_len, "old-style (pre-TIFF 6.0) LZW");
    return -2;
  }
  std::vector<Entry> tab(kSize);
  for (int i = 0; i < 256; ++i) {
    tab[i].length = 1;
    tab[i].value = tab[i].first = static_cast<uint8_t>(i);
  }
  int64_t pos = 0, out = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, free_ent = kFirst, old = -1;
  auto next_code = [&]() -> int {
    while (nacc < nbits) {
      if (pos >= n) return kEoi;  // libtiff: "not terminated with EOI code"
      acc = (acc << 8) | src[pos++];
      nacc += 8;
    }
    nacc -= nbits;
    return static_cast<int>((acc >> nacc) & ((1u << nbits) - 1));
  };
  auto fail = [&](const char* what) -> int64_t {
    set_message(msg, msg_len, std::string("damaged LZW data: ") + what);
    return -1;
  };
  auto clear = [&]() {
    for (int i = kFirst; i < kSize; ++i) tab[i] = Entry();
    free_ent = kFirst;
    nbits = 9;
  };
  while (out < dst_len) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        clear();
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return fail("a code after Clear that is not a byte");
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0) return fail("the first code is not Clear");
    if (free_ent >= kSize) return fail("the code table overflows");
    // the new entry: the previous string plus the first byte of this one
    // (of the previous string itself when this code is the new entry)
    Entry& e = tab[free_ent];
    e.next = old;
    e.first = tab[old].first;
    e.length = static_cast<uint16_t>(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > (1 << nbits) - 2 && nbits < kMaxBits) ++nbits;
    old = code;
    const Entry& c = tab[code];
    if (c.length == 0) return fail("a code used before it is defined");
    // the string is written back to front; past the output it is cut
    int64_t len = c.length, keep = std::min<int64_t>(len, dst_len - out);
    int cur = code;
    for (int64_t i = len - 1; i >= 0; --i) {
      if (i < keep) dst[out + i] = tab[cur].value;
      cur = tab[cur].next;
    }
    out += keep;
  }
  if (out < dst_len) {
    set_message(msg, msg_len, "LZW data ends " + std::to_string(dst_len - out) +
                                  " bytes short of the strip or tile");
    return -1;
  }
  return out;
}
