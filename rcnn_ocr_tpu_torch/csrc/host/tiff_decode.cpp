// TIFF decompression in host C++: LZW (compression 5), the CCITT fax
// codings (2, 3, 4 and 32771) and the run-length rows of SGI LogL and
// LogLuv32 (34676), byte for byte what libtiff decodes.
//
// LZW, as libtiff's LZWDecode: codes of 9 to 12 bits read most significant
// bit first, Clear (256) resetting the table, EOI (257) ending the strip or
// tile, and the code width growing one code early (when the next free
// entry reaches 2^n - 1), as TIFF 6.0 specifies it.  A string longer than
// the output left is cut where the output ends, as libtiff cuts it.
// The old-style LZW of writers before TIFF 6.0, as libtiff's
// LZWDecodeCompat reads it: codes least significant bit first, the width
// growing when the next free entry reaches 2^n (not one code early), and
// a table of up to 5119 entries (CSIZE) at 12 bits.  libtiff takes the
// style from the first strip or tile it decodes (LZWPreDecode: a first
// byte of 0 and a second with bit 0 set) and keeps it for the file: the
// caller passes it.
// Errors, where libtiff fails the strip (and OpenCV's decode with it):
// return -1 with a message: a code past the table, a table entry used
// before it is defined, a first code that is not Clear, or data that ends
// (with or without EOI) before `dst_len` bytes are out.
//
// Fax, as libtiff's tif_fax3.c decodes it (Fax3DecodeRLE, Fax3Decode1D,
// Fax3Decode2D, Fax4Decode): the T.4 white and black run-length codes
// (terminating, make-up and the extended make-up codes shared by both) and
// the 2-D modes (pass, horizontal, vertical 0 / R1-3 / L1-3) over run
// arrays, a changing element b1 found on the reference line as libtiff
// finds it (CHECK_b1), the reference line starting white.  Modified
// Huffman (2) aligns each row to a byte, RLEW (32771) to a 16-bit word, as
// libtiff's bit accumulator leaves them; Group 3 (3) finds an EOL before
// every row (fill bits before it skipped), and with T4Options bit 0 reads
// the 1-D / 2-D tag bit after it; Group 4 (4) is 2-D throughout.  Decoded
// rows are 1 bits for black runs, most significant bit first, as
// _TIFFFax3fillruns writes them.
//
// libtiff's fax decoder warns on damaged data (a bad code word, a row
// whose runs do not add up to the width, data that ends before the last
// row, an uncompressed-mode extension) and fills the rest of the row; here
// they return -1 with a message.  The decoders never read past `n` bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12, kSize = 1 << kMaxBits;
constexpr int kCompatSize = kSize - 1 + 1024;  // libtiff's CSIZE

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

// Decodes the LZW strip or tile `src[0:n]` into `dst[0:dst_len]`, in the
// old style when `old_style` is 1.  Returns dst_len, or -1 (damaged) with
// a message.
extern "C" int64_t rcnn_tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                                        int64_t dst_len, int64_t old_style, char* msg,
                                        int64_t msg_len) {
  if (src == nullptr || dst == nullptr || n < 0 || dst_len < 0) return -1;
  const bool compat = old_style == 1;
  std::vector<Entry> tab(compat ? kCompatSize : kSize);
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
      if (compat) {  // GetNextCodeCompat: least significant bit first
        acc |= static_cast<uint64_t>(src[pos++]) << nacc;
      } else {
        acc = (acc << 8) | src[pos++];
      }
      nacc += 8;
    }
    nacc -= nbits;
    if (compat) {
      int code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
      return code;
    }
    return static_cast<int>((acc >> nacc) & ((1u << nbits) - 1));
  };
  auto fail = [&](const char* what) -> int64_t {
    set_message(msg, msg_len, std::string("damaged LZW data: ") + what);
    return -1;
  };
  auto clear = [&]() {
    for (size_t i = kFirst; i < tab.size(); ++i) tab[i] = Entry();
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
    if (free_ent >= static_cast<int>(tab.size())) return fail("the code table overflows");
    // the new entry: the previous string plus the first byte of this one
    // (of the previous string itself when this code is the new entry)
    Entry& e = tab[free_ent];
    e.next = old;
    e.first = tab[old].first;
    e.length = static_cast<uint16_t>(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > (1 << nbits) - (compat ? 1 : 2) && nbits < kMaxBits) ++nbits;
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

namespace {

// --- CCITT fax -------------------------------------------------------------------------

enum FaxState : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTerm, kMakeUp, kEol
};

struct FaxEntry {
  uint8_t state = kNull, width = 0;
  int32_t param = 0;
};

struct FaxCode {
  const char* bits;
  int32_t run;
};

// T.4 terminating codes, runs 0-63, in order
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
// make-up codes, runs 64, 128, ..., 1728
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
// extended make-up codes of both colours, runs 1792, 1856, ..., 2560
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

void put(std::vector<FaxEntry>& tab, int index_bits, const char* code, uint8_t state,
         int32_t param) {
  const int len = static_cast<int>(std::strlen(code));
  int prefix = 0;
  for (int i = 0; i < len; ++i) prefix = (prefix << 1) | (code[i] == '1');
  const int free_bits = index_bits - len;
  for (int rest = 0; rest < (1 << free_bits); ++rest) {
    FaxEntry& e = tab[(prefix << free_bits) | rest];
    e.state = state;
    e.width = static_cast<uint8_t>(len);
    e.param = param;
  }
}

struct FaxTables {
  std::vector<FaxEntry> white = std::vector<FaxEntry>(1 << 12);
  std::vector<FaxEntry> black = std::vector<FaxEntry>(1 << 13);
  std::vector<FaxEntry> main = std::vector<FaxEntry>(1 << 7);

  FaxTables() {
    for (int i = 0; i < 64; ++i) {
      put(white, 12, kWhiteTerm[i], kTerm, i);
      put(black, 13, kBlackTerm[i], kTerm, i);
    }
    for (int i = 0; i < 27; ++i) {
      put(white, 12, kWhiteMakeUp[i], kMakeUp, 64 * (i + 1));
      put(black, 13, kBlackMakeUp[i], kMakeUp, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      put(white, 12, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
      put(black, 13, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
    }
    // libtiff's tables take 11 zeros as EOL (the one that ends it is left)
    put(white, 12, "00000000000", kEol, 0);
    put(black, 13, "00000000000", kEol, 0);
    put(main, 7, "1", kV0, 0);
    put(main, 7, "011", kVR, 1);
    put(main, 7, "000011", kVR, 2);
    put(main, 7, "0000011", kVR, 3);
    put(main, 7, "010", kVL, 1);
    put(main, 7, "000010", kVL, 2);
    put(main, 7, "0000010", kVL, 3);
    put(main, 7, "001", kHoriz, 0);
    put(main, 7, "0001", kPass, 0);
    put(main, 7, "0000001", kExt, 0);
    put(main, 7, "0000000", kEol, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables tables;
  return tables;
}

struct FaxError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// libtiff's bit accumulator (NeedBits8 / NeedBits16 / GetBits / ClrBits),
// most significant bit first: it loads one or two bytes as libtiff loads
// them, so the bits left in it after a row (which the byte and word
// alignment of modified Huffman clear) are libtiff's.  Past the data it
// pads zeros as libtiff does; a code that takes a padded bit is damage.
struct FaxBits {
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* start;
  uint64_t acc = 0;
  int avail = 0, phantom = 0;

  bool at_end() const { return cp >= ep; }
  void load() {
    acc = (acc << 8) | *cp++;
    avail += 8;
  }
  void pad(int n) {
    acc <<= (n - avail);
    phantom += n - avail;
    avail = n;
  }
  // false at the end of the data with no bit left (libtiff's eoflab)
  bool need8(int n) {
    if (avail < n) {
      if (at_end()) {
        if (avail == 0) return false;
        pad(n);
      } else {
        load();
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (at_end()) {
        if (avail == 0) return false;
        pad(n);
      } else {
        load();
        if (avail < n) {
          if (at_end()) {
            pad(n);
          } else {
            load();
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return static_cast<uint32_t>(acc >> (avail - n)) & ((1u << n) - 1); }
  void clr(int n) {
    if (avail - n < phantom) throw FaxError("fax data ends inside a code");
    drop(n);
  }
  // ClrBits without the check: the alignment at a row's end may drop padding
  void drop(int n) {
    avail -= n;
    phantom = std::min(phantom, avail);
    acc &= avail > 0 ? (~0ull >> (64 - avail)) : 0;
  }
};

class FaxDecoder {
 public:
  FaxDecoder(const uint8_t* src, int64_t n, int64_t cols, int64_t compression, int64_t options)
      : t_(fax_tables()), lastx_(static_cast<int32_t>(cols)), compression_(compression),
        options_(options) {
    bits_.cp = bits_.start = src;
    bits_.ep = src + n;
    nruns_ = 2 * ((static_cast<int64_t>(cols) + 32) & ~31);  // TIFFroundup_32(cols + 1, 32), twice
    runs_.assign(2 * static_cast<size_t>(nruns_), 0);
    cur_ = runs_.data();
    ref_ = runs_.data() + nruns_;
    ref_[0] = lastx_;  // the reference line starts white
    ref_[1] = 0;
  }

  void decode(uint8_t* dst, int64_t rows) {
    const int64_t rowbytes = (lastx_ + 7) / 8;
    const bool g3_2d = compression_ == 3 && (options_ & 1);
    for (int64_t row = 0; row < rows; ++row) {
      a0_ = 0;
      run_length_ = 0;
      pa_ = cur_;
      if (compression_ == 3) sync_eol();
      bool two_d = compression_ == 4;
      if (g3_2d) {
        if (!bits_.need8(1)) premature();
        two_d = bits_.get(1) == 0;  // the 1-D / 2-D tag bit
        bits_.clr(1);
      }
      if (two_d) {
        pb_ = ref_;
        b1_ = *pb_++;
        expand_2d();
      } else {
        expand_1d();
      }
      if (eol_count_ && compression_ == 4) throw FaxError("Group 4 data ends (EOFB) before the last row");
      fill(dst + row * rowbytes, rowbytes);
      if (compression_ == 2 || compression_ == 32771) {
        align(compression_ == 2 ? 8 : 16);
      }
      if (pa_ < cur_ + nruns_) set_value(0);  // an imaginary change for the reference
      std::swap(cur_, ref_);
    }
  }

 private:
  [[noreturn]] void premature() const { throw FaxError("fax data ends before the last row"); }
  [[noreturn]] void unexpected(const char* table) const {
    throw FaxError(std::string("bad fax code word in the ") + table + " table");
  }
  void set_value(int32_t x) {
    if (pa_ >= cur_ + nruns_) throw FaxError("fax row has more runs than pixels");
    *pa_++ = run_length_ + x;
    a0_ += x;
    run_length_ = 0;
  }
  // CLEANUP_RUNS, where a row that does not end at the width is damage
  void cleanup() {
    if (run_length_) set_value(0);
    if (a0_ != lastx_) {
      throw FaxError("fax row of " + std::to_string(a0_) + " pixels, not " +
                     std::to_string(lastx_));
    }
  }
  const FaxEntry& lookup(const std::vector<FaxEntry>& tab, int width) {
    if (!bits_.need16(width)) premature();
    const FaxEntry& e = tab[bits_.get(width)];
    if (e.state == kNull) return e;
    bits_.clr(e.width);
    return e;
  }
  // one colour's run: make-up codes then a terminating code; false at EOL
  bool run(bool black) {
    for (;;) {
      const FaxEntry& e = black ? lookup(t_.black, 13) : lookup(t_.white, 12);
      switch (e.state) {
        case kEol:
          eol_count_ = 1;
          return false;
        case kTerm:
          set_value(e.param);
          return true;
        case kMakeUp:
          a0_ += e.param;
          run_length_ += e.param;
          break;
        default:
          unexpected(black ? "black" : "white");
      }
    }
  }
  void expand_1d() {
    for (;;) {
      if (!run(false) || a0_ >= lastx_) break;
      if (!run(true) || a0_ >= lastx_) break;
      if (pa_ - cur_ >= 2 && pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
    }
    cleanup();
  }
  void check_b1() {
    if (pa_ != cur_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) throw FaxError("fax reference line overrun");
        b1_ += pb_[0] + pb_[1];
        pb_ += 2;
      }
    }
  }
  void next_b1() {
    if (pb_ >= ref_ + nruns_) throw FaxError("fax reference line overrun");
    b1_ += *pb_++;
  }
  void expand_2d() {
    while (a0_ < lastx_) {
      if (pa_ >= cur_ + nruns_) throw FaxError("fax row has more runs than pixels");
      if (!bits_.need8(7)) premature();
      const FaxEntry& e = t_.main[bits_.get(7)];
      bits_.clr(e.width);
      switch (e.state) {
        case kPass:
          check_b1();
          next_b1();
          run_length_ += b1_ - a0_;
          a0_ = b1_;
          next_b1();
          break;
        case kHoriz: {
          const bool black_first = (pa_ - cur_) & 1;
          if (!run(black_first) || !run(!black_first)) {
            throw FaxError("EOL inside a fax horizontal-mode pair");
          }
          check_b1();
          break;
        }
        case kV0:
          check_b1();
          set_value(b1_ - a0_);
          next_b1();
          break;
        case kVR:
          check_b1();
          set_value(b1_ - a0_ + e.param);
          next_b1();
          break;
        case kVL:
          check_b1();
          if (b1_ < a0_ + e.param) unexpected("vertical-left");
          set_value(b1_ - a0_ - e.param);
          if (pb_ <= ref_) throw FaxError("fax reference line underrun");
          b1_ -= *--pb_;
          break;
        case kExt:
          throw FaxError("fax uncompressed-mode extension, which libtiff does not decode");
        default:  // kEol
          eol_count_ = 1;
          throw FaxError("EOL inside a fax row");
      }
    }
    if (run_length_) {
      if (run_length_ + a0_ < lastx_) {  // expect a final V0
        if (!bits_.need8(1)) premature();
        if (!bits_.get(1)) unexpected("main");
        bits_.clr(1);
      }
      set_value(0);
    }
    cleanup();
  }
  // SYNC_EOL: 11 zeros (unless an EOL was just read), any fill, the one
  void sync_eol() {
    if (eol_count_ == 0) {
      for (;;) {
        if (!bits_.need16(11)) premature();
        if (bits_.get(11) == 0) break;
        bits_.clr(1);
      }
    }
    for (;;) {
      if (!bits_.need8(8)) premature();
      if (bits_.get(8)) break;
      bits_.clr(8);
    }
    while (bits_.get(1) == 0) bits_.clr(1);
    bits_.clr(1);
    eol_count_ = 0;
  }
  // Fax3DecodeRLE's end of row: the bits left in the accumulator past a
  // byte (word) boundary are dropped; a word boundary also skips an odd byte
  void align(int unit) {
    bits_.drop(bits_.avail % unit);
    if (unit == 16 && bits_.avail == 0 && ((bits_.cp - bits_.start) & 1)) {
      if (bits_.at_end()) return;
      ++bits_.cp;
    }
  }
  // _TIFFFax3fillruns: black runs as 1 bits
  void fill(uint8_t* row, int64_t rowbytes) const {
    std::memset(row, 0, static_cast<size_t>(rowbytes));
    int64_t x = 0;
    for (const int32_t* r = cur_; r < pa_; r += 2) {
      x += r[0];
      const int64_t end = r + 1 < pa_ ? x + r[1] : x;
      for (; x < end && x < lastx_; ++x) row[x >> 3] |= static_cast<uint8_t>(0x80 >> (x & 7));
    }
  }

  const FaxTables& t_;
  FaxBits bits_;
  int32_t lastx_;
  int64_t compression_, options_, nruns_;
  std::vector<int32_t> runs_;
  int32_t* cur_;
  int32_t* ref_;
  int32_t* pa_ = nullptr;
  const int32_t* pb_ = nullptr;
  int32_t a0_ = 0, b1_ = 0, run_length_ = 0;
  int eol_count_ = 0;
};

}  // namespace

// Decodes `rows` rows of `cols` pixels of CCITT fax data `src[0:n]`
// (compression 2, 3, 4 or 32771; `options` the T4Options for 3) into
// `dst`, rows of (cols + 7) / 8 bytes.  Returns the bytes written, or -1
// with a message on damaged data.
extern "C" int64_t rcnn_tiff_fax_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
                                        int64_t cols, int64_t compression, int64_t options,
                                        char* msg, int64_t msg_len) {
  if (src == nullptr || dst == nullptr || n < 0 || rows < 0 || cols <= 0) return -1;
  if (compression != 2 && compression != 3 && compression != 4 && compression != 32771) {
    set_message(msg, msg_len, "not a CCITT fax compression");
    return -1;
  }
  try {
    FaxDecoder dec(src, n, cols, compression, options);
    dec.decode(dst, rows);
    return rows * ((cols + 7) / 8);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, std::string("damaged fax data: ") + e.what());
    return -1;
  }
}

// SGI's run-length rows (compression 34676), as libtiff's LogL16Decode and
// LogLuvDecode32 read them a row at a time: the row's `cols` values as
// byte planes, most significant first (2 for LogL's 16-bit values, 4 for
// LogLuv's 32-bit ones), each a run-length code (a byte of 128 or more
// repeats the next byte that less 126 times, a smaller one copies that many
// bytes; 0 copies none).  Decodes `rows` rows of `src[0:n]` into `dst`
// (rows * cols values).  Returns the values written, or -1 with a message
// where libtiff fails the row ("Not enough data").
template <typename T>
int64_t sgilog_rows(const uint8_t* src, int64_t n, T* dst, int64_t rows, int64_t cols,
                    char* msg, int64_t msg_len) {
  if (src == nullptr || dst == nullptr || n < 0 || rows < 0 || cols < 0) return -1;
  const uint8_t* bp = src;
  int64_t cc = n;
  for (int64_t r = 0; r < rows; ++r) {
    T* tp = dst + r * cols;
    std::fill(tp, tp + cols, T(0));
    for (int shft = 8 * (static_cast<int>(sizeof(T)) - 1); shft >= 0; shft -= 8) {
      int64_t i = 0;
      while (i < cols && cc > 0) {
        if (*bp >= 128) {  // a run
          if (cc < 2) break;
          int rc = *bp++ + (2 - 128);
          T b = static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
          cc -= 2;
          while (rc-- && i < cols) tp[i++] |= b;
        } else {  // literal bytes
          int rc = *bp++;
          while (--cc && rc-- && i < cols) {
            tp[i++] |= static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
          }
        }
      }
      if (i != cols) {
        set_message(msg, msg_len, "SGI log data ends " + std::to_string(cols - i) +
                                      " pixels short of row " + std::to_string(r));
        return -1;
      }
    }
  }
  return rows * cols;
}

// SGI LogL (PhotometricInterpretation LogL): 16-bit values.
extern "C" int64_t rcnn_tiff_sgilog16_decode(const uint8_t* src, int64_t n, int16_t* dst,
                                             int64_t rows, int64_t cols, char* msg,
                                             int64_t msg_len) {
  return sgilog_rows<int16_t>(src, n, dst, rows, cols, msg, msg_len);
}

// SGI LogLuv32 (PhotometricInterpretation LogLuv): 32-bit values.
extern "C" int64_t rcnn_tiff_sgilog32_decode(const uint8_t* src, int64_t n, uint32_t* dst,
                                             int64_t rows, int64_t cols, char* msg,
                                             int64_t msg_len) {
  return sgilog_rows<uint32_t>(src, n, dst, rows, cols, msg, msg_len);
}
