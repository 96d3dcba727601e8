// Baseline and extended-sequential JPEG decoding to RGB uint8, pixel for
// pixel what libjpeg-turbo's default decompression gives (the decoder behind
// `cv2.imdecode(buf, IMREAD_COLOR)`), EXIF orientation applied as OpenCV
// applies it.
//
// The steps follow libjpeg-turbo's default path:
// * markers: SOI, APPn (APP0 JFIF, APP1 EXIF, APP14 Adobe), DQT (8- and
//   16-bit tables), DHT, SOF0/SOF1 (8-bit Huffman, sequential), DRI, SOS
//   (interleaved or single-component scans, one or more), RSTn, EOI;
// * entropy decoding (jdhuff.c): DC prediction per component, reset at each
//   restart marker; a segment that ends at a marker before its bits are in
//   is zero-filled and its later MCUs left zero, as libjpeg-turbo does
//   (JWRN_HIT_MARKER); data that ends with no marker is truncated;
// * dequantization and the ISLOW integer IDCT (jidctint.c: CONST_BITS 13,
//   PASS1_BITS 2) in the 16-bit lanes of libjpeg-turbo's x86 SIMD version,
//   clamped to 0..255 with its saturating packs (the C table differs from a
//   clamp only beyond +-512);
// * chroma upsampling (jdsample.c, "fancy", libjpeg's default): h2v1 and
//   h2v2 triangle filters with their alternating biases, h1v2, and plain
//   replication for other integral factors or planes two columns wide;
//   edges replicate the plane's last real row and column;
// * colour (jdcolor.c): YCbCr -> RGB with the fixed-point tables
//   (SCALEBITS 16); gray is replicated to three channels; 3-component
//   images without a JFIF marker follow the Adobe transform flag or the
//   'R','G','B' component ids, as libjpeg's default_decompress_parms.
//
// Damaged entropy data decodes as libjpeg-turbo decodes it (its warnings,
// which OpenCV only prints): a bad Huffman code gives a zero symbol, a
// restart marker out of sequence is resynchronized as
// jdmarker.c:jpeg_resync_to_restart does, and a scan that names a Huffman
// table no DHT defined uses the standard tables (jstdhuff.c).
//
// Refused (return -2): progressive, lossless, hierarchical and arithmetic-
// coded frames, precisions other than 8 bits, and 2- or 4-component images
// (CMYK / YCCK).  Damaged headers and truncated data (where OpenCV's decode
// fails) return -1.  Both write a message.  The decoder never reads past `n`
// bytes.
//
// Two calls: rcnn_jpeg_header for the output height and width, then
// rcnn_jpeg_decode_u8 into a caller-owned [h, w, 3] buffer.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  int code;  // -1 damaged or truncated, -2 unsupported
  std::string msg;
};

[[noreturn]] void damaged(const std::string& msg) { throw JpegError{-1, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw JpegError{-2, msg}; }

// jpeg_natural_order plus 16 entries of 63: a corrupt run length that
// overshoots k lands on coefficient 63, as in libjpeg.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c: the example tables of the JPEG standard (K.3), which
// libjpeg-turbo loads into slots 0 and 1 when a scan names a table that no
// DHT defined (Motion-JPEG frames carry none).  bits[l - 1] codes of length l.
const uint8_t kStdDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                   {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcVals[2][162] = {
    {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
    0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42,
    0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a,
    0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35,
    0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67,
    0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84,
    0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa
    },
    {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
    0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1,
    0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24,
    0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a,
    0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82,
    0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa,
    0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa
    }};

constexpr int kLookahead = 8;
constexpr int kMinGetBits = 57;  // libjpeg-turbo's MIN_GET_BITS, 64-bit buffer

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // lookahead: (code length << 8) | symbol, or 0 when the code is longer
  uint16_t look[1 << kLookahead] = {};

  // jdhuff.c:jpeg_make_d_derived_tbl
  void build(const uint8_t* bits, const uint8_t* values, int count, bool dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        ++code;
      }
      if (code >= (1 << si)) damaged("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, values, count);
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookahead; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        int lookbits = huffcode[p] << (kLookahead - l);
        for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr) {
          look[lookbits++] = static_cast<uint16_t>((l << 8) | values[p]);
        }
      }
    }
    if (dc) {
      for (int i = 0; i < count; ++i) {
        if (values[i] > 15) damaged("bad Huffman table (DC symbol above 15)");
      }
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled width and height (real samples)
  int wib = 0, hib = 0;  // width and height in blocks
  int bw = 0, bh = 0;    // the block grid padded to whole MCUs
  int dc_tbl = 0, ac_tbl = 0;
  bool coded = false;
  uint16_t quant[64] = {};  // latched at the component's first scan
  std::vector<int16_t> coef;
};

// jdcolor.c:build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

const YccTables& ycc() {
  static const YccTables tables;
  return tables;
}

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x)); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  // Parses up to the first SOS (what jpeg_read_header reads); returns the
  // output height and width after the EXIF orientation.
  void header(int64_t* out_h, int64_t* out_w) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) damaged("not a JPEG stream (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!sof_) damaged("SOS before SOF");
        scan_start_ = pos_ - 2;
        break;
      }
      if (m == 0xD9) damaged("EOI before any scan");
      segment(m);
    }
    bool swap = orientation_ >= 5 && orientation_ <= 8;
    *out_h = swap ? width_ : height_;
    *out_w = swap ? height_ : width_;
  }

  void decode(uint8_t* out) {
    pos_ = scan_start_;
    bool eoi = false;
    while (!eoi) {
      int m = next_marker();
      if (m == 0xD9) {
        eoi = true;
      } else if (m == 0xDA) {
        scan();
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker between segments: libjpeg ignores it
      } else {
        segment(m);
      }
      if (!eoi && pos_ >= n_) {
        if (!scanned_) damaged("truncated JPEG data (no scan)");
        break;  // every scan decoded but no EOI: libjpeg accepts that
      }
    }
    for (int c = 0; c < ncomp_; ++c) {
      if (!comp_[c].coded) damaged("component never coded by a scan");
    }
    render(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0, scan_start_ = 0;

  bool sof_ = false, scanned_ = false;
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  Component comp_[4];
  uint16_t qt_[4][64] = {};
  bool qt_def_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false, app1_seen_ = false;
  int adobe_transform_ = 0, orientation_ = 1;

  // entropy state
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool marker_hit_ = false, insufficient_ = false;

  int u8() {
    if (pos_ >= n_) damaged("truncated JPEG header");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c:next_marker: skip garbage up to 0xFF, then fill 0xFFs
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // one marker segment of the header (not SOS, EOI or RSTn)
  void segment(int m) {
    if (m == 0xD8) damaged("second SOI marker");
    if (m == 0x01) return;  // TEM: no length
    int len = u16();
    if (len < 2) damaged("bad marker segment length");
    size_t start = pos_, end = pos_ + static_cast<size_t>(len - 2);
    if (end > n_) damaged("truncated JPEG header");
    switch (m) {
      case 0xC0:
      case 0xC1:
        sof(end);
        break;
      case 0xC2:
        unsupported("progressive JPEG (SOF2)");
      case 0xC3:
        unsupported("lossless JPEG (SOF3)");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xCC:
        unsupported("arithmetic-coded JPEG (DAC)");
      case 0xC4:
        dht(end);
        break;
      case 0xDB:
        dqt(end);
        break;
      case 0xDD:
        if (len != 4) damaged("bad DRI segment");
        restart_interval_ = u16();
        break;
      case 0xDC:
        unsupported("JPEG with a DNL marker");
      case 0xE0:
        if (len >= 16 && std::memcmp(d_ + start, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xE1:
        // OpenCV reads the orientation from the first APP1 segment only
        if (!app1_seen_) {
          app1_seen_ = true;
          orientation_ = exif_orientation(d_ + start, end - start);
        }
        break;
      case 0xEE:
        if (len >= 14 && std::memcmp(d_ + start, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[start + 11];
        }
        break;
      default:
        break;  // COM and other APPn
    }
    pos_ = end;
  }

  void sof(size_t end) {
    if (sof_) damaged("second SOF marker");
    int precision = u8();
    height_ = u16();
    width_ = u16();
    ncomp_ = u8();
    if (precision != 8) unsupported(std::to_string(precision) + "-bit JPEG");
    if (height_ == 0) unsupported("JPEG with its height in a DNL marker");
    if (width_ == 0) damaged("JPEG of width 0");
    if (ncomp_ == 4) unsupported("4-component JPEG (CMYK / YCCK)");
    if (ncomp_ != 1 && ncomp_ != 3) {
      unsupported(std::to_string(ncomp_) + "-component JPEG");
    }
    if (static_cast<int64_t>(width_) * height_ > (int64_t(1) << 30)) {
      damaged("JPEG larger than 2^30 pixels");
    }
    if (pos_ + 3 * static_cast<size_t>(ncomp_) > end) damaged("bad SOF segment");
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = u8();
      int hv = u8();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = u8();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) damaged("bad SOF component");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      if (hmax_ % k.h || vmax_ % k.v) {
        unsupported("JPEG with fractional chroma subsampling");
      }
      k.dw = static_cast<int>((static_cast<int64_t>(width_) * k.h + hmax_ - 1) / hmax_);
      k.dh = static_cast<int>((static_cast<int64_t>(height_) * k.v + vmax_ - 1) / vmax_);
      k.wib = (k.dw + 7) / 8;
      k.hib = (k.dh + 7) / 8;
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
    }
    sof_ = true;
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) damaged("bad DHT table id");
      uint8_t bits[16];
      int count = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = static_cast<uint8_t>(u8());
        count += bits[i];
      }
      if (count > 256 || pos_ + count > end) damaged("bad DHT segment");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      (tc ? ac_[th] : dc_[th]).build(bits, vals, count, tc == 0);
    }
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) damaged("bad DQT table id");
      for (int i = 0; i < 64; ++i) {
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      }
      qt_def_[tq] = true;
    }
    if (pos_ != end) damaged("bad DQT segment length");
  }

  static int exif_orientation(const uint8_t* p, size_t n) {
    // OpenCV skips the 6 bytes of "Exif\0\0" and parses a TIFF header
    if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return 1;
    const uint8_t* t = p + 6;
    size_t tn = n - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') {
      le = true;
    } else if (t[0] == 'M' && t[1] == 'M') {
      le = false;
    } else {
      return 1;
    }
    auto rd16 = [&](size_t o) -> uint32_t {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (rd16(o) | (rd16(o + 2) << 16)) : ((rd16(o) << 16) | rd16(o + 2));
    };
    size_t ifd = rd32(4);
    if (ifd + 2 > tn) return 1;
    uint32_t entries = rd16(ifd);
    for (uint32_t i = 0; i < entries; ++i) {
      size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > tn) return 1;
      if (rd16(e) == 0x0112) {
        uint32_t v = rd16(e + 8);
        return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
      }
    }
    return 1;
  }

  // --- entropy decoding -------------------------------------------------

  // jdhuff.c:jpeg_fill_bit_buffer.  Reads whole bytes until kMinGetBits are
  // buffered or a marker is reached; past a marker, zeros are supplied when
  // `need` bits are not there (and the rest of the segment is skipped).
  void fill(int need) {
    while (bits_ < kMinGetBits) {
      if (marker_hit_) break;
      if (pos_ >= n_) damaged("truncated JPEG data");
      int c = d_[pos_];
      if (c == 0xFF) {
        size_t q = pos_ + 1;
        while (q < n_ && d_[q] == 0xFF) ++q;
        if (q >= n_) damaged("truncated JPEG data");
        if (d_[q] != 0) {  // a marker: leave pos_ on its last 0xFF
          marker_hit_ = true;
          pos_ = q - 1;
          break;
        }
        pos_ = q + 1;  // 0xFF00: a stuffed 0xFF data byte
      } else {
        ++pos_;
      }
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
      bits_ += 8;
    }
    if (marker_hit_ && need > bits_) {
      insufficient_ = true;
      buf_ <<= (kMinGetBits - bits_);
      bits_ = kMinGetBits;
    }
  }

  int get_bits(int s) {
    if (bits_ < s) fill(s);
    bits_ -= s;
    return static_cast<int>((buf_ >> bits_) & ((uint64_t(1) << s) - 1));
  }

  int huff(const Huffman& t) {
    if (bits_ < kLookahead) fill(0);
    if (bits_ >= kLookahead) {
      int look = static_cast<int>((buf_ >> (bits_ - kLookahead)) & ((1 << kLookahead) - 1));
      int e = t.look[look];
      if (e) {
        bits_ -= e >> 8;
        return e & 0xFF;
      }
    }
    // jdhuff.c:jpeg_huff_decode, one bit at a time
    int l = 1;
    int32_t code = get_bits(1);
    while (code > t.maxcode[l]) {  // maxcode[17] stops the loop
      code = (code << 1) | get_bits(1);
      ++l;
    }
    // no code matches: libjpeg warns (JWRN_HUFF_BAD_CODE), drops the 17 bits
    // and decodes a zero symbol, "the safest result"
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

  void block(int16_t* blk, const Huffman& dct, const Huffman& act, int& pred) {
    int s = huff(dct);
    if (s) s = extend(get_bits(s), s);
    // libjpeg-turbo adds in unsigned arithmetic (a wrap, not an error)
    pred = static_cast<int>(static_cast<uint32_t>(pred) + static_cast<uint32_t>(s));
    blk[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = huff(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) damaged("bad SOS segment");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tbl = u8();
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c) {
        if (comp_[c].id == id) k = &comp_[c];
      }
      if (k == nullptr) damaged("SOS names an unknown component");
      for (int j = 0; j < i; ++j) {
        if (sc[j] == k) damaged("SOS names a component twice");
      }
      k->dc_tbl = tbl >> 4;
      k->ac_tbl = tbl & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3) damaged("bad SOS table ids");
      // jdhuff.c:jpeg_make_d_derived_tbl falls back on jstdhuff.c's tables
      for (int ac = 0; ac < 2; ++ac) {
        int th = ac ? k->ac_tbl : k->dc_tbl;
        Huffman& t = ac ? ac_[th] : dc_[th];
        if (t.defined) continue;
        if (th > 1) damaged("scan uses an undefined Huffman table");
        if (ac) {
          t.build(kStdAcBits[th], kStdAcVals[th], 162, false);
        } else {
          t.build(kStdDcBits[th], kStdDcVals, 12, true);
        }
      }
      if (!k->coded) {
        if (!qt_def_[k->tq]) damaged("component uses an undefined quantization table");
        std::memcpy(k->quant, qt_[k->tq], sizeof(k->quant));
        k->coef.assign(static_cast<size_t>(k->bw) * k->bh * 64, 0);
        k->coded = true;
      }
      sc[i] = k;
    }
    pos_ += 3;  // Ss, Se, Ah/Al: a sequential scan codes all 64 coefficients
    if (pos_ > n_) damaged("truncated JPEG header");

    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks > 10) damaged("too many blocks in an MCU");
    int64_t mcus_x = ns == 1 ? sc[0]->wib : mcux_;
    int64_t mcus_y = ns == 1 ? sc[0]->hib : mcuy_;
    int64_t total = mcus_x * mcus_y;

    buf_ = 0;
    bits_ = 0;
    marker_hit_ = insufficient_ = false;
    int pred[4] = {0, 0, 0, 0};
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && m && m % restart_interval_ == 0) restart(next_rst, pred);
      if (insufficient_) continue;  // the rest of this segment stays zero
      int64_t mx = m % mcus_x, my = m / mcus_x;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
        for (int y = 0; y < bh; ++y) {
          for (int x = 0; x < bwid; ++x) {
            int64_t by = my * bh + y, bx = mx * bwid + x;
            int16_t* blk = &k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64];
            block(blk, dc_[k.dc_tbl], ac_[k.ac_tbl], pred[i]);
          }
        }
      }
    }
    // jdhuff.c:finish_pass discards the buffered bits; the marker reader
    // then skips to the next marker
    if (!marker_hit_) {
      while (pos_ < n_ && !(d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0 &&
                            d_[pos_ + 1] != 0xFF)) {
        ++pos_;
      }
    }
    scanned_ = true;
  }

  // jdhuff.c:process_restart with jdmarker.c:read_restart_marker: the
  // buffered bits are dropped and the next marker read (skipping any
  // garbage before it); a marker other than the expected RSTn is handled as
  // jpeg_resync_to_restart does: skipped (an earlier RSTn or a non-marker
  // code), left unread so the segment decodes as empty (a later RSTn or
  // another marker), or taken as the expected one (an RSTn further off).
  void restart(int& next_rst, int* pred) {
    buf_ = 0;
    bits_ = 0;
    int m = next_marker();
    marker_hit_ = false;
    while (m != 0xD0 + next_rst) {
      bool rst = m >= 0xD0 && m <= 0xD7;
      int ahead = (m - 0xD0 - next_rst) & 7;
      if (m < 0xC0 || (rst && ahead >= 6)) {
        m = next_marker();
      } else if (!rst || ahead <= 2) {
        pos_ -= 2;  // back on the marker's last 0xFF, unread
        marker_hit_ = true;
        break;
      } else {
        break;
      }
    }
    next_rst = (next_rst + 1) & 7;
    pred[0] = pred[1] = pred[2] = pred[3] = 0;
    if (!marker_hit_) insufficient_ = false;
  }

  // --- reconstruction ---------------------------------------------------

  // jidctint.c:jpeg_idct_islow for one block into `out` (row stride
  // `stride`), computed as libjpeg-turbo's x86 SIMD versions compute it
  // (jidctint-sse2.asm, jidctint-avx2.asm): the dequantized coefficients,
  // the sums that feed a shift or a shared multiply, and the workspace
  // between the passes are 16-bit lanes (a wrap, a wrap, a saturation),
  // products and the rest 32-bit, and the output saturates to 0..255.  On
  // valid data that is the C routine's result; where damaged data's
  // coefficients overflow 16 bits it is libjpeg-turbo's there too.
  static void idct(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto w16 = [](int32_t x) { return static_cast<int32_t>(static_cast<int16_t>(x)); };
    auto s16 = [](int32_t x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); };
    // one 1-D pass over v[0], v[step], ..., v[7 * step]; results descaled by `sh`
    auto pass = [&](const int32_t* v, int step, int sh, int32_t* r) {
      int32_t z2 = v[2 * step], z3 = v[6 * step];
      int32_t tmp2 = z2 * F0541 + z3 * (F0541 - F1847);
      int32_t tmp3 = z2 * (F0541 + F0765) + z3 * F0541;
      int32_t tmp0 = w16(v[0] + v[4 * step]) * (1 << 13);
      int32_t tmp1 = w16(v[0] - v[4 * step]) * (1 << 13);
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int32_t t0 = v[7 * step], t1 = v[5 * step], t2 = v[3 * step], t3 = v[step];
      z3 = w16(t0 + t2);
      int32_t z4 = w16(t1 + t3);
      int32_t z3o = z3 * (F1175 - F1961) + z4 * F1175;
      int32_t z4o = z3 * F1175 + z4 * (F1175 - F0390);
      int32_t o0 = t0 * (F0298 - F0899) + t3 * -F0899 + z3o;
      int32_t o3 = t0 * -F0899 + t3 * (F1501 - F0899) + z4o;
      int32_t o1 = t1 * (F2053 - F2562) + t2 * -F2562 + z4o;
      int32_t o2 = t1 * -F2562 + t2 * (F3072 - F2562) + z3o;
      const int32_t round = 1 << (sh - 1);
      r[0] = s16((tmp10 + o3 + round) >> sh);
      r[7] = s16((tmp10 - o3 + round) >> sh);
      r[1] = s16((tmp11 + o2 + round) >> sh);
      r[6] = s16((tmp11 - o2 + round) >> sh);
      r[2] = s16((tmp12 + o1 + round) >> sh);
      r[5] = s16((tmp12 - o1 + round) >> sh);
      r[3] = s16((tmp13 + o0 + round) >> sh);
      r[4] = s16((tmp13 - o0 + round) >> sh);
    };
    int32_t dq[64], ws[64], r[8];
    bool ac_zero = true;  // rows 1-7 of the whole block (the SIMD shortcut's test)
    for (int i = 0; i < 64; ++i) {
      dq[i] = static_cast<int16_t>(static_cast<uint16_t>(in[i]) * static_cast<uint32_t>(q[i]));
      if (i >= 8 && in[i]) ac_zero = false;
    }
    for (int c = 0; c < 8; ++c) {  // pass 1: columns, PASS1_BITS 2
      if (ac_zero) {
        for (int k = 0; k < 8; ++k) ws[8 * k + c] = w16(dq[c] * 4);
        continue;
      }
      pass(dq + c, 8, 11, r);
      for (int k = 0; k < 8; ++k) ws[8 * k + c] = r[k];
    }
    for (int k = 0; k < 8; ++k) {  // pass 2: rows
      pass(ws + 8 * k, 1, 18, r);
      uint8_t* op = out + static_cast<size_t>(k) * stride;
      for (int c = 0; c < 8; ++c) op[c] = static_cast<uint8_t>(std::clamp(r[c], -128, 127) + 128);
    }
  }

  // A component's samples, [hib * 8, wib * 8] (the real dh x dw in the corner)
  std::vector<uint8_t> plane(const Component& k) const {
    int stride = k.wib * 8;
    std::vector<uint8_t> p(static_cast<size_t>(k.hib) * 8 * stride);
    for (int by = 0; by < k.hib; ++by) {
      for (int bx = 0; bx < k.wib; ++bx) {
        idct(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64], k.quant,
             &p[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
    }
    return p;
  }

  // A component upsampled to width_ x height_ (jdsample.c), contiguous.
  std::vector<uint8_t> upsample(const Component& k) const {
    std::vector<uint8_t> src = plane(k);
    const int stride = k.wib * 8, W = width_, H = height_, dw = k.dw, dh = k.dh;
    const int hr = hmax_ / k.h, vr = vmax_ / k.v;
    auto at = [&](int y, int x) -> int { return src[static_cast<size_t>(y) * stride + x]; };
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[static_cast<size_t>(y) * W], &src[static_cast<size_t>(y) * stride], W);
      return out;
    }
    const bool h2v1 = hr == 2 && vr == 1 && dw > 2;
    const bool h1v2 = hr == 1 && vr == 2;
    const bool h2v2 = hr == 2 && vr == 2 && dw > 2;
    std::vector<int> colsum(dw);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      if (h2v1) {
        int r = y;
        for (int x = 0; x < W; ++x) {
          int j = x >> 1;
          int near = at(r, j) * 3;
          if (x & 1) {
            o[x] = static_cast<uint8_t>((near + at(r, j + 1 < dw ? j + 1 : dw - 1) + 2) >> 2);
          } else {
            o[x] = static_cast<uint8_t>((near + at(r, j > 0 ? j - 1 : 0) + 1) >> 2);
          }
        }
      } else if (h1v2 || h2v2) {
        int r = y >> 1;
        int far = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
        for (int j = 0; j < dw; ++j) colsum[j] = at(r, j) * 3 + at(far, j);
        if (h1v2) {
          int bias = (y & 1) ? 2 : 1;
          for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((colsum[x] + bias) >> 2);
        } else {
          for (int x = 0; x < W; ++x) {
            int j = x >> 1;
            if (x & 1) {
              o[x] = static_cast<uint8_t>((colsum[j] * 3 + colsum[j + 1 < dw ? j + 1 : dw - 1] + 7) >> 4);
            } else {
              o[x] = static_cast<uint8_t>((colsum[j] * 3 + colsum[j > 0 ? j - 1 : 0] + 8) >> 4);
            }
          }
        }
      } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
        int r = y / vr;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(r, x / hr));
      }
    }
    return out;
  }

  void render(uint8_t* out) const {
    const int W = width_, H = height_;
    const size_t npix = static_cast<size_t>(W) * H;
    std::vector<uint8_t> rgb(npix * 3);
    if (ncomp_ == 1) {
      std::vector<uint8_t> g = upsample(comp_[0]);
      for (size_t i = 0; i < npix; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
    } else {
      std::vector<uint8_t> c0 = upsample(comp_[0]), c1 = upsample(comp_[1]),
                           c2 = upsample(comp_[2]);
      bool is_rgb;
      if (jfif_) {
        is_rgb = false;
      } else if (adobe_) {
        is_rgb = adobe_transform_ == 0;
      } else {
        is_rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
      }
      if (is_rgb) {
        for (size_t i = 0; i < npix; ++i) {
          rgb[3 * i] = c0[i];
          rgb[3 * i + 1] = c1[i];
          rgb[3 * i + 2] = c2[i];
        }
      } else {
        const YccTables& t = ycc();
        for (size_t i = 0; i < npix; ++i) {
          int y = c0[i], cb = c1[i], cr = c2[i];
          rgb[3 * i] = clamp255(y + t.cr_r[cr]);
          rgb[3 * i + 1] = clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          rgb[3 * i + 2] = clamp255(y + t.cb_b[cb]);
        }
      }
    }
    // OpenCV's ApplyExifOrientation: 2 flips columns, 3 both, 4 rows;
    // 5-8 transpose first, then flip as 1-4 do
    const int o = orientation_;
    const bool transpose = o >= 5;
    const int oh = transpose ? W : H, ow = transpose ? H : W;
    const bool flip_c = o == 2 || o == 3 || o == 6 || o == 7;
    const bool flip_r = o == 3 || o == 4 || o == 7 || o == 8;
    for (int y = 0; y < oh; ++y) {
      int ty = flip_r ? oh - 1 - y : y;
      for (int x = 0; x < ow; ++x) {
        int tx = flip_c ? ow - 1 - x : x;
        int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
        const uint8_t* s = &rgb[(static_cast<size_t>(sy) * W + sx) * 3];
        uint8_t* dst = out + (static_cast<size_t>(y) * ow + x) * 3;
        dst[0] = s[0];
        dst[1] = s[1];
        dst[2] = s[2];
      }
    }
  }
};

void set_message(char* msg, int64_t msg_len, const std::string& text) {
  if (msg != nullptr && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", text.c_str());
  }
}

}  // namespace

// Output size of a JPEG stream: out_hw = {height, width} after the EXIF
// orientation.  Returns 0, -1 (damaged) or -2 (unsupported; msg names it).
extern "C" int64_t rcnn_jpeg_header(const uint8_t* data, int64_t n, int64_t* out_hw, char* msg,
                                    int64_t msg_len) {
  if (data == nullptr || n < 0 || out_hw == nullptr) return -1;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.header(&out_hw[0], &out_hw[1]);
    return 0;
  } catch (const JpegError& e) {
    set_message(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return -1;
  }
}

// Decodes a JPEG stream into out, a contiguous [h, w, 3] RGB uint8 buffer of
// the size rcnn_jpeg_header gave.  Returns 0, -1 or -2 as above.
extern "C" int64_t rcnn_jpeg_decode_u8(const uint8_t* data, int64_t n, uint8_t* out, int64_t h,
                                       int64_t w, char* msg, int64_t msg_len) {
  if (data == nullptr || n < 0 || out == nullptr) return -1;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    int64_t hh = 0, ww = 0;
    dec.header(&hh, &ww);
    if (hh != h || ww != w) {
      set_message(msg, msg_len, "output buffer does not match the JPEG's size");
      return -1;
    }
    dec.decode(out);
    return 0;
  } catch (const JpegError& e) {
    set_message(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return -1;
  }
}
