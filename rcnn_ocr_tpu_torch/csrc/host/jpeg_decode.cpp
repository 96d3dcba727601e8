// JPEG decoding to RGB uint8, pixel for pixel what libjpeg-turbo's default
// decompression gives (the decoder behind `cv2.imdecode(buf, IMREAD_COLOR)`),
// EXIF orientation applied as OpenCV applies it.
//
// The steps follow libjpeg-turbo's default path:
// * markers: SOI, APPn (APP0 JFIF, APP1 EXIF, APP14 Adobe), DQT (8- and
//   16-bit tables), DHT, DAC, SOF0/SOF1 (sequential Huffman), SOF2
//   (progressive Huffman), SOF9/SOF10 (sequential and progressive
//   arithmetic), SOF3 (lossless Huffman), DRI, SOS (interleaved or
//   single-component scans, one or more), RSTn, EOI;
// * every scan decodes into a whole-image coefficient buffer per component
//   (jdcoefct.c), which is reconstructed after EOI.  A single-component scan
//   walks that component's own blocks, not the MCU-padded grid;
// * Huffman entropy decoding: sequential (jdhuff.c), DC prediction per
//   component, reset at each restart marker; progressive (jdphuff.c): DC
//   first with the point transform Al, DC refinement, AC first with EOB
//   runs, AC refinement with correction bits, and libjpeg's checks on
//   Ss/Se/Ah/Al.  A segment that ends at a marker before its bits are in is
//   zero-filled and its later MCUs left as they are, as libjpeg-turbo does
//   (JWRN_HIT_MARKER); data that ends with no marker is truncated;
// * arithmetic decoding (jdarith.c, T.81 Annex D and F): the QM coder with
//   the DC and AC statistics areas, conditioned by DAC or its defaults
//   (L = 0, U = 1, Kx = 5), re-initialized at each scan and restart, for
//   sequential and the four progressive scan kinds;
// * dequantization and the ISLOW integer IDCT (jidctint.c: CONST_BITS 13,
//   PASS1_BITS 2) in the 16-bit lanes of libjpeg-turbo's x86 SIMD version,
//   clamped to 0..255 with its saturating packs (the C table differs from a
//   clamp only beyond +-512);
// * progressive images whose first AC coefficients are not all complete
//   (a stream cut short and closed by EOI) take jdcoefct.c's block
//   smoothing: coefficients 1-9 estimated from a 5x5 window of DC values,
//   DC itself too when no AC data arrived (decompress_smooth_data);
// * lossless frames (SOF3, T.81 Annex H, as libjpeg-turbo 3 decodes them:
//   jdlhuff.c, jddiffct.c, jdlossls.c): precisions 2 to 8, the sample
//   differences Huffman-coded (category 16 is 32768 with no extra bits),
//   undifferenced per row in 16-bit arithmetic with predictors 1-7, the
//   first row of a scan and of each restart interval from 2^(P-Pt-1) and
//   its left neighbour, every other row's first sample from the one above;
//   restart intervals a whole number of MCU rows; the point transform
//   shifts each sample left by Pt; no upsampling filter (libjpeg's
//   min_DCT_scaled_size is 1, so chroma is replicated) and no colour
//   conversion: libjpeg-turbo converts no lossless frame to another colour
//   space, so gray, YCbCr and YCCK frames fail (JERR_CONVERSION_NOTIMPL)
//   and 3 components without a JFIF or Adobe marker are RGB whatever their
//   ids;
// * chroma upsampling (jdsample.c, "fancy", libjpeg's default): h2v1 and
//   h2v2 triangle filters with their alternating biases, h1v2, and plain
//   replication for other integral factors or planes two columns wide;
//   edges replicate the plane's last real row and column;
// * colour (jdcolor.c): YCbCr -> RGB with the fixed-point tables
//   (SCALEBITS 16); gray is replicated to three channels; 3-component
//   images without a JFIF marker follow the Adobe transform flag or the
//   'R','G','B' component ids, as libjpeg's default_decompress_parms;
//   4-component images are CMYK (Adobe transform 0, or no Adobe marker) or
//   YCCK (any other transform), YCCK taken to CMYK as ycck_cmyk_convert
//   does, then the Adobe-inverted CMYK to RGB as OpenCV's
//   icvCvt_CMYK2BGR_8u_C4C3R does.
//
// Damaged entropy data decodes as libjpeg-turbo decodes it (its warnings,
// which OpenCV only prints): a bad Huffman code gives a zero symbol, a
// restart marker out of sequence is resynchronized as
// jdmarker.c:jpeg_resync_to_restart does, and a scan that names a Huffman
// table no DHT defined uses the standard tables (jstdhuff.c).
//
// What OpenCV's decode fails on returns -1 with a message naming it:
// damaged headers and truncated data, and the frames libjpeg-turbo refuses
// under OpenCV (arithmetic-coded lossless SOF11, hierarchical SOF5-7 and
// SOF13-15, precisions other than 8 bits (2 to 8 in lossless frames), a
// height left to a DNL marker, 2-component images, fractional chroma
// subsampling, and the lossless colour conversions above).  The decoder
// never reads past `n` bytes.
//
// Two calls: rcnn_jpeg_header for the output height and width, then
// rcnn_jpeg_decode_u8 into a caller-owned [h, w, 3] buffer.  For
// JPEG-in-TIFF, rcnn_jpeg_frame and rcnn_jpeg_decode_frame decode a strip
// or tile (its JPEGTables spliced in by the caller) as libtiff has libjpeg
// decode it: no EXIF orientation, and either no colour conversion (the
// components as coded) or YCbCr to RGB whatever the markers say.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  int code;  // -1: OpenCV's decode fails too
  std::string msg;
};

[[noreturn]] void damaged(const std::string& msg) { throw JpegError{-1, msg}; }

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

// T.81 Table D.2 (jaricom.c): (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS, plus entry 113, the fixed 0.5 bin.
#define QM(qe, nlps, nmps, sw) ((int32_t(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kQm[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),    QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),   QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),   QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),   QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),   QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),   QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),   QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),   QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),   QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),   QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),   QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),   QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),   QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),   QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

constexpr int kLookahead = 8;
constexpr int kMinGetBits = 57;  // libjpeg-turbo's MIN_GET_BITS, 64-bit buffer

struct Huffman {
  bool defined = false;
  int max_dc = 0;  // the largest symbol of a DC table (16 only in lossless scans)
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
      max_dc = 0;
      for (int i = 0; i < count; ++i) {
        if (values[i] > 16) damaged("bad Huffman table (DC symbol above 16)");
        max_dc = std::max<int>(max_dc, values[i]);
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
  // lossless frames: the samples (dh x dw), the scan's sample differences
  // (jddiffct.c's diff_buf: v rows of whole MCUs, kept between rows and
  // scans), the row above undifferenced, and whether the next row is a
  // first row (of the scan or of a restart interval)
  std::vector<uint8_t> pix;
  std::vector<int32_t> diff, above;
  int diff_w = 0;
  bool first_row = true;
  // progressive status per coefficient (jdphuff.c): -1 never coded, else
  // the Al of its last scan; and its value before the component's last scan
  int coef_bits[64], prev_coef_bits[64];
  Component() {
    std::fill(coef_bits, coef_bits + 64, -1);
    std::fill(prev_coef_bits, prev_coef_bits + 64, -1);
  }
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

  // The frame as a JPEG-in-TIFF strip reads it: SOF height and width, the
  // components, the first one's sampling factors and the largest of the
  // others'.  The stream must be parsed by header() first.
  void frame(int64_t* info) const {
    info[0] = height_;
    info[1] = width_;
    info[2] = ncomp_;
    info[3] = comp_[0].h;
    info[4] = comp_[0].v;
    info[5] = info[6] = 1;
    for (int c = 1; c < ncomp_; ++c) {
      info[5] = std::max<int64_t>(info[5], comp_[c].h);
      info[6] = std::max<int64_t>(info[6], comp_[c].v);
    }
  }

  // kFile: what OpenCV gives for a JPEG file (colour by its markers, EXIF
  // orientation); kRaw: every component upsampled, no colour conversion and
  // no orientation ([h, w, ncomp]: libtiff's JCS_UNKNOWN); kYcc: YCbCr to
  // RGB whatever the markers say, no orientation (libtiff's
  // JPEGCOLORMODE_RGB for PhotometricInterpretation YCbCr); kYccPlain: as
  // kYcc with the chroma replicated, not fancy-upsampled (libjpeg's
  // do_fancy_upsampling off), which only tests ask for, to show that a
  // fixture tells the two apart
  enum Mode { kFile = 0, kRaw = 1, kYcc = 2, kYccPlain = 3 };
  void set_mode(int mode) { mode_ = mode; }

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
        // every scan decoded but no EOI: libjpeg accepts that when the
        // first scan held every component of a sequential frame; else it
        // reads to EOI before any output, and OpenCV's source cannot wait
        if (multi_scan_) damaged("truncated JPEG data (no EOI)");
        break;
      }
    }
    // a component no scan coded (a multi-scan stream cut short) keeps zero
    // coefficients and a zero quantization table: mid-gray, as in libjpeg
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      if (!k.coded && lossless_) k.pix.assign(static_cast<size_t>(k.dw) * k.dh, 0);
      if (!k.coded && !lossless_) k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    }
    render(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0, scan_start_ = 0;

  bool sof_ = false, scanned_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  int precision_ = 8;
  bool multi_scan_ = false;  // jdinput.c's has_multiple_scans
  int scans_ = 0;
  // the last iMCU row a scan finished with its data all there: the rows
  // below it take the coefficient status from before the components' last
  // scan when smoothing (jdcoefct.c, libjpeg-turbo 2.1 and later)
  int64_t last_good_row_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0, mode_ = kFile;
  Component comp_[4];
  uint16_t qt_[4][64] = {};
  bool qt_def_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false, orientation_read_ = false;
  int adobe_transform_ = 0, orientation_ = 1;

  // entropy state
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool marker_hit_ = false, insufficient_ = false;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;  // the scan's spectral band and bits
  int eobrun_ = 0;

  // arithmetic decoding (jdarith.c): conditioning, statistics, registers
  uint8_t dc_L_[16] = {}, dc_U_[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
  uint8_t ac_K_[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = 113;
  int64_t ar_c_ = 0, ar_a_ = 0;
  int ar_ct_ = 0;
  int dc_context_[4] = {};

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
      case 0xC2:
      case 0xC9:
      case 0xCA:
        progressive_ = m == 0xC2 || m == 0xCA;
        arith_ = m >= 0xC9;
        sof(end);
        break;
      case 0xC3:
        lossless_ = true;
        sof(end);
        break;
      case 0xCB:
        damaged("arithmetic-coded lossless JPEG (SOF11), which libjpeg-turbo does not decode");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        damaged("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                "), which libjpeg-turbo does not decode");
      case 0xCC:
        dac(end);
        break;
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
        damaged("JPEG with a DNL marker, which libjpeg-turbo does not read");
      case 0xE0:
        if (len >= 16 && std::memcmp(d_ + start, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xE1:
        // OpenCV's ExifReader reads every "Exif" APP1 before the first scan
        // into one map, where the first Orientation entry stays
        if (scans_ == 0 && !orientation_read_) {
          const int o = exif_orientation(d_ + start, end - start);
          if (o >= 0) {
            orientation_read_ = true;
            orientation_ = (o >= 1 && o <= 8) ? o : 1;
          }
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
    if (lossless_ ? precision < 2 || precision > 8 : precision != 8) {
      damaged(std::to_string(precision) + "-bit " + (lossless_ ? "lossless " : "") +
              "JPEG, which OpenCV does not read");
    }
    precision_ = precision;
    if (height_ == 0) damaged("JPEG with its height in a DNL marker, which libjpeg-turbo does not read");
    if (width_ == 0) damaged("JPEG of width 0");
    if (ncomp_ < 1 || ncomp_ > 4) damaged("bad SOF component count");
    // a JPEG file of 2 components has no colour space libjpeg converts to
    // OpenCV's; libtiff decodes a gray + alpha strip as it is (kRaw)
    if (ncomp_ == 2 && mode_ != kRaw) {
      damaged("2-component JPEG, which OpenCV does not convert to colour");
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
        damaged("JPEG with fractional chroma subsampling, which libjpeg-turbo does not decode");
      }
      k.dw = static_cast<int>((static_cast<int64_t>(width_) * k.h + hmax_ - 1) / hmax_);
      k.dh = static_cast<int>((static_cast<int64_t>(height_) * k.v + vmax_ - 1) / vmax_);
      k.wib = (k.dw + 7) / 8;
      k.hib = (k.dh + 7) / 8;
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      // lossless: one sample a data unit, MCUs of h x v samples
      k.diff_w = static_cast<int>(((static_cast<int64_t>(k.dw) + k.h - 1) / k.h) * k.h);
    }
    if (lossless_) {
      mcux_ = (width_ + hmax_ - 1) / hmax_;
      mcuy_ = (height_ + vmax_ - 1) / vmax_;
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

  // jdmarker.c:get_dac: arithmetic conditioning per table
  void dac(size_t end) {
    while (pos_ + 2 <= end) {
      int index = u8(), val = u8();
      if (index >= 32) damaged("bad DAC table index");
      if (index >= 16) {
        ac_K_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L_[index] = static_cast<uint8_t>(val & 15);
        dc_U_[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L_[index] > dc_U_[index]) damaged("bad DAC value");
      }
    }
    if (pos_ != end) damaged("bad DAC segment length");
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
    // The Orientation entry's value (-1 where there is none) of an APP1
    // body: OpenCV skips the 6 bytes of "Exif\0\0" and parses a TIFF
    // header as its ExifReader does (data/exif.py says how): Intel order
    // only for "II", the first IFD's entries in order, a read past the end
    // stopping the parse with what was read kept, so the first Orientation
    // entry counts unless an earlier string or rational tag reads outside
    // the block
    if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return -1;
    const uint8_t* t = p + 6;
    const size_t tn = n - 6;
    const bool le = t[0] == 'I' && t[1] == 'I';
    struct Short {};
    auto rd16 = [&](size_t o) -> uint32_t {
      if (o + 1 >= tn) throw Short();
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (rd16(o) | (rd16(o + 2) << 16)) : ((rd16(o) << 16) | rd16(o + 2));
    };
    try {
      if (rd16(2) != 0x2A) return -1;
      const size_t ifd = rd32(4);
      const uint32_t entries = rd16(ifd);
      for (uint32_t i = 0; i < entries; ++i) {
        const size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
        const uint32_t tag = rd16(e);
        if (tag == 0x0112) return static_cast<int>(rd16(e + 8));
        int rationals = 0;
        switch (tag) {
          case 0x010E: case 0x010F: case 0x0110: case 0x0131: case 0x0132: case 0x8298: {
            const size_t size = rd32(e + 4);
            const size_t at = size > 4 ? rd32(e + 8) : 8;
            if (at > tn || at + size > tn) throw Short();
            break;
          }
          case 0x011A: case 0x011B: rationals = 1; break;
          case 0x013E: rationals = 2; break;
          case 0x0211: rationals = 3; break;
          case 0x013F: case 0x0214: rationals = 6; break;
          case 0x0128: case 0x0213: rd16(e + 8); break;
          default: break;
        }
        if (rationals > 0) {
          const size_t at = rd32(e + 8);
          for (int k = 0; k < rationals; ++k) {
            rd32(at + 8 * static_cast<size_t>(k));
            rd32(at + 8 * static_cast<size_t>(k) + 4);
          }
        }
      }
    } catch (const Short&) {
    }
    return -1;
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

  // jdhuff.c:decode_mcu, one block of a sequential scan
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

  // jdphuff.c:decode_mcu_DC_first, one block
  void dc_first(int16_t* blk, const Huffman& dct, int& pred) {
    int s = huff(dct);
    if (s) s = extend(get_bits(s), s);
    int64_t sum = static_cast<int64_t>(pred) + s;
    if (sum > INT32_MAX || sum < INT32_MIN) damaged("DC coefficient out of range");
    pred = static_cast<int>(sum);
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred) << al_);
  }

  // jdphuff.c:decode_mcu_AC_first
  void ac_first(int16_t* blk, const Huffman& act) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int rs = huff(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(get_bits(s), s)) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        --eobrun_;
        break;
      }
    }
  }

  // one correction bit for an already non-zero coefficient
  void correct(int16_t& c, int p1, int m1) {
    if (get_bits(1) && (c & p1) == 0) c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
  }

  // jdphuff.c:decode_mcu_AC_refine (libjpeg's undo on suspension cannot
  // happen: the bytes are all here, and past a marker the bits are zeros)
  void ac_refine(int16_t* blk, const Huffman& act) {
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int rs = huff(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a size other than 1 is only warned of
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(c, p1, m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(c, p1, m1);
      }
      --eobrun_;
    }
  }

  // --- arithmetic decoding (jdarith.c) ------------------------------------

  // arith_decode: one binary decision with the adaptive estimate at *st
  int decide(uint8_t* st) {
    while (ar_a_ < 0x8000) {
      if (--ar_ct_ < 0) {
        int data = 0;  // past a marker: zeros until the decode is complete
        if (!marker_hit_) {
          if (pos_ >= n_) damaged("truncated JPEG data");
          data = d_[pos_++];
          if (data == 0xFF) {
            size_t q = pos_;
            while (q < n_ && d_[q] == 0xFF) ++q;
            if (q >= n_) damaged("truncated JPEG data");
            if (d_[q] == 0) {
              pos_ = q + 1;  // a stuffed 0xFF data byte
            } else {
              marker_hit_ = true;  // leave pos_ on the marker's last 0xFF
              pos_ = q - 1;
              data = 0;
            }
          }
        }
        ar_c_ = (ar_c_ << 8) | data;
        if ((ar_ct_ += 8) < 0 && ++ar_ct_ == 0) ar_a_ = 0x8000;  // two first bytes in
      }
      ar_a_ <<= 1;
    }
    int sv = *st;
    int32_t qe = kQm[sv & 0x7F];
    int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = ar_a_ - qe;
    ar_a_ = temp;
    temp <<= ar_ct_;
    if (ar_c_ >= temp) {
      ar_c_ -= temp;
      if (ar_a_ < qe) {
        ar_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ar_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a_ < 0x8000) {
      if (ar_a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Figures F.19 and F.21-F.24: one DC difference into pred (mod 2^16)
  void ar_dc_diff(int tbl, int ci, int& pred) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
    if (decide(st) == 0) {
      dc_context_[ci] = 0;
      return;
    }
    int sign = decide(st + 1);
    st += 2 + sign;
    int m = decide(st);
    if (m) {
      st = dc_stats_[tbl] + 20;
      while (decide(st)) {
        if ((m <<= 1) == 0x8000) {
          ar_ct_ = -1;  // magnitude overflow: the rest of the scan is skipped
          return;
        }
        ++st;
      }
    }
    if (m < static_cast<int>((1L << dc_L_[tbl]) >> 1)) {
      dc_context_[ci] = 0;
    } else if (m > static_cast<int>((1L << dc_U_[tbl]) >> 1)) {
      dc_context_[ci] = 12 + sign * 4;
    } else {
      dc_context_[ci] = 4 + sign * 4;
    }
    int v = m;
    st += 14;
    while (m >>= 1) {
      if (decide(st)) v |= m;
    }
    v += 1;
    if (sign) v = -v;
    pred = (pred + v) & 0xFFFF;
  }

  // Figures F.20-F.24 over the band k0..se_; false on an overflow
  bool ar_ac(int16_t* blk, int tbl, int k0) {
    for (int k = k0; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (decide(st)) break;  // EOB
      while (decide(st + 1) == 0) {
        st += 3;
        if (++k > se_) return false;
      }
      int sign = decide(&fixed_bin_);
      st += 2;
      int m = decide(st);
      if (m && decide(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= ac_K_[tbl] ? 189 : 217);
        while (decide(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1) {
        if (decide(st)) v |= m;
      }
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al_);
    }
    return true;
  }

  // decode_mcu_AC_refine; false on a spectral overflow
  bool ar_ac_refine(int16_t* blk, int tbl) {
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int kex = se_;
    for (; kex > 0; --kex) {
      if (blk[kNatural[kex]]) break;
    }
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && decide(st)) break;  // EOB
      for (;;) {
        int16_t& c = blk[kNatural[k]];
        if (c) {
          if (decide(st + 2)) c = static_cast<int16_t>(c + (c < 0 ? m1 : p1));
          break;
        }
        if (decide(st + 1)) {
          c = static_cast<int16_t>(decide(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) return false;
      }
    }
    return true;
  }

  // the statistics and registers of a scan's start or a restart
  void ar_reset(Component* const* sc, int ns) {
    for (int i = 0; i < ns; ++i) {
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::memset(dc_stats_[sc[i]->dc_tbl], 0, 64);
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_) std::memset(ac_stats_[sc[i]->ac_tbl], 0, 256);
    }
    ar_c_ = ar_a_ = 0;
    ar_ct_ = -16;
  }

  // One block of the scan's kind, `ci` its component's place in the scan.
  void decode_block(int16_t* blk, const Component& k, int ci, int& pred) {
    if (arith_) {
      if (progressive_ && ah_ && ss_ == 0) {  // DC refinement: no error check
        if (decide(&fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
        return;
      }
      if (ar_ct_ == -1) return;  // after an overflow libjpeg does nothing
      if (!progressive_ || ss_ == 0) {
        ar_dc_diff(k.dc_tbl, ci, pred);
        if (ar_ct_ == -1) return;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred) << (progressive_ ? al_ : 0));
        if (progressive_) return;
      }
      bool ok = !progressive_ ? ar_ac(blk, k.ac_tbl, 1)
                : ah_ ? ar_ac_refine(blk, k.ac_tbl) : ar_ac(blk, k.ac_tbl, ss_);
      if (!ok) ar_ct_ = -1;
      return;
    }
    if (!progressive_) {
      block(blk, dc_[k.dc_tbl], ac_[k.ac_tbl], pred);
    } else if (ss_ == 0 && ah_ == 0) {
      dc_first(blk, dc_[k.dc_tbl], pred);
    } else if (ss_ == 0) {
      if (get_bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
    } else if (ah_ == 0) {
      ac_first(blk, ac_[k.ac_tbl]);
    } else {
      ac_refine(blk, ac_[k.ac_tbl]);
    }
  }

  // libjpeg's checks on a progressive scan's parameters (jdphuff.c and
  // jdarith.c start_pass) and the coefficient status it keeps
  void progression(Component* const* sc, int ns) {
    bool bad = ss_ == 0 ? se_ != 0 : (ss_ > se_ || se_ > 63 || ns != 1);
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) damaged("bad progressive scan parameters");
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      for (int c = std::min(ss_, 1); c <= std::max(se_, 9); ++c) {
        k.prev_coef_bits[c] = scans_ > 0 ? k.coef_bits[c] : 0;
      }
      for (int c = ss_; c <= se_; ++c) k.coef_bits[c] = al_;
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
      sc[i] = k;
    }
    ss_ = u8();
    se_ = u8();
    int ahl = u8();
    ah_ = ahl >> 4;
    al_ = ahl & 15;
    if (scans_ == 0) multi_scan_ = progressive_ || ns < ncomp_;
    if (lossless_) {  // jdlossls.c:start_pass_lossless
      if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= precision_) {
        damaged("bad lossless JPEG scan parameters");
      }
    } else if (progressive_) {
      progression(sc, ns);
    } else {  // a sequential scan codes all 64 coefficients whatever it says
      ss_ = 0;
      se_ = 63;
      ah_ = al_ = 0;
    }
    for (int i = 0; i < ns; ++i) {
      Component* k = sc[i];
      bool dc = lossless_ || !progressive_ || (ss_ == 0 && ah_ == 0);
      bool ac = !lossless_ && (!progressive_ || ss_ != 0);
      if (!arith_) {
        // jdhuff.c:jpeg_make_d_derived_tbl falls back on jstdhuff.c's tables
        for (int is_ac = 0; is_ac < 2; ++is_ac) {
          if (!(is_ac ? ac : dc)) continue;
          int th = is_ac ? k->ac_tbl : k->dc_tbl;
          if (th > 3) damaged("bad SOS table ids");
          Huffman& t = is_ac ? ac_[th] : dc_[th];
          if (!t.defined) {
            if (th > 1) damaged("scan uses an undefined Huffman table");
            if (is_ac) {
              t.build(kStdAcBits[th], kStdAcVals[th], 162, false);
            } else {
              t.build(kStdDcBits[th], kStdDcVals, 12, true);
            }
          }
          // jpeg_make_d_derived_tbl: DC symbols up to 15, 16 in lossless scans
          if (!is_ac && t.max_dc > (lossless_ ? 16 : 15)) {
            damaged("bad Huffman table (DC symbol above 15)");
          }
        }
      }
      if (!k->coded && lossless_) {
        k->pix.assign(static_cast<size_t>(k->dw) * k->dh, 0);
        k->diff.assign(static_cast<size_t>(k->diff_w) * k->v, 0);
        k->above.assign(static_cast<size_t>(k->dw), 0);
        k->coded = true;
      } else if (!k->coded) {
        if (!qt_def_[k->tq]) damaged("component uses an undefined quantization table");
        std::memcpy(k->quant, qt_[k->tq], sizeof(k->quant));
        k->coef.assign(static_cast<size_t>(k->bw) * k->bh * 64, 0);
        k->coded = true;
      }
      k->first_row = true;
    }

    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks > 10) damaged("too many blocks in an MCU");
    if (lossless_) {
      lossless_scan(sc, ns);
      return;
    }
    int64_t mcus_x = ns == 1 ? sc[0]->wib : mcux_;
    int64_t mcus_y = ns == 1 ? sc[0]->hib : mcuy_;
    int64_t total = mcus_x * mcus_y;

    buf_ = 0;
    bits_ = 0;
    marker_hit_ = insufficient_ = false;
    eobrun_ = 0;
    if (arith_) ar_reset(sc, ns);
    int pred[4] = {0, 0, 0, 0};
    int next_rst = 0;
    // a Huffman DC refinement reads zeros past a marker and changes nothing,
    // so libjpeg does not skip it
    const bool skip_short = !arith_ && !(progressive_ && ss_ == 0 && ah_ != 0);
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && m && m % restart_interval_ == 0) restart(next_rst, pred, sc, ns);
      if (skip_short && insufficient_) continue;  // the rest of this segment stays
      int64_t mx = m % mcus_x, my = m / mcus_x;
      // an MCU begun with its data there: its iMCU row (one MCU row
      // interleaved, v block rows of a single component) is the last good one
      if (!insufficient_) last_good_row_ = ns == 1 ? my / sc[0]->v : my;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
        for (int y = 0; y < bh; ++y) {
          for (int x = 0; x < bwid; ++x) {
            int64_t by = my * bh + y, bx = mx * bwid + x;
            int16_t* blk = &k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64];
            decode_block(blk, k, i, pred[i]);
          }
        }
      }

    }
    end_scan();
  }

  // jdhuff.c:finish_pass discards the buffered bits; the marker reader
  // then skips to the next marker
  void end_scan() {
    if (!marker_hit_) {
      while (pos_ < n_ && !(d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0 &&
                            d_[pos_ + 1] != 0xFF)) {
        ++pos_;
      }
    }
    scanned_ = true;
    ++scans_;
  }

  // One lossless scan as libjpeg-turbo 3 decodes it, an iMCU row at a time
  // (jddiffct.c:decompress_data): each MCU row's differences (jdlhuff.c:
  // decode_mcus; after the data ran out at a marker, a later row's call
  // leaves the buffer as it was), a restart before an MCU row when the
  // interval's rows are done, then each component's rows of the iMCU row
  // undifferenced (jdlossls.c) and shifted left by the point transform.
  void lossless_scan(Component* const* sc, int ns) {
    buf_ = 0;
    bits_ = 0;
    marker_hit_ = insufficient_ = false;
    const bool one = ns == 1;
    const int64_t per_row = one ? sc[0]->dw : mcux_;  // MCUs in an MCU row
    if (restart_interval_ % per_row) {
      damaged("lossless JPEG restart interval that is not a whole number of MCU rows");
    }
    const int64_t imcu_rows = (height_ + vmax_ - 1) / vmax_;
    int64_t rows_to_go = restart_interval_ / per_row;
    int next_rst = 0, pred[4] = {};
    const int initial = 1 << (precision_ - al_ - 1);
    for (int64_t r = 0; r < imcu_rows; ++r) {
      const bool last = r == imcu_rows - 1;
      auto rows_of = [&](const Component& k) {
        int left = k.dh % k.v;
        return last && left ? left : k.v;
      };
      const int mcu_rows = one ? rows_of(*sc[0]) : 1;
      for (int mr = 0; mr < mcu_rows; ++mr) {
        if (restart_interval_) {
          if (rows_to_go == 0) {
            restart(next_rst, pred, sc, ns);
            for (int i = 0; i < ns; ++i) sc[i]->first_row = true;
            rows_to_go = restart_interval_ / per_row;
          }
        }
        if (!insufficient_) {
          for (int64_t mx = 0; mx < per_row; ++mx) {
            for (int i = 0; i < ns; ++i) {
              Component& k = *sc[i];
              const Huffman& t = dc_[k.dc_tbl];
              const int bh = one ? 1 : k.v, bwid = one ? 1 : k.h;
              for (int y = 0; y < bh; ++y) {
                for (int x = 0; x < bwid; ++x) {
                  int s = huff(t);
                  int d = s == 0 ? 0 : s == 16 ? 32768 : extend(get_bits(s), s);
                  k.diff[static_cast<size_t>(one ? mr : y) * k.diff_w + mx * bwid + x] = d;
                }
              }
            }
          }
        }
        if (restart_interval_) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int rows = rows_of(k);
        for (int y = 0; y < rows; ++y) {
          const int64_t yy = r * k.v + y;
          if (yy >= k.dh) break;
          undifference(k, &k.diff[static_cast<size_t>(y) * k.diff_w], initial,
                       &k.pix[static_cast<size_t>(yy) * k.dw]);
        }
      }
    }
    end_scan();
  }

  // jdlossls.c: one row of differences to samples, in 16-bit arithmetic;
  // the first row of a scan or restart interval from `initial` and then the
  // left neighbour, any other from the sample above and then the scan's
  // predictor (Ss)
  void undifference(Component& k, const int32_t* d, int initial, uint8_t* out) {
    int32_t* above = k.above.data();
    const int w = k.dw;
    int64_t ra = 0, rb = 0, rc = 0;
    if (k.first_row) {
      ra = (d[0] + initial) & 0xFFFF;
      above[0] = static_cast<int32_t>(ra);
      for (int x = 1; x < w; ++x) {
        ra = (d[x] + ra) & 0xFFFF;
        above[x] = static_cast<int32_t>(ra);
      }
      k.first_row = false;
    } else {
      rb = above[0];
      ra = (d[0] + rb) & 0xFFFF;
      above[0] = static_cast<int32_t>(ra);
      for (int x = 1; x < w; ++x) {
        rc = rb;
        rb = above[x];
        int64_t p;
        switch (ss_) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        ra = (d[x] + p) & 0xFFFF;
        above[x] = static_cast<int32_t>(ra);
      }
    }
    for (int x = 0; x < w; ++x) out[x] = static_cast<uint8_t>(above[x] << al_);
  }

  // jdhuff.c:process_restart with jdmarker.c:read_restart_marker: the
  // buffered bits are dropped and the next marker read (skipping any
  // garbage before it); a marker other than the expected RSTn is handled as
  // jpeg_resync_to_restart does: skipped (an earlier RSTn or a non-marker
  // code), left unread so the segment decodes as empty (a later RSTn or
  // another marker), or taken as the expected one (an RSTn further off).
  // The DC predictions, the EOB run and the arithmetic statistics restart.
  void restart(int& next_rst, int* pred, Component* const* sc, int ns) {
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
    eobrun_ = 0;
    if (arith_) ar_reset(sc, ns);
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

  // jdcoefct.c:smoothing_ok: a progressive image whose DC is known for
  // every component and some of whose coefficients 1-9 are not complete.
  bool smoothing() const {
    if (!progressive_) return false;
    bool useful = false;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (!k.coded) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24}) {
        if (k.quant[pos] == 0) return false;
      }
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i) useful |= k.coef_bits[i] != 0;
    }
    return useful;
  }

  // The block rows whose DC values jdcoefct.c:decompress_smooth_data
  // (libjpeg-turbo 2.1 and later) reads around block row `r`: two above,
  // the row, two below, as it indexes them (MCU padding rows included, the
  // image's edges replicated by its own tests).
  void window_rows(const Component& k, int r, int* rws) const {
    const int V = k.v, imcu = r / V, block_row = r % V;
    int block_rows = V;
    if (imcu == mcuy_ - 1) {
      block_rows = k.hib % V;
      if (block_rows == 0) block_rows = V;
    }
    const int64_t row = static_cast<int64_t>(imcu) * block_rows + block_row;
    const int64_t rows = static_cast<int64_t>(block_rows) * mcuy_;
    rws[1] = row > 0 ? r - 1 : r;
    rws[0] = row > 1 ? r - 2 : rws[1];
    rws[2] = r;
    rws[3] = row < rows - 1 ? r + 1 : r;
    rws[4] = row < rows - 2 ? r + 2 : rws[3];
  }

  // decompress_smooth_data's estimates for one block: D[1..25] are the DC
  // values of its 5x5 window in the order DC01..DC25, `ws` the block.
  // `cb` is the coefficient status that applies to the block's row.
  void smooth_block(const Component& k, const int* D, const int* cb, int16_t* ws) const {
    const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                           cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                           cb[9] == -1;
    const int64_t Q00 = k.quant[0];
    auto estimate = [&](int bits_i, int pos, int64_t num) {
      int Al = cb[bits_i];
      if (Al == 0 || ws[pos] != 0) return;
      const int64_t q = k.quant[pos];
      num *= Q00;
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((q << 7) + num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      } else {
        pred = static_cast<int>(((q << 7) - num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
        pred = -pred;
      }
      ws[pos] = static_cast<int16_t>(pred);
    };
    const int* d = D;
    estimate(1, 1, change_dc ? (-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] +
                                3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] -
                                3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21] - d[22] +
                                d[24] + d[25])
                             : (-7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]));
    estimate(2, 8, change_dc ? (-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] +
                                13 * d[7] + 38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] -
                                38 * d[18] - 13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] +
                                3 * d[24] + d[25])
                             : (-7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]));
    estimate(3, 16, change_dc ? (d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                                 5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23])
                              : (-d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]));
    estimate(4, 9, change_dc ? (-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] +
                                d[21] - d[25])
                             : (d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] -
                                d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]));
    estimate(5, 2, change_dc ? (2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                                7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19])
                             : (-d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]));
    if (change_dc) {
      estimate(6, 3, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
      estimate(7, 10, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
      estimate(8, 17, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
      estimate(9, 24, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
      int64_t num = Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] +
                           6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] +
                           152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] +
                           42 * d[18] + 6 * d[19] - 6 * d[20] - 2 * d[21] - 6 * d[22] -
                           8 * d[23] - 6 * d[24] - 2 * d[25]);
      int pred = num >= 0 ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                          : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
      ws[0] = static_cast<int16_t>(pred);
    }
  }

  // A component's samples, [hib * 8, wib * 8] (the real dh x dw in the corner)
  std::vector<uint8_t> plane(const Component& k, bool smooth) const {
    int stride = k.wib * 8;
    std::vector<uint8_t> p(static_cast<size_t>(k.hib) * 8 * stride);
    if (lossless_) {
      for (int y = 0; y < k.dh; ++y) {
        std::memcpy(&p[static_cast<size_t>(y) * stride], &k.pix[static_cast<size_t>(y) * k.dw], k.dw);
      }
      return p;
    }
    int16_t ws[64];
    int rws[5], D[26], prev_bits[10];
    for (int i = 1; i < 10; ++i) prev_bits[i] = scans_ > 1 ? k.prev_coef_bits[i] : -1;
    auto dc = [&](int y, int x) -> int { return k.coef[(static_cast<size_t>(y) * k.bw + x) * 64]; };
    for (int by = 0; by < k.hib; ++by) {
      if (smooth) {  // the sliding registers, loaded as libjpeg loads them
        window_rows(k, by, rws);
        for (int i = 0; i < 5; ++i) {
          for (int j = 1; j <= 5; ++j) D[5 * i + j] = dc(rws[i], 0);
        }
      }
      const int last = k.wib - 1;
      for (int bx = 0; bx < k.wib; ++bx) {
        const int16_t* blk = &k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64];
        if (smooth) {
          for (int i = 0; i < 5; ++i) {
            if (bx == 0 && bx < last) D[5 * i + 4] = D[5 * i + 5] = dc(rws[i], 1);
            if (bx + 1 < last) D[5 * i + 5] = dc(rws[i], bx + 2);
          }
          std::memcpy(ws, blk, sizeof(ws));
          smooth_block(k, D, by / k.v > last_good_row_ ? prev_bits : k.coef_bits, ws);
          blk = ws;
          for (int i = 0; i < 5; ++i) {
            for (int j = 1; j <= 4; ++j) D[5 * i + j] = D[5 * i + j + 1];
          }
        }
        idct(blk, k.quant, &p[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
    }
    return p;
  }

  // A component upsampled to width_ x height_ (jdsample.c), contiguous.
  std::vector<uint8_t> upsample(const Component& k, bool smooth) const {
    std::vector<uint8_t> src = plane(k, smooth);
    const int stride = k.wib * 8, W = width_, H = height_, dw = k.dw, dh = k.dh;
    const int hr = hmax_ / k.h, vr = vmax_ / k.v;
    auto at = [&](int y, int x) -> int { return src[static_cast<size_t>(y) * stride + x]; };
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[static_cast<size_t>(y) * W], &src[static_cast<size_t>(y) * stride], W);
      return out;
    }
    // jdsample.c: no fancy upsampling where min_DCT_scaled_size is 1 (lossless)
    const bool fancy = mode_ != kYccPlain && !lossless_;
    const bool h2v1 = fancy && hr == 2 && vr == 1 && dw > 2;
    const bool h1v2 = fancy && hr == 1 && vr == 2;
    const bool h2v2 = fancy && hr == 2 && vr == 2 && dw > 2;
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
    const bool smooth = smoothing();
    if (mode_ == kRaw) {
      for (int c = 0; c < ncomp_; ++c) {
        std::vector<uint8_t> p = upsample(comp_[c], smooth);
        for (size_t i = 0; i < npix; ++i) out[i * ncomp_ + c] = p[i];
      }
      return;
    }
    std::vector<uint8_t> rgb(npix * 3);
    // jdcolor.c (libjpeg-turbo 3): a lossless frame is output in its own
    // colour space or not at all, and OpenCV asks for BGR or CMYK
    const bool ycc_space = mode_ == kYcc || mode_ == kYccPlain || jfif_ ||
                           (adobe_ && adobe_transform_ != 0);
    if (lossless_ && (ncomp_ == 1 || (ncomp_ == 3 && ycc_space) ||
                      (ncomp_ == 4 && adobe_ && adobe_transform_ != 0))) {
      damaged(std::string("lossless ") +
              (ncomp_ == 1 ? "gray" : ncomp_ == 3 ? "YCbCr" : "YCCK") +
              " JPEG, which libjpeg-turbo does not convert to OpenCV's colour space");
    }
    if (ncomp_ == 1) {
      std::vector<uint8_t> g = upsample(comp_[0], smooth);
      for (size_t i = 0; i < npix; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
    } else if (ncomp_ == 4) {
      std::vector<uint8_t> c0 = upsample(comp_[0], smooth), c1 = upsample(comp_[1], smooth),
                           c2 = upsample(comp_[2], smooth), c3 = upsample(comp_[3], smooth);
      const bool ycck = adobe_ && adobe_transform_ != 0;
      const YccTables& t = ycc();
      for (size_t i = 0; i < npix; ++i) {
        int c = c0[i], m = c1[i], y = c2[i], k = c3[i];
        if (ycck) {  // jdcolor.c:ycck_cmyk_convert, K passed through
          int yy = c0[i], cb = c1[i], cr = c2[i];
          c = 255 - clamp255(yy + t.cr_r[cr]);
          m = 255 - clamp255(yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          y = 255 - clamp255(yy + t.cb_b[cb]);
        }
        // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on Adobe-inverted CMYK
        rgb[3 * i] = static_cast<uint8_t>(k - (((255 - c) * k) >> 8));
        rgb[3 * i + 1] = static_cast<uint8_t>(k - (((255 - m) * k) >> 8));
        rgb[3 * i + 2] = static_cast<uint8_t>(k - (((255 - y) * k) >> 8));
      }
    } else {
      std::vector<uint8_t> c0 = upsample(comp_[0], smooth), c1 = upsample(comp_[1], smooth),
                           c2 = upsample(comp_[2], smooth);
      bool is_rgb;
      if (mode_ == kYcc || mode_ == kYccPlain) {
        is_rgb = false;
      } else if (jfif_) {
        is_rgb = false;
      } else if (adobe_) {
        is_rgb = adobe_transform_ == 0;
      } else {  // jdapimin.c:default_decompress_parms guesses from the ids
        is_rgb = lossless_ || (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66);
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
    const int o = mode_ == kFile ? orientation_ : 1;
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
// orientation.  Returns 0 or -1 (what OpenCV fails on; msg names it).
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
// the size rcnn_jpeg_header gave.  Returns 0 or -1 as above.
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

// The frame of a JPEG stream (a JPEG-in-TIFF strip or tile with its tables
// spliced in): info = {SOF height, width, components (1-4: a gray + alpha
// frame of 2 reads here, as libtiff reads it), component 0's h and v
// sampling, the largest h and v of the others}.  Returns 0 or -1.
extern "C" int64_t rcnn_jpeg_frame(const uint8_t* data, int64_t n, int64_t* info, char* msg,
                                   int64_t msg_len) {
  if (data == nullptr || n < 0 || info == nullptr) return -1;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.set_mode(Decoder::kRaw);  // the frame as coded: 2 components too
    int64_t hh = 0, ww = 0;
    dec.header(&hh, &ww);
    dec.frame(info);
    return 0;
  } catch (const JpegError& e) {
    set_message(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return -1;
  }
}

// Decodes a JPEG stream as a TIFF strip or tile: mode 1 (Decoder::kRaw)
// into out [h, w, components] (2 components too), mode 2 (kYcc) or 3 (kYccPlain) into out
// [h, w, 3], h and w the SOF's.  Returns 0 or -1 as above.
extern "C" int64_t rcnn_jpeg_decode_frame(const uint8_t* data, int64_t n, int64_t mode,
                                          uint8_t* out, int64_t h, int64_t w, int64_t c, char* msg,
                                          int64_t msg_len) {
  if (data == nullptr || n < 0 || out == nullptr || mode < 1 || mode > 3) return -1;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.set_mode(static_cast<int>(mode));
    int64_t hh = 0, ww = 0, info[7];
    dec.header(&hh, &ww);
    dec.frame(info);
    if (info[0] != h || info[1] != w || (mode == 1 ? info[2] : 3) != c ||
        (mode != 1 && info[2] != 3)) {
      set_message(msg, msg_len, "output buffer does not match the JPEG frame");
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
