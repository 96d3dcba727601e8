// A baseline JPEG encoder for 8-bit gray images, giving the bytes
// cv2.imencode(".jpg", gray, [IMWRITE_JPEG_QUALITY, q]) gives: the stream
// libjpeg-turbo writes with its defaults (jpeg_set_defaults,
// jpeg_set_quality(q, force_baseline)):
//
// * SOI, a JFIF 1.01 APP0 (aspect 1:1, no units), one 8-bit DQT, SOF0, the
//   standard luminance DC and AC Huffman tables (jcparam.c), one SOS, the
//   entropy-coded blocks, EOI;
// * the image padded to whole blocks by repeating its last column and row
//   (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge);
// * samples centred on 128, the ISLOW forward DCT (jfdctint.c), and the
//   quantizer of jcdctmgr.c: a reciprocal multiply with its correction
//   term in 16-bit lanes, as the SIMD and C paths of libjpeg-turbo both do;
// * Huffman coding as jchuff.c: DC differences, AC run lengths with ZRL and
//   EOB, 0xFF bytes stuffed, the last byte padded with one bits.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl, in natural order
const int kLuminance[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
};

// jchuff.c jpeg_make_c_derived_tbl
Huff derive(const uint8_t* bits, const uint8_t* vals) {
  Huff h;
  int k = 0;
  uint32_t code = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i, ++k) {
      h.code[vals[k]] = uint16_t(code++);
      h.size[vals[k]] = uint8_t(len);
    }
    code <<= 1;
  }
  return h;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;

  void put(uint32_t code, int size) {
    for (int b = size - 1; b >= 0; --b) {
      acc = (acc << 1) | ((code >> b) & 1);
      if (++n == 8) {
        out.push_back(uint8_t(acc));
        if (uint8_t(acc) == 0xFF) out.push_back(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {
    if (n) put(0x7F, 8 - n);
  }
};

// jfdctint.c jpeg_fdct_islow
void fdct_islow(int32_t* d) {
  const int64_t c0_298 = 2446, c0_390 = 3196, c0_541 = 4433, c0_765 = 6270, c0_899 = 7373,
                c1_175 = 9633, c1_501 = 12299, c1_847 = 15137, c1_961 = 16069, c2_053 = 16819,
                c2_562 = 20995, c3_072 = 25172;
  auto descale = [](int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    int sh = pass ? 13 + 2 : 13 - 2;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, 2);
        p[4 * step] = descale(tmp10 - tmp11, 2);
      } else {
        p[0] = int32_t((tmp10 + tmp11) << 2);
        p[4 * step] = int32_t((tmp10 - tmp11) << 2);
      }
      int64_t z1 = (tmp12 + tmp13) * c0_541;
      p[2 * step] = descale(z1 + tmp13 * c0_765, sh);
      p[6 * step] = descale(z1 - tmp12 * c1_847, sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * c1_175;
      tmp4 *= c0_298;
      tmp5 *= c2_053;
      tmp6 *= c3_072;
      tmp7 *= c1_501;
      z1 *= -c0_899;
      z2 *= -c2_562;
      z3 = z3 * -c1_961 + z5;
      z4 = z4 * -c0_390 + z5;
      p[7 * step] = descale(tmp4 + z1 + z3, sh);
      p[5 * step] = descale(tmp5 + z2 + z4, sh);
      p[3 * step] = descale(tmp6 + z2 + z3, sh);
      p[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor, fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

void segment(std::vector<uint8_t>& out, uint8_t marker, const std::vector<uint8_t>& body) {
  out.push_back(0xFF);
  out.push_back(marker);
  size_t len = body.size() + 2;
  out.push_back(uint8_t(len >> 8));
  out.push_back(uint8_t(len));
  out.insert(out.end(), body.begin(), body.end());
}

int nbits(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int quality) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int q[64];
  for (int k = 0; k < 64; ++k) {
    long t = (long(kLuminance[k]) * scale + 50) / 100;
    q[k] = t <= 0 ? 1 : (t > 255 ? 255 : int(t));
  }
  Divisor div[64];
  for (int k = 0; k < 64; ++k) div[k] = reciprocal(uint32_t(q[k]) << 3);

  std::vector<uint8_t> out = {0xFF, 0xD8};
  segment(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  std::vector<uint8_t> dqt = {0};
  for (int k = 0; k < 64; ++k) dqt.push_back(uint8_t(q[kNatural[k]]));
  segment(out, 0xDB, dqt);
  segment(out, 0xC0, {8, uint8_t(h >> 8), uint8_t(h), uint8_t(w >> 8), uint8_t(w), 1, 1, 0x11, 0});
  std::vector<uint8_t> dht = {0x00};
  dht.insert(dht.end(), kDcBits + 1, kDcBits + 17);
  dht.insert(dht.end(), kDcVals, kDcVals + 12);
  segment(out, 0xC4, dht);
  dht = {0x10};
  dht.insert(dht.end(), kAcBits + 1, kAcBits + 17);
  dht.insert(dht.end(), kAcVals, kAcVals + 162);
  segment(out, 0xC4, dht);
  segment(out, 0xDA, {1, 1, 0x00, 0, 63, 0});

  Huff dc = derive(kDcBits, kDcVals), ac = derive(kAcBits, kAcVals);
  BitWriter bw{out};
  int last_dc = 0;
  int bh = (h + 7) / 8, bwid = (w + 7) / 8;
  int32_t blk[64];
  int coef[64];
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bwid; ++bx) {
      for (int y = 0; y < 8; ++y) {
        int sy = std::min(by * 8 + y, h - 1);
        for (int x = 0; x < 8; ++x) {
          int sx = std::min(bx * 8 + x, w - 1);
          blk[y * 8 + x] = int32_t(img[size_t(sy) * w + sx]) - 128;
        }
      }
      fdct_islow(blk);
      for (int k = 0; k < 64; ++k) {
        int32_t t = blk[k];
        bool neg = t < 0;
        uint32_t a = uint32_t(neg ? -t : t);
        uint32_t v = (((a + div[k].corr) & 0xFFFF) * div[k].recip) >> div[k].shift;
        coef[k] = neg ? -int(v & 0xFFFF) : int(v & 0xFFFF);
      }
      int diff = coef[0] - last_dc;
      last_dc = coef[0];
      int nb = nbits(diff);
      bw.put(dc.code[nb], dc.size[nb]);
      if (nb) bw.put(uint32_t(diff < 0 ? diff - 1 : diff) & ((1u << nb) - 1), nb);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        int v = coef[kNatural[k]];
        if (v == 0) { ++run; continue; }
        while (run > 15) {
          bw.put(ac.code[0xF0], ac.size[0xF0]);
          run -= 16;
        }
        nb = nbits(v);
        int sym = (run << 4) + nb;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put(uint32_t(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
        run = 0;
      }
      if (run > 0) bw.put(ac.code[0], ac.size[0]);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

}  // namespace

extern "C" {

// Encode a gray uint8 image [h, w] at `quality`: returns the stream's
// length, writing it to `out` when it fits in `cap` bytes (call again with
// room for the returned length when it did not); < 0 on bad arguments.
int64_t rcnn_jpeg_encode_gray(const uint8_t* img, int64_t h, int64_t w, int64_t quality,
                              uint8_t* out, int64_t cap, char* msg, int64_t msg_len) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) {
    std::string s = "image sides must be 1..65535";
    if (msg && msg_len > 0) {
      size_t n = std::min<size_t>(size_t(msg_len - 1), s.size());
      std::memcpy(msg, s.data(), n);
      msg[n] = 0;
    }
    return -1;
  }
  std::vector<uint8_t> s = encode(img, int(h), int(w), int(quality));
  if (int64_t(s.size()) <= cap) std::memcpy(out, s.data(), s.size());
  return int64_t(s.size());
}

}  // extern "C"
