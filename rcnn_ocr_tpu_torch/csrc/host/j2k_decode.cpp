// JPEG 2000 (ITU-T T.800 | ISO/IEC 15444-1) codestreams in host C++, to
// the per-component integer planes OpenJPEG gives OpenCV's reader.
//
// The codestream: the main header (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM,
// TLM, PLM, CRG, COM, and CAP, CPF, MCT, MCC, MCO, CBD read and ignored as
// OpenJPEG ignores them; unknown markers skipped two bytes at a time up to
// the next known one), then tile-parts (SOT, a header of COD, COC, QCD, QCC,
// RGN, POC, PPT, PLT, COM, then SOD and the data) read as OpenJPEG 2.5
// reads them in its default (strict) mode: a tile is decoded when its last
// tile-part (TNsot) has been read, or at EOC; a tile-part whose data runs
// past the end of the stream is an error; tiles never sent stay 0.
//
// Tier 2: packets in the five progression orders and under POC (a packet
// is read once, its first time), tag trees, zero bit-planes, Lblock and
// pass counts, code-word segments as the code-block style splits them,
// SOP markers (skipped where present) and EPH markers (required), packet
// headers from PPM or PPT; an HT code-block's passes split as OpenJPEG's
// t2 splits them (one pass to the first segment, the rest to the next, in
// every layer).  Tier 1: the MQ decoder, the three coding passes and their
// contexts, with every style bit (BYPASS, RESET, TERMALL, VSC, PTERM,
// SEGSYM), reconstructing at the middle of the undecoded interval as
// OpenJPEG does (values in half units); and HTJ2K (T.814) code-blocks:
// the cleanup pass (MEL, VLC over the tables of ht_tables.inc, UVLC,
// MagSgn), SigProp and MagRef, into the same half units.  Then ROI
// max-shift, dequantization (no quantization, derived or
// expounded step sizes), the integer 5/3 or float32 9/7 inverse DWT in
// OpenJPEG's order of operations (its 9/7 scales the high band by
// 1.625732422 and step sizes by no band gain), the inverse RCT or ICT,
// then the DC level shift and a clamp to the component's range, float
// samples rounded as lrintf rounds them.  Built with -ffp-contract=off so
// that no multiply-add is fused and the float path is bit-equal.
//
// A colour transform over components of mixed wavelets reads each buffer's
// bits as the transform's kind, as OpenJPEG does.  Errors (return -1, where
// OpenJPEG fails and cv2.imdecode gives None): damaged headers, data past
// the stream, a missing EPH marker, a code-block whose bit-planes exceed 30,
// an HT code-block OpenJPEG fails (its lengths, Scup, passes, MEL, U_q or
// VLC out of bounds, or under ROI).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct Failure {
  int code;  // -1: damaged
  std::string what;
};

[[noreturn]] void damaged(const std::string& what) { throw Failure{-1, "JPEG 2000: " + what}; }

void set_message(char* msg, int64_t msg_len, const std::string& text) {
  if (msg != nullptr && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", text.c_str());
  }
}

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }
inline int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

// --- markers ---------------------------------------------------------------------------

enum : uint32_t {
  SOC = 0xFF4F, CAP = 0xFF50, SIZ = 0xFF51, COD = 0xFF52, COC = 0xFF53, TLM = 0xFF55,
  PLM = 0xFF57, PLT = 0xFF58, CPF = 0xFF59, QCD = 0xFF5C, QCC = 0xFF5D, RGN = 0xFF5E,
  POC = 0xFF5F, PPM = 0xFF60, PPT = 0xFF61, CRG = 0xFF63, COM = 0xFF64, MCT = 0xFF74,
  MCC = 0xFF75, MCO = 0xFF77, CBD = 0xFF78, SOT = 0xFF90, SOP = 0xFF91, EPH = 0xFF92,
  SOD = 0xFF93, EOC = 0xFFD9,
};

// OpenJPEG's decoder states, and where each marker may stand
enum : uint32_t {
  ST_MHSIZ = 0x2, ST_MH = 0x4, ST_TPHSOT = 0x8, ST_TPH = 0x10, ST_NEOC = 0x40, ST_EOC = 0x100,
};

struct MarkerInfo {
  uint32_t states;
  bool known;  // has a handler (the unknown entry has none)
};

MarkerInfo marker_info(uint32_t id) {
  switch (id) {
    case SOT: return {ST_MH | ST_TPHSOT, true};
    case COD: case COC: case RGN: case QCD: case QCC: case POC: case COM:
    case MCT: case MCC: case MCO:
      return {ST_MH | ST_TPH, true};
    case SIZ: return {ST_MHSIZ, true};
    case TLM: case PLM: case PPM: case CRG: case CBD: case CAP: case CPF:
      return {ST_MH, true};
    case PLT: case PPT: return {ST_TPH, true};
    case SOP: return {0, false};
    default: return {ST_MH | ST_TPH, false};  // unknown
  }
}

// --- coding parameters -----------------------------------------------------------------

constexpr int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;

struct StepSize {
  int expn = 0, mant = 0;
};

struct TCCP {
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int prcw[kMaxRes] = {}, prch[kMaxRes] = {};
  int qntsty = 0, numgbits = 0, roishift = 0;
  StepSize steps[kMaxBands];
};

struct PocEntry {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

// coding parameters: the main header's, or a tile's own
struct TCP {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  bool cod = false, has_poc = false;
  std::vector<TCCP> tccps;
  std::vector<PocEntry> pocs;
};

// a tile as its tile-parts are read; it exists once a SOT names it, and has
// parameters of its own once its headers change the main header's
struct Tile {
  int current_part = -1, nb_parts = 0;
  bool has_data = false;
  std::vector<uint8_t> data;
  std::vector<std::vector<uint8_t>> ppt_markers;  // by Zppt
  bool ppt = false;
  std::unique_ptr<TCP> own;
};

struct Comp {
  int dx = 1, dy = 1, prec = 8, sgnd = 0;
  int64_t x0 = 0, y0 = 0, w = 0, h = 0;  // the image component's grid
};

// --- bit readers -----------------------------------------------------------------------

// Packet headers: bits most significant first, a byte after 0xFF holding 7
// bits; past the end, zeros (opj_bio).
struct BitIn {
  const uint8_t* p;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  BitIn(const uint8_t* data, size_t len) : p(data), start(data), end(data + len) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (p < end) buf |= *p++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return static_cast<size_t>(p - start); }
};

// The MQ decoder (T.800 C.3) with OpenJPEG's handling of a segment's end: a
// synthetic 0xFF 0xFF after the last byte, read as a marker (ones).
struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
constexpr int CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19;

struct Mq {
  const uint8_t* bp;
  const uint8_t* end;  // the two synthetic 0xFF bytes start here
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NCTX];
  uint8_t mps[NCTX];

  void reset_contexts() {
    for (int i = 0; i < NCTX; ++i) state[i] = 0, mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  uint8_t at(const uint8_t* q) const { return q < end ? *q : 0xFF; }
  void bytein() {
    const uint32_t next = at(bp + 1);
    if (at(bp) == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t len) {
    bp = data;
    end = data + len;
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {  // the LPS interval is the larger: MPS
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {  // the MPS interval is the smaller: LPS
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // raw (bypass) segments
  void raw_init(const uint8_t* data, size_t len) {
    bp = data;
    end = data + len;
    c = 0;
    ct = 0;
  }
  int raw_decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (at(bp) > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = at(bp);
          ++bp;
          ct = 7;
        }
      } else {
        c = at(bp);
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// --- tile structure --------------------------------------------------------------------

struct Segment {
  int maxpasses = 0, numpasses = 0, numnewpasses = 0;
  uint32_t len = 0, newlen = 0;
};

struct CodeBlock {
  int64_t x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  int numsegs = 0;
  int mb = 0;       // the band's bit-planes, from the block's first inclusion
  int nchunks = 0;  // the contributions its segments were joined from
  size_t chunk0 = 0;  // the first one's offset in the tile's data
  std::vector<Segment> segs;
  std::vector<uint8_t> data;  // the segments' bytes, joined
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;  // the leaves (cw x ch) first, then each level up
  void build(int cw, int ch) {
    nodes.clear();
    if (cw == 0 || ch == 0) return;
    std::vector<std::pair<int, int>> levels;  // (w, h) per level
    int lw = cw, lh = ch;
    while (true) {
      levels.push_back({lw, lh});
      if (lw * lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    int total = 0;
    for (auto& l : levels) total += l.first * l.second;
    nodes.assign(total, Node{-1, 999, 0});
    int off = 0;
    for (size_t k = 0; k + 1 < levels.size(); ++k) {
      const int w0 = levels[k].first, h0 = levels[k].second;
      const int next = off + w0 * h0, w1 = levels[k + 1].first;
      for (int j = 0; j < h0; ++j)
        for (int i = 0; i < w0; ++i) nodes[off + j * w0 + i].parent = next + (j / 2) * w1 + i / 2;
      off = next;
    }
  }
  bool decode(BitIn& bio, int leaf, int threshold) {
    int stack[64];
    int sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stack[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    while (true) {
      Node& n = nodes[node];
      if (low > n.low) n.low = low; else low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.bit()) n.value = low; else ++low;
      }
      n.low = low;
      if (sp == 0) break;
      node = stack[--sp];
    }
    return nodes[node].value < threshold;
  }
};

struct Precinct {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<CodeBlock> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int64_t x0, y0, x1, y1;
  int numbps = 0;
  float stepsize = 0.f;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pw = 0, ph = 0, pdx = 15, pdy = 15;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres = 0;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

// --- tier 1 ----------------------------------------------------------------------------

enum : uint8_t { F_SIG = 1, F_NEG = 2, F_PI = 4, F_MU = 8 };

// zero-coding context (T.800 Table D.1) from the counts of significant
// horizontal (h), vertical (v) and diagonal (d) neighbours
int zc_context(int orient, int h, int v, int d) {
  if (orient == 1) std::swap(h, v);  // HL: vertical neighbours lead
  if (orient == 3) {
    const int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
    return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
  }
  if (h == 2) return 8;
  if (h == 1) return v ? 7 : d ? 6 : 5;
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d == 1 ? 1 : 0;
}

// the neighbour counts packed in a byte: h in bits 0-1, v in 2-3, d in 4-6
constexpr uint8_t NB_H = 1, NB_V = 4, NB_D = 16;

struct ZcTable {
  uint8_t ctx[4][128];
  ZcTable() {
    for (int o = 0; o < 4; ++o)
      for (int n = 0; n < 128; ++n) ctx[o][n] = zc_context(o, n & 3, (n >> 2) & 3, n >> 4);
  }
};

const ZcTable& zc_table() {
  static const ZcTable table;
  return table;
}

struct T1 {
  int w = 0, h = 0, stride = 0;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;  // with a border of one sample
  std::vector<uint8_t> nb;     // significant neighbours, counted (NB_*)
  Mq mq;
  bool vsc = false;
  int orient = 0;
  const uint8_t* zc = nullptr;

  uint8_t& f(int x, int y) { return flags[(y + 1) * stride + x + 1]; }

  // marks (x, y) significant and counts it in its neighbours'; VSC hides a
  // stripe's first row from the row above it (that row's south neighbours)
  void set_significant(int x, int y, bool neg) {
    const int i = (y + 1) * stride + x + 1;
    flags[i] |= F_SIG | (neg ? F_NEG : 0);
    nb[i - 1] += NB_H;
    nb[i + 1] += NB_H;
    nb[i + stride] += NB_V;
    nb[i + stride - 1] += NB_D;
    nb[i + stride + 1] += NB_D;
    if (!(vsc && (y & 3) == 0)) {
      nb[i - stride] += NB_V;
      nb[i - stride - 1] += NB_D;
      nb[i - stride + 1] += NB_D;
    }
  }
  int contribution(int x, int y) {
    const uint8_t v = f(x, y);
    return (v & F_SIG) ? ((v & F_NEG) ? -1 : 1) : 0;
  }
  // sign context (T.800 Table D.3) and the bit it is XORed with
  int sc_ctx(int x, int y, int& xorbit) {
    const bool south = !(vsc && (y & 3) == 3);
    int hc = contribution(x - 1, y) + contribution(x + 1, y);
    int vc = contribution(x, y - 1) + (south ? contribution(x, y + 1) : 0);
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    if (hc < 0 || (hc == 0 && vc < 0)) {
      hc = -hc;
      vc = -vc;
      xorbit = 1;
    } else {
      xorbit = 0;
    }
    if (hc == 1) return CTX_SC + (vc == 1 ? 4 : vc == 0 ? 3 : 2);
    return CTX_SC + (vc == 1 ? 1 : 0);
  }
  void decode_sign(int x, int y, int32_t oneplushalf, bool raw) {
    int v;
    if (raw) {
      v = mq.raw_decode();
    } else {
      int xorbit;
      const int cx = sc_ctx(x, y, xorbit);
      v = mq.decode(cx) ^ xorbit;
    }
    data[y * w + x] = v ? -oneplushalf : oneplushalf;
    set_significant(x, y, v != 0);
  }

  // The passes scan stripes of four rows, column by column, each column
  // top to bottom (T.800 D.3); i is a sample's index in flags and nb.
  void sigpass(int bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    uint8_t* const fl = flags.data();
    const uint8_t* const cnt = nb.data();
    for (int k = 0; k < h; k += 4) {
      const int rows = std::min(4, h - k);
      for (int x = 0; x < w; ++x) {
        size_t i = static_cast<size_t>(k + 1) * stride + x + 1;
        for (int j = 0; j < rows; ++j, i += stride) {
          if ((fl[i] & (F_SIG | F_PI)) || cnt[i] == 0) continue;
          const int v = raw ? mq.raw_decode() : mq.decode(CTX_ZC + zc[cnt[i]]);
          if (v) decode_sign(x, k + j, oneplushalf, raw);
          fl[i] |= F_PI;
        }
      }
    }
  }
  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    uint8_t* const fl = flags.data();
    const uint8_t* const cnt = nb.data();
    for (int k = 0; k < h; k += 4) {
      const int rows = std::min(4, h - k);
      for (int x = 0; x < w; ++x) {
        size_t i = static_cast<size_t>(k + 1) * stride + x + 1;
        for (int j = 0; j < rows; ++j, i += stride) {
          if ((fl[i] & (F_SIG | F_PI)) != F_SIG) continue;
          int v;
          if (raw) {
            v = mq.raw_decode();
          } else {
            v = mq.decode((fl[i] & F_MU) ? CTX_MAG + 2 : cnt[i] ? CTX_MAG + 1 : CTX_MAG);
          }
          int32_t& d = data[static_cast<size_t>(k + j) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          fl[i] |= F_MU;
        }
      }
    }
  }
  void clnpass(int bpno, bool segsym) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    uint8_t* const fl = flags.data();
    const uint8_t* const cnt = nb.data();
    for (int k = 0; k < h; k += 4) {
      const int rows = std::min(4, h - k);
      for (int x = 0; x < w; ++x) {
        const size_t i0 = static_cast<size_t>(k + 1) * stride + x + 1;
        int j = 0;
        if (rows == 4) {  // run mode: four samples uncoded and without context
          bool run = true;
          for (int r = 0; r < 4 && run; ++r) {
            const size_t i = i0 + r * stride;
            run = !(fl[i] & (F_SIG | F_PI)) && cnt[i] == 0;
          }
          if (run) {
            if (!mq.decode(CTX_AGG)) continue;  // none of the four turns significant
            int runlen = mq.decode(CTX_UNI);
            runlen = (runlen << 1) | mq.decode(CTX_UNI);
            j = runlen;
            decode_sign(x, k + j, oneplushalf, false);
            ++j;
          }
        }
        for (; j < rows; ++j) {
          const size_t i = i0 + j * stride;
          if (fl[i] & (F_SIG | F_PI)) continue;
          if (mq.decode(CTX_ZC + zc[cnt[i]])) decode_sign(x, k + j, oneplushalf, false);
        }
        for (int r = 0; r < rows; ++r) fl[i0 + r * stride] &= ~F_PI;
      }
    }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }
  }

  // decodes a code-block into data (half units); false where OpenJPEG fails it
  bool decode(CodeBlock& cb, int orient_, int roishift, int cblksty) {
    w = static_cast<int>(cb.x1 - cb.x0);
    h = static_cast<int>(cb.y1 - cb.y0);
    stride = w + 2;
    orient = orient_;
    vsc = cblksty & 0x08;
    zc = zc_table().ctx[orient];
    data.assign(static_cast<size_t>(w) * h, 0);
    flags.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
    nb.assign(flags.size(), 0);
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31) return false;
    if (cb.numsegs == 0) return true;  // never included
    int passtype = 2;
    mq.reset_contexts();
    size_t offset = 0;
    for (int s = 0; s < cb.numsegs; ++s) {
      const Segment& seg = cb.segs[s];
      const bool raw = (bpno_plus_one <= cb.numbps - 4) && passtype < 2 && (cblksty & 0x01);
      const uint8_t* p = cb.data.data() + offset;
      if (raw) mq.raw_init(p, seg.len); else mq.init(p, seg.len);
      offset += seg.len;
      for (int pass = 0; pass < seg.numpasses && bpno_plus_one >= 1; ++pass) {
        if (passtype == 0) sigpass(bpno_plus_one, raw);
        else if (passtype == 1) refpass(bpno_plus_one, raw);
        else clnpass(bpno_plus_one, cblksty & 0x20);
        if ((cblksty & 0x02) && !raw) mq.reset_contexts();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    return true;
  }
};

// --- HTJ2K (T.814) code-blocks ---------------------------------------------------------
//
// The HT block decoder, as OpenJPEG 2.5's ht_dec.c decodes (itself after
// OpenJPH): the cleanup pass (MEL, the two VLC tables, UVLC, MagSgn), then
// SigProp and MagRef one bit-plane below, into the same half-unit samples
// the Part 1 path leaves (sign in bit 31 until the end).  Each stream reader
// reads only inside its segment and feeds the fill byte past it.  OpenJPEG
// starts a reader by reading single bytes up to an address that is a
// multiple of 4; that changes no bit read, but the MEL's first reads also
// test the byte after a 0xFF, so `align` carries the address's low bits:
// the block's offset in the tile's data, where OpenJPEG reads a block of one
// contribution in place, or 0 for the aligned copy it joins more into.

#include "ht_tables.inc"

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

inline uint32_t popcount32(uint32_t v) { return static_cast<uint32_t>(__builtin_popcount(v)); }
inline uint32_t bitlen32(uint32_t v) {
  return v ? 32u - static_cast<uint32_t>(__builtin_clz(v)) : 0u;
}

// MEL: runs of events, decoded ahead (at most 8), 7 bits a run: bit 0 set
// where the run ends in a 1 event, the rest twice its zero events (less one
// where it does not end in a 1)
struct HtMel {
  const uint8_t* data;
  uint64_t tmp = 0;
  int bits = 0, size = 0, k = 0, num_runs = 0;
  bool unstuff = false;
  uint64_t runs = 0;

  bool init(const uint8_t* bbuf, int lcup, int scup, uintptr_t align) {
    data = bbuf + lcup - scup;
    size = scup - 1;
    const int num = 4 - static_cast<int>((align + lcup - scup) & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && data[0] > 0x8F) return false;
      uint64_t d = size > 0 ? *data : 0xFF;
      if (size == 1) d |= 0xF;  // MEL and VLC may share the last byte
      data += size-- > 0;
      const int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xFF) == 0xFF;
    }
    tmp <<= (64 - bits);
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xFFFFFFFFu;
    if (size > 4) {
      val = read_le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      uint32_t v = *data++;
      v |= 0xF;
      const uint32_t m = ~(0xFFu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - unstuff;
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 8) & 0xFF;
    u = ((val >> 8) & 0xFF) == 0xFF;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 16) & 0xFF;
    u = ((val >> 16) & 0xFF) == 0xFF;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 24) & 0xFF;
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= static_cast<uint64_t>(t) << (64 - nbits - bits);
    bits += nbits;
  }
  void decode() {
    static const int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = kExp[k];
      int run;
      if (tmp & (uint64_t(1) << 63)) {
        run = ((1 << eval) - 1) << 1;
        k = k + 1 < 12 ? k + 1 : 12;
        tmp <<= 1;
        bits -= 1;
      } else {
        run = static_cast<int>(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = k - 1 > 0 ? k - 1 : 0;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;
      }
      eval = num_runs * 7;
      runs &= ~(uint64_t(0x3F) << eval);
      runs |= static_cast<uint64_t>(run) << eval;
      ++num_runs;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    const int t = static_cast<int>(runs & 0x7F);
    runs >>= 7;
    --num_runs;
    return t;
  }
};

// a stream read backward (VLC, and MagRef with `mrp`): a byte after one
// above 0x8F whose low 7 bits are all 1 gives 7 bits; past the start, zeros
struct HtRev {
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  int size = 0;
  bool unstuff = false;

  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = read_le32(data - 3);
      data -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        const uint32_t v = *data--;
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nbits = 8u - ((unstuff && (((val >> 24) & 0x7F) == 0x7F)) ? 1u : 0u);
    bool u = (val >> 24) > 0x8F;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - ((u && (((val >> 16) & 0x7F) == 0x7F)) ? 1u : 0u);
    u = ((val >> 16) & 0xFF) > 0x8F;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - ((u && (((val >> 8) & 0x7F) == 0x7F)) ? 1u : 0u);
    u = ((val >> 8) & 0xFF) > 0x8F;
    t |= (val & 0xFF) << nbits;
    nbits += 8u - ((u && ((val & 0x7F) == 0x7F)) ? 1u : 0u);
    u = (val & 0xFF) > 0x8F;
    tmp |= static_cast<uint64_t>(t) << bits;
    bits += nbits;
    unstuff = u;
  }
  // the VLC: from the byte before Scup's last one, skipping Scup's low 4 bits
  void init_vlc(const uint8_t* buf, int lcup, int scup, uintptr_t align) {
    data = buf + lcup - 2;
    size = scup - 2;
    const uint32_t d = *data--;
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (d | 0xF) > 0x8F;
    const int num = 1 + static_cast<int>((align + lcup - 3) & 3);
    const int tnum = num < size ? num : size;
    for (int i = 0; i < tnum; ++i) {
      const uint64_t b = *data--;
      const uint32_t d_bits = 8u - ((unstuff && ((b & 0x7F) == 0x7F)) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8F;
    }
    size -= tnum;
    read();
  }
  // the MagRef: from the refinement segment's last byte
  void init_mrp(const uint8_t* buf, int lcup, int len2, uintptr_t align) {
    data = buf + lcup + len2 - 1;
    size = len2;
    unstuff = true;
    const int num = 1 + static_cast<int>((align + lcup + len2 - 1) & 3);
    for (int i = 0; i < num; ++i) {
      const uint64_t b = (size-- > 0) ? *data-- : 0;
      const uint32_t d_bits = 8u - ((unstuff && ((b & 0x7F) == 0x7F)) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8F;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return static_cast<uint32_t>(tmp);
  }
};

// a stream read forward (MagSgn past its end reads 1s, SigProp 0s): a byte
// after 0xFF gives 7 bits
struct HtFwd {
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  bool unstuff = false;
  int size = 0;
  uint32_t X = 0;

  void read() {
    uint32_t val;
    if (size > 3) {
      val = read_le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = X != 0 ? 0xFFFFFFFFu : 0;
      while (size > 0) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = X != 0 ? 0xFFFFFFFFu : 0;
    }
    uint32_t nbits = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= static_cast<uint64_t>(t) << bits;
    bits += nbits;
  }
  void init(const uint8_t* d, int n, uint32_t fill, uintptr_t align) {
    data = d;
    size = n;
    X = fill;
    const int num = 4 - static_cast<int>(align & 3);
    for (int i = 0; i < num; ++i) {
      const uint64_t b = size-- > 0 ? *data++ : X;
      tmp |= b << bits;
      bits += 8u - (unstuff ? 1u : 0u);
      unstuff = (b & 0xFF) == 0xFF;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// UVLC (T.814 7.3.6): u + 1 of each quad of a pair from the VLC's head
// (a prefix 1, 01, 001 or 000, a suffix of 0, 0, 1 or 5 bits); `initial`
// the first line pair, whose mode 4 (both u_off and a MEL 1) adds 2 to each
// and whose mode 3 after a long first prefix codes the second in one bit
inline uint32_t ht_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u, bool initial) {
  static const uint8_t dec[8] = {
      3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
      1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};
  uint32_t consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = dec[vlc & 0x7];
    vlc >>= d & 0x3;
    consumed += d & 0x3;
    const uint32_t suffix_len = (d >> 2) & 0x7;
    consumed += suffix_len;
    d = (d >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[0] = (mode == 1) ? d + 1 : 1;
    u[1] = (mode == 1) ? 1 : d + 1;
  } else if (mode == 3 && initial) {
    uint32_t d1 = dec[vlc & 0x7];
    vlc >>= d1 & 0x3;
    consumed += d1 & 0x3;
    if ((d1 & 0x3) > 2) {
      u[1] = (vlc & 1) + 1 + 1;
      ++consumed;
      vlc >>= 1;
      const uint32_t suffix_len = (d1 >> 2) & 0x7;
      consumed += suffix_len;
      d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[0] = d1 + 1;
    } else {
      uint32_t d2 = dec[vlc & 0x7];
      vlc >>= d2 & 0x3;
      consumed += d2 & 0x3;
      uint32_t suffix_len = (d1 >> 2) & 0x7;
      consumed += suffix_len;
      d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[0] = d1 + 1;
      vlc >>= suffix_len;
      suffix_len = (d2 >> 2) & 0x7;
      consumed += suffix_len;
      d2 = (d2 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[1] = d2 + 1;
    }
  } else if (mode == 3 || mode == 4) {
    uint32_t d1 = dec[vlc & 0x7];
    vlc >>= d1 & 0x3;
    consumed += d1 & 0x3;
    uint32_t d2 = dec[vlc & 0x7];
    vlc >>= d2 & 0x3;
    consumed += d2 & 0x3;
    uint32_t suffix_len = (d1 >> 2) & 0x7;
    consumed += suffix_len;
    d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
    vlc >>= suffix_len;
    suffix_len = (d2 >> 2) & 0x7;
    consumed += suffix_len;
    d2 = (d2 >> 5) + (vlc & ((1U << suffix_len) - 1));
    const uint32_t add = mode == 4 ? 3 : 1;
    u[0] = d1 + add;
    u[1] = d2 + add;
  }
  return consumed;
}

struct HtBlock {
  std::vector<uint32_t> data;  // w x h, the sign in bit 31
  uint32_t flags[132 * 4 + 132];  // sigma1, sigma2, mbr1, mbr2, line state
  int w = 0, h = 0;

  // one MagSgn sample: the value of sample `n` (of quad info `qinf`, U_q `uq`)
  static uint32_t magsgn(HtFwd& ms, uint32_t qinf, uint32_t uq, int n, uint32_t p,
                         uint32_t* vn_out) {
    const uint32_t ms_val = ms.fetch();
    const uint32_t m_n = uq - ((qinf >> (12 + n)) & 1);
    ms.advance(m_n);
    const uint32_t val = ms_val << 31;
    uint32_t v_n = ms_val & ((1U << m_n) - 1);
    v_n |= ((qinf >> (8 + n)) & 1) << m_n;
    v_n |= 1;
    *vn_out = v_n;
    return val | ((v_n + 2) << (p - 1));
  }

  // Decodes `cb` (its segments joined in cb.data) into `data`; the message of
  // OpenJPEG's failure where it fails, else empty.  Its checks, in its order:
  // a zero-length refinement segment drops the refinement passes, a block
  // whose zero bit-planes are all its bit-planes keeps only the cleanup.
  std::string decode(const CodeBlock& cb, int roishift, int cblksty) {
    if (roishift != 0) return "HT code-blocks under a region of interest";
    w = static_cast<int>(cb.x1 - cb.x0);
    h = static_cast<int>(cb.y1 - cb.y0);
    data.assign(static_cast<size_t>(w) * h, 0);
    std::fill(std::begin(flags), std::end(flags), 0u);
    if (cb.mb == 0) return "";
    const uint32_t mb = static_cast<uint32_t>(cb.mb);
    const uint32_t zero_bplanes = (mb + 1) - static_cast<uint32_t>(cb.numbps);
    if (cb.nchunks == 0) return "";
    const uint32_t cblk_len = static_cast<uint32_t>(cb.data.size());
    const uintptr_t align = cb.nchunks == 1 ? cb.chunk0 : 0;
    uint32_t num_passes = cb.numsegs > 0 ? cb.segs[0].numpasses : 0;
    num_passes += cb.numsegs > 1 ? cb.segs[1].numpasses : 0;
    const uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
    uint32_t lengths2 = 0;
    if (num_passes > 1) lengths2 = cb.segs.size() > 1 ? cb.segs[1].len : 0;
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // OpenJPEG warns and goes on
    if (mb > 30) return "an HT code-block of more than 30 bit-planes";
    if (num_passes > 3) return "an HT code-block of more than 3 coding passes";
    if (zero_bplanes > mb) return "an HT code-block of more zero bit-planes than bit-planes";
    if (zero_bplanes == mb && num_passes > 1) num_passes = 1;
    const uint32_t p = static_cast<uint32_t>(cb.numbps);
    const uint32_t zero_bplanes_p1 = zero_bplanes + 1;
    if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
      return "an HT code-block of invalid lengths";
    const uint8_t* coded = cb.data.data();
    const int lcup = static_cast<int>(lengths1);
    const int scup = (static_cast<int>(coded[lcup - 1]) << 4) + (coded[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079) return "an HT code-block's Scup out of range";
    HtMel mel;
    if (!mel.init(coded, lcup, scup, align)) return "an HT code-block's MEL segment";
    HtRev vlc;
    vlc.init_vlc(coded, lcup, scup, align);
    HtFwd magsgn;
    magsgn.init(coded, lcup - scup, 0xFF, align);
    HtFwd sigprop;
    if (num_passes > 1)
      sigprop.init(coded + lengths1, static_cast<int>(lengths2), 0, align + lengths1);
    HtRev magref;
    if (num_passes > 2) magref.init_mrp(coded, lcup, static_cast<int>(lengths2), align);
    const bool stripe_causal = (cblksty & 0x08) != 0;
    const int stride = w;
    uint32_t* const dec = data.data();
    uint32_t* const sigma1 = flags;
    uint32_t* const sigma2 = sigma1 + 132;
    uint32_t* const mbr1 = sigma2 + 132;
    uint32_t* const mbr2 = mbr1 + 132;
    uint8_t* const line_state = reinterpret_cast<uint8_t*>(mbr2 + 132);
    uint32_t* sip = sigma1;
    uint32_t sip_shift = 0;
    uint32_t qinf[2];

    // the first line pair
    uint8_t* lsp = line_state;
    lsp[0] = 0;
    int run = mel.get_run();
    uint32_t c_q = 0;
    uint32_t* sp = dec;
    for (int x = 0; x < w; x += 4) {
      uint32_t U_q[2];
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = kHtVlc0[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = (run == -1) ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
      vlc_val = vlc.advance(qinf[0] & 0x7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
      qinf[1] = 0;
      if (x + 2 < w) {
        qinf[1] = kHtVlc0[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = (run == -1) ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
        vlc_val = vlc.advance(qinf[1] & 0x7);
      }
      *sip |= (((qinf[1] & 0x30)) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
      sip += x & 0x7 ? 1 : 0;
      sip_shift ^= 0x10;
      uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      if (uvlc_mode == 3) {
        run -= 2;
        uvlc_mode += (run == -1) ? 1 : 0;
        if (run < 0) run = mel.get_run();
      }
      const uint32_t consumed = ht_uvlc(vlc_val, uvlc_mode, U_q, true);
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
        return "an HT code-block's U_q past its zero bit-planes + 1";
      vlc_val = vlc.advance(consumed);
      uint32_t locs = 0xFF;
      if (x + 4 > w) locs >>= (x + 4 - w) << 1;
      locs = h > 1 ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
        return "an HT code-block's VLC significant past the block";
      quad_pair(magsgn, qinf, U_q, locs, p, sp, lsp, stride);
      sp += 4;
      lsp += 2;
    }

    // the other line pairs
    for (int y = 2; y < h;) {
      sip_shift ^= 0x2;
      sip_shift &= 0xFFFFFFEFU;
      uint32_t* sipl = y & 0x4 ? sigma2 : sigma1;
      lsp = line_state;
      uint8_t ls0 = lsp[0];
      lsp[0] = 0;
      sp = dec + static_cast<size_t>(y) * stride;
      c_q = 0;
      for (int x = 0; x < w; x += 4) {
        uint32_t U_q[2];
        c_q |= (ls0 >> 7);
        c_q |= (lsp[1] >> 5) & 0x4;
        uint32_t vlc_val = vlc.fetch();
        qinf[0] = kHtVlc1[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[0] = (run == -1) ? qinf[0] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[0] & 0x7);
        *sipl |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
        qinf[1] = 0;
        if (x + 2 < w) {
          c_q |= (lsp[1] >> 7);
          c_q |= (lsp[2] >> 5) & 0x4;
          qinf[1] = kHtVlc1[(c_q << 7) | (vlc_val & 0x7F)];
          if (c_q == 0) {
            run -= 2;
            qinf[1] = (run == -1) ? qinf[1] : 0;
            if (run < 0) run = mel.get_run();
          }
          c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
          vlc_val = vlc.advance(qinf[1] & 0x7);
        }
        *sipl |= (((qinf[1] & 0x30)) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
        sipl += x & 0x7 ? 1 : 0;
        sip_shift ^= 0x10;
        const uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
        const uint32_t consumed = ht_uvlc(vlc_val, uvlc_mode, U_q, false);
        vlc_val = vlc.advance(consumed);
        if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
          uint32_t E = ls0 & 0x7Fu;
          E = E > (lsp[1] & 0x7Fu) ? E : (lsp[1] & 0x7Fu);
          U_q[0] += E > 2 ? E - 2 : 0;
        }
        if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
          uint32_t E = lsp[1] & 0x7Fu;
          E = E > (lsp[2] & 0x7Fu) ? E : (lsp[2] & 0x7Fu);
          U_q[1] += E > 2 ? E - 2 : 0;
        }
        if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
          return "an HT code-block's U_q past its zero bit-planes + 1";
        ls0 = lsp[2];
        lsp[1] = lsp[2] = 0;
        uint32_t locs = 0xFF;
        if (x + 4 > w) locs >>= (x + 4 - w) << 1;
        locs = y + 2 <= h ? locs : (locs & 0x55);
        if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
          return "an HT code-block's VLC significant past the block";
        quad_pair(magsgn, qinf, U_q, locs, p, sp, lsp, stride);
        sp += 4;
        lsp += 2;
      }
      y += 2;
      if (num_passes > 1 && (y & 3) == 0) {
        if (num_passes > 2) magref_stripe(magref, y & 0x4 ? sigma1 : sigma2,
                                          dec + static_cast<size_t>(y - 4) * stride, p);
        if (y >= 4) stripe_mbr(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbr1 : mbr2);
        if (y >= 8) {
          uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
          uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
          uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
          uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
          from_next_stripe(cur_sig, cur_mbr, nxt_sig, stripe_causal);
          sigprop_stripe(sigprop, cur_sig, cur_mbr, nxt_sig, nxt_mbr,
                         dec + static_cast<size_t>(y - 8) * stride, p, 0xFFFFFFFFu);
          std::fill(cur_sig, cur_sig + ((w + 7) >> 3) + 1, 0u);
        }
      }
    }

    // the last stripes
    if (num_passes > 1) {
      if (num_passes > 2 && ((h & 3) == 1 || (h & 3) == 2))
        magref_stripe(magref, h & 0x4 ? sigma2 : sigma1,
                      dec + static_cast<size_t>(h & 0xFFFFFC) * stride, p);
      if ((h & 3) == 1 || (h & 3) == 2)
        stripe_mbr(h & 0x4 ? sigma2 : sigma1, h & 0x4 ? mbr2 : mbr1);
      int st = h;
      st -= h > 6 ? (((h + 1) & 3) + 3) : h;
      for (int y = st; y < h; y += 4) {
        uint32_t pattern = 0xFFFFFFFFu;
        if (h - y == 3) pattern = 0x77777777u;
        else if (h - y == 2) pattern = 0x33333333u;
        else if (h - y == 1) pattern = 0x11111111u;
        uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
        uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
        uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
        if (h - y > 4) from_next_stripe(cur_sig, cur_mbr, nxt_sig, stripe_causal);
        sigprop_stripe(sigprop, cur_sig, cur_mbr, nxt_sig, nxt_mbr,
                       dec + static_cast<size_t>(y) * stride, p, pattern);
      }
    }
    return "";
  }

  // MagSgn of a quad pair of line pair (sp, lsp as the loops hold them);
  // the line state of the row below gets each column's exponent
  static void quad_pair(HtFwd& ms, const uint32_t* qinf, const uint32_t* U_q, uint32_t locs,
                        uint32_t p, uint32_t* sp, uint8_t* lsp, int stride) {
    for (int q = 0; q < 2; ++q) {
      const uint32_t qi = qinf[q];
      const uint32_t l0 = q == 0 ? 0x1 : 0x10;
      uint32_t v_n;
      if (qi & 0x10) sp[0] = magsgn(ms, qi, U_q[q], 0, p, &v_n);
      else if (locs & l0) sp[0] = 0;
      if (qi & 0x20) {
        sp[stride] = magsgn(ms, qi, U_q[q], 1, p, &v_n);
        const uint32_t t = lsp[0] & 0x7F;
        v_n = bitlen32(v_n);
        lsp[0] = static_cast<uint8_t>(0x80 | (t > v_n ? t : v_n));
      } else if (locs & (l0 << 1)) {
        sp[stride] = 0;
      }
      ++lsp;
      ++sp;
      if (qi & 0x40) sp[0] = magsgn(ms, qi, U_q[q], 2, p, &v_n);
      else if (locs & (l0 << 2)) sp[0] = 0;
      lsp[0] = 0;
      if (qi & 0x80) {
        sp[stride] = magsgn(ms, qi, U_q[q], 3, p, &v_n);
        lsp[0] = static_cast<uint8_t>(0x80 | bitlen32(v_n));
      } else if (locs & (l0 << 3)) {
        sp[stride] = 0;
      }
      ++sp;
    }
  }

  void magref_stripe(HtRev& mr, uint32_t* cur_sig, uint32_t* dpp, uint32_t p) {
    const uint32_t half = 1u << ((p - 2) & 31);
    for (int i = 0; i < w; i += 8) {
      uint32_t cwd = mr.fetch();
      const uint32_t sig = *cur_sig++;
      uint32_t col_mask = 0xFu;
      uint32_t* dp = dpp + i;
      if (sig) {
        for (int j = 0; j < 8; ++j, dp++) {
          if (sig & col_mask) {
            uint32_t sample_mask = 0x11111111u & col_mask;
            for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
              if (sig & sample_mask) {
                const uint32_t sym = cwd & 1;
                dp[r * w] ^= (1 - sym) << ((p - 1) & 31);
                dp[r * w] |= half;
                cwd >>= 1;
              }
            }
          }
          col_mask <<= 4;
        }
      }
      mr.advance(popcount32(sig));
    }
  }

  // a stripe's members: the insignificant neighbours of its significant
  // samples within the stripe
  void stripe_mbr(const uint32_t* sig, uint32_t* mbr) {
    uint32_t prev = 0;
    for (int i = 0; i < w; i += 8, mbr++, sig++) {
      mbr[0] = sig[0];
      mbr[0] |= prev >> 28;
      mbr[0] |= sig[0] << 4;
      mbr[0] |= sig[0] >> 4;
      mbr[0] |= sig[1] << 28;
      prev = sig[0];
      const uint32_t t = mbr[0];
      uint32_t z = mbr[0];
      z |= (t & 0x77777777) << 1;
      z |= (t & 0xEEEEEEEE) >> 1;
      mbr[0] = z & ~sig[0];
    }
  }

  // and those of the stripe below's first row (not under stripe-causal mode)
  void from_next_stripe(const uint32_t* cur_sig, uint32_t* cur_mbr, const uint32_t* nxt_sig,
                        bool stripe_causal) {
    uint32_t prev = 0;
    for (int i = 0; i < w; i += 8, cur_mbr++, cur_sig++, nxt_sig++) {
      uint32_t t = nxt_sig[0];
      t |= prev >> 28;
      t |= nxt_sig[0] << 4;
      t |= nxt_sig[0] >> 4;
      t |= nxt_sig[1] << 28;
      prev = nxt_sig[0];
      if (!stripe_causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
      cur_mbr[0] &= ~cur_sig[0];
    }
  }

  void sigprop_stripe(HtFwd& sp_in, uint32_t* cur_sig, uint32_t* cur_mbr, uint32_t* nxt_sig,
                      uint32_t* nxt_mbr, uint32_t* dpp, uint32_t p, uint32_t pattern) {
    const uint32_t val = 3u << ((p - 2) & 31);
    for (int i = 0; i < w; i += 8, cur_sig++, cur_mbr++, nxt_sig++, nxt_mbr++) {
      uint32_t mbr = *cur_mbr & pattern;
      uint32_t new_sig = 0;
      if (mbr) {
        for (int n = 0; n < 8; n += 4) {
          uint32_t cwd = sp_in.fetch();
          uint32_t cnt = 0;
          uint32_t* dp = dpp + i + n;
          uint32_t col_mask = 0xFu << (4 * n);
          const uint32_t inv_sig = ~cur_sig[0] & pattern;
          const int end = n + 4 + i < w ? n + 4 : w - i;
          static const uint32_t kProp[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
          for (int j = n; j < end; ++j, ++dp, col_mask <<= 4) {
            if ((col_mask & mbr) == 0) continue;
            uint32_t sample_mask = 0x11111111u & col_mask;
            for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
              if (mbr & sample_mask) {
                if (cwd & 1) {
                  new_sig |= sample_mask;
                  mbr |= (kProp[r] << (4 * j)) & inv_sig;
                }
                cwd >>= 1;
                ++cnt;
              }
            }
          }
          if (new_sig & (0xFFFFu << (4 * n))) {
            dp = dpp + i + n;
            col_mask = 0xFu << (4 * n);
            for (int j = n; j < end; ++j, ++dp, col_mask <<= 4) {
              if ((col_mask & new_sig) == 0) continue;
              uint32_t sample_mask = 0x11111111u & col_mask;
              for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
                if (new_sig & sample_mask) {
                  dp[r * w] |= ((cwd & 1) << 31) | val;
                  cwd >>= 1;
                  ++cnt;
                }
              }
            }
          }
          sp_in.advance(cnt);
          if (n == 4) {
            uint32_t t = new_sig >> 28;
            t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
            cur_mbr[1] |= t & ~cur_sig[1];
          }
        }
      }
      new_sig |= cur_sig[0];
      const uint32_t ux = (new_sig & 0x88888888) >> 3;
      const uint32_t tx = ux | (ux << 4) | (ux >> 4);
      if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
      nxt_mbr[0] |= tx & ~nxt_sig[0];
      nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
    }
  }
};

// --- the codestream --------------------------------------------------------------------

struct Reader {
  const uint8_t* d;
  size_t n, pos = 0;
  Reader(const uint8_t* data, size_t len) : d(data), n(len) {}
  size_t left() const { return n - pos; }
  bool read(size_t k, const uint8_t*& out) {
    if (left() < k) return false;
    out = d + pos;
    pos += k;
    return true;
  }
  bool u16(uint32_t& v) {
    const uint8_t* p;
    if (!read(2, p)) return false;
    v = (p[0] << 8) | p[1];
    return true;
  }
};

struct Seg {  // a marker segment's body
  const uint8_t* p;
  size_t n, pos = 0;
  uint32_t u(int bytes) {
    if (pos + bytes > n) damaged("marker segment too short");
    uint32_t v = 0;
    for (int i = 0; i < bytes; ++i) v = (v << 8) | p[pos++];
    return v;
  }
  size_t left() const { return n - pos; }
};

struct Decoder {
  const uint8_t* src;
  size_t n;
  // image
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int64_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  int tw = 0, th = 0, numcomps = 0;
  std::vector<Comp> comps;
  TCP deflt;
  std::map<int, Tile> tiles;  // by index, as SOT markers name them
  std::vector<std::vector<uint8_t>> ppm_markers;
  bool ppm = false;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
  uint32_t state = 0;
  int current_tile = 0;
  uint32_t sot_length = 0;
  bool last_tile_part = false, can_decode = false, parts_checked = false;
  int parts_correction = 0;
  bool has_siz = false, has_cod = false, has_qcd = false;
  // output planes
  std::vector<std::vector<int32_t>> planes;
  bool any_tile = false;
  const uint8_t* tile_data = nullptr;  // the tile whose packets are read

  Decoder(const uint8_t* d, size_t len) : src(d), n(len) {}

  const TCP& params(const Tile& t) const { return t.own ? *t.own : deflt; }

  TCP& cur_tcp() {
    if (!(state & ST_TPH)) return deflt;
    Tile& t = tiles[current_tile];
    if (!t.own) {
      t.own.reset(new TCP(deflt));
      t.own->cod = false;
    }
    return *t.own;
  }

  // --- marker segment handlers ---
  void read_siz(Seg s) {
    if (s.n < 36 || (s.n - 36) % 3 != 0) damaged("SIZ marker size");
    s.u(2);  // Rsiz: capabilities, not read
    x1 = s.u(4); y1 = s.u(4); x0 = s.u(4); y0 = s.u(4);
    tdx = s.u(4); tdy = s.u(4); tx0 = s.u(4); ty0 = s.u(4);
    const uint32_t csiz = s.u(2);
    if (csiz >= 16385) damaged("SIZ: illegal number of components");
    if (csiz != (s.n - 36) / 3) damaged("SIZ: number of components vs parameters");
    numcomps = static_cast<int>(csiz);
    if (x0 >= x1 || y0 >= y1) damaged("SIZ: negative or zero image size");
    if (tdx == 0 || tdy == 0) damaged("SIZ: invalid tile size");
    const int64_t tx1 = std::min<int64_t>(tx0 + tdx, 0xFFFFFFFFLL);
    const int64_t ty1 = std::min<int64_t>(ty0 + tdy, 0xFFFFFFFFLL);
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) damaged("SIZ: illegal tile offset");
    comps.assign(numcomps, Comp());
    for (auto& c : comps) {
      const uint32_t ssiz = s.u(1);
      c.prec = (ssiz & 0x7F) + 1;
      c.sgnd = ssiz >> 7;
      c.dx = static_cast<int>(s.u(1));
      c.dy = static_cast<int>(s.u(1));
      if (c.dx < 1 || c.dy < 1) damaged("SIZ: invalid component subsampling");
      if (c.prec > 31) damaged("SIZ: component precision over 31");
    }
    tw = static_cast<int>(ceildiv(x1 - tx0, tdx));
    th = static_cast<int>(ceildiv(y1 - ty0, tdy));
    if (tw == 0 || th == 0 || tw > 65535 / th) damaged("SIZ: invalid number of tiles");
    // the image components (opj_image_comp_header_update)
    const int64_t lx1 = std::min<int64_t>(tx0 + (tw - 1) * tdx + tdx, x1);
    const int64_t ly1 = std::min<int64_t>(ty0 + (th - 1) * tdy + tdy, y1);
    const int64_t lx0 = std::max(tx0, x0), ly0 = std::max(ty0, y0);
    for (auto& c : comps) {
      c.x0 = ceildiv(lx0, c.dx);
      c.y0 = ceildiv(ly0, c.dy);
      c.w = ceildiv(lx1, c.dx) - c.x0;
      c.h = ceildiv(ly1, c.dy) - c.y0;
    }
    deflt.tccps.assign(numcomps, TCCP());
    state = ST_MH;
  }

  void read_spcod(Seg& s, TCCP& t) {
    if (s.left() < 5) damaged("SPCod/SPCoc element");
    t.numres = static_cast<int>(s.u(1)) + 1;
    if (t.numres > kMaxRes) damaged("too many resolutions");
    t.cblkw = static_cast<int>(s.u(1)) + 2;
    t.cblkh = static_cast<int>(s.u(1)) + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) damaged("invalid code-block size");
    t.cblksty = static_cast<int>(s.u(1));
    if (t.cblksty & 0x80) damaged("mixed HT code-block style");
    t.qmfbid = static_cast<int>(s.u(1));
    if (t.qmfbid > 1) damaged("invalid wavelet transform");
    if (t.csty & 1) {
      if (s.left() < static_cast<size_t>(t.numres)) damaged("SPCod/SPCoc precinct sizes");
      for (int i = 0; i < t.numres; ++i) {
        const uint32_t v = s.u(1);
        if (i != 0 && ((v & 0xF) == 0 || (v >> 4) == 0)) damaged("invalid precinct size");
        t.prcw[i] = v & 0xF;
        t.prch[i] = v >> 4;
      }
    } else {
      for (int i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
  }

  void read_cod(Seg s) {
    TCP& tcp = cur_tcp();
    if (tcp.cod) damaged("a second COD marker");
    tcp.cod = true;
    if (s.n < 5) damaged("COD marker size");
    tcp.csty = static_cast<int>(s.u(1));
    if (tcp.csty & ~7) damaged("unknown Scod value");
    tcp.prg = static_cast<int>(s.u(1));
    if (tcp.prg > 4) tcp.prg = -1;  // unknown: the tile then fails
    tcp.numlayers = static_cast<int>(s.u(2));
    if (tcp.numlayers < 1) damaged("invalid number of layers");
    tcp.mct = static_cast<int>(s.u(1));
    if (tcp.mct > 1) damaged("invalid multiple component transformation");
    for (auto& t : tcp.tccps) t.csty = tcp.csty & 1;
    read_spcod(s, tcp.tccps[0]);
    if (s.left() != 0) damaged("COD marker size");
    for (int c = 1; c < numcomps; ++c) {
      TCCP& t = tcp.tccps[c];
      const TCCP& r = tcp.tccps[0];
      t.numres = r.numres;
      t.cblkw = r.cblkw;
      t.cblkh = r.cblkh;
      t.cblksty = r.cblksty;
      t.qmfbid = r.qmfbid;
      std::copy(r.prcw, r.prcw + kMaxRes, t.prcw);
      std::copy(r.prch, r.prch + kMaxRes, t.prch);
    }
  }

  void read_coc(Seg s) {
    TCP& tcp = cur_tcp();
    const int room = numcomps <= 256 ? 1 : 2;
    if (s.n < static_cast<size_t>(room + 1)) damaged("COC marker size");
    const uint32_t c = s.u(room);
    if (static_cast<int>(c) >= numcomps) damaged("COC component number");
    tcp.tccps[c].csty = static_cast<int>(s.u(1));
    read_spcod(s, tcp.tccps[c]);
    if (s.left() != 0) damaged("COC marker size");
  }

  void read_sqcd(Seg& s, TCCP& t) {
    if (s.left() < 1) damaged("SQcd/SQcc element");
    const uint32_t v = s.u(1);
    t.qntsty = v & 0x1F;
    t.numgbits = v >> 5;
    size_t nbands;
    if (t.qntsty == 1) nbands = 1;
    else nbands = t.qntsty == 0 ? s.left() : s.left() / 2;
    if (t.qntsty == 0) {
      for (size_t b = 0; b < nbands; ++b) {
        const uint32_t e = s.u(1);
        if (b < static_cast<size_t>(kMaxBands)) t.steps[b] = StepSize{static_cast<int>(e >> 3), 0};
      }
    } else {
      for (size_t b = 0; b < nbands; ++b) {
        const uint32_t e = s.u(2);
        if (b < static_cast<size_t>(kMaxBands))
          t.steps[b] = StepSize{static_cast<int>(e >> 11), static_cast<int>(e & 0x7FF)};
      }
    }
    if (t.qntsty == 1) {
      for (int b = 1; b < kMaxBands; ++b) {
        const int e = t.steps[0].expn - (b - 1) / 3;
        t.steps[b] = StepSize{e > 0 ? e : 0, t.steps[0].mant};
      }
    }
  }

  void read_qcd(Seg s) {
    TCP& tcp = cur_tcp();
    read_sqcd(s, tcp.tccps[0]);
    if (s.left() != 0) damaged("QCD marker size");
    for (int c = 1; c < numcomps; ++c) {
      TCCP& t = tcp.tccps[c];
      t.qntsty = tcp.tccps[0].qntsty;
      t.numgbits = tcp.tccps[0].numgbits;
      std::copy(tcp.tccps[0].steps, tcp.tccps[0].steps + kMaxBands, t.steps);
    }
  }

  void read_qcc(Seg s) {
    TCP& tcp = cur_tcp();
    const int room = numcomps <= 256 ? 1 : 2;
    if (s.n < static_cast<size_t>(room)) damaged("QCC marker size");
    const uint32_t c = s.u(room);
    if (static_cast<int>(c) >= numcomps) damaged("QCC component number");
    read_sqcd(s, tcp.tccps[c]);
    if (s.left() != 0) damaged("QCC marker size");
  }

  void read_rgn(Seg s) {
    TCP& tcp = cur_tcp();
    const int room = numcomps <= 256 ? 1 : 2;
    if (s.n != static_cast<size_t>(2 + room)) damaged("RGN marker size");
    const uint32_t c = s.u(room);
    s.u(1);  // Srgn
    if (static_cast<int>(c) >= numcomps) damaged("RGN component number");
    tcp.tccps[c].roishift = static_cast<int>(s.u(1));
  }

  void read_poc(Seg s) {
    TCP& tcp = cur_tcp();
    const int room = numcomps <= 256 ? 1 : 2;
    const size_t chunk = 5 + 2 * room;
    const size_t count = s.n / chunk;
    if (count == 0 || s.n % chunk != 0) damaged("POC marker size");
    const size_t old = tcp.has_poc ? tcp.pocs.size() : 0;
    if (old + count >= 32) damaged("too many POCs");
    tcp.has_poc = true;
    for (size_t i = 0; i < count; ++i) {
      PocEntry p;
      p.resno0 = static_cast<int>(s.u(1));
      p.compno0 = static_cast<int>(s.u(room));
      p.layno1 = static_cast<int>(s.u(2));
      p.resno1 = static_cast<int>(s.u(1));
      p.compno1 = std::min(static_cast<int>(s.u(room)), numcomps);
      p.prg = static_cast<int>(s.u(1));
      tcp.pocs.push_back(p);
    }
  }

  void read_ppm(Seg s) {
    if (s.n < 2) damaged("PPM marker size");
    ppm = true;
    const uint32_t z = s.u(1);
    if (ppm_markers.size() <= z) ppm_markers.resize(z + 1);
    if (!ppm_markers[z].empty()) damaged("a PPM Zppm read twice");
    ppm_markers[z].assign(s.p + 1, s.p + s.n);
  }

  void merge_ppm() {
    if (!ppm) return;
    uint32_t remaining = 0;
    for (auto& m : ppm_markers) {
      size_t i = 0;
      while (i < m.size()) {
        if (remaining > 0) {
          const size_t take = std::min<size_t>(remaining, m.size() - i);
          ppm_data.insert(ppm_data.end(), m.begin() + i, m.begin() + i + take);
          i += take;
          remaining -= static_cast<uint32_t>(take);
          continue;
        }
        if (m.size() - i < 4) damaged("not enough bytes to read Nppm");
        remaining = (m[i] << 24) | (m[i + 1] << 16) | (m[i + 2] << 8) | m[i + 3];
        i += 4;
      }
    }
    if (remaining != 0) damaged("corrupted PPM markers");
  }

  void read_ppt(Seg s) {
    if (s.n < 2) damaged("PPT marker size");
    if (ppm) damaged("PPT after PPM");
    Tile& t = tiles[current_tile];
    t.ppt = true;
    const uint32_t z = s.u(1);
    if (t.ppt_markers.size() <= z) t.ppt_markers.resize(z + 1);
    if (!t.ppt_markers[z].empty()) damaged("a PPT Zppt read twice");
    t.ppt_markers[z].assign(s.p + 1, s.p + s.n);
  }

  void read_tlm(Seg s) {  // only its size is checked: OpenJPEG ignores a bad one
    if (s.n < 2) damaged("TLM marker size");
  }

  void read_plt(Seg s) {
    if (s.n < 1) damaged("PLT marker size");
    s.u(1);
    uint32_t len = 0;
    while (s.left()) {
      const uint32_t v = s.u(1);
      len |= v & 0x7F;
      if (v & 0x80) len <<= 7; else len = 0;
    }
    if (len != 0) damaged("PLT marker");
  }

  void read_sot_values(Seg s, uint32_t& isot, uint32_t& psot, uint32_t& tpsot, uint32_t& tnsot) {
    if (s.n != 8) damaged("SOT marker size");
    isot = s.u(2);
    psot = s.u(4);
    tpsot = s.u(1);
    tnsot = s.u(1);
  }

  void read_sot(Seg s) {
    uint32_t isot, psot, tpsot, tnsot;
    read_sot_values(s, isot, psot, tpsot, tnsot);
    if (isot >= static_cast<uint32_t>(tw * th)) damaged("invalid tile number");
    current_tile = static_cast<int>(isot);
    Tile& tcp = tiles[current_tile];
    if (tcp.current_part + 1 != static_cast<int>(tpsot)) damaged("invalid tile-part index");
    ++tcp.current_part;
    if (psot != 0 && psot < 14) {
      if (psot != 12) damaged("invalid Psot");
    }
    if (psot == 0) last_tile_part = true;
    if (tcp.nb_parts != 0 && static_cast<int>(tpsot) >= tcp.nb_parts) damaged("invalid TPsot");
    if (tnsot != 0) {
      const int parts = static_cast<int>(tnsot) + parts_correction;
      if (tcp.nb_parts && static_cast<int>(tpsot) >= tcp.nb_parts) damaged("invalid TPsot");
      if (static_cast<int>(tpsot) >= parts) damaged("invalid TPsot");
      tcp.nb_parts = parts;
    }
    if (tcp.nb_parts && tcp.nb_parts == static_cast<int>(tpsot) + 1) can_decode = true;
    sot_length = psot - 12;
    state = ST_TPH;
  }

  void handle(uint32_t id, Seg s) {
    switch (id) {
      case SIZ: read_siz(s); break;
      case COD: read_cod(s); break;
      case COC: read_coc(s); break;
      case QCD: read_qcd(s); break;
      case QCC: read_qcc(s); break;
      case RGN: read_rgn(s); break;
      case POC: read_poc(s); break;
      case PPM: read_ppm(s); break;
      case PPT: read_ppt(s); break;
      case TLM: read_tlm(s); break;
      case PLT: read_plt(s); break;
      case PLM: if (s.n < 1) damaged("PLM marker size"); break;
      case CRG: if (s.n != static_cast<size_t>(numcomps) * 4) damaged("CRG marker size"); break;
      // COM; CAP and CPF (OpenJPEG reads nothing of them: HTJ2K shows in the
      // code-block style, 0x40); MCT, MCC, MCO and CBD (a Part 2 transform, which
      // needs COD's MCT = 2, which OpenJPEG refuses)
      case COM: case CAP: case CPF: case MCT: case MCC: case MCO: case CBD: break;
      case SOT: read_sot(s); break;
      default: damaged("marker without a handler");
    }
  }

  // --- the main header ---
  void read_main_header(Reader& r) {
    uint32_t marker;
    if (!r.u16(marker) || marker != SOC) damaged("expected a SOC marker");
    state = ST_MHSIZ;
    if (!r.u16(marker)) damaged("stream too short");
    while (marker != SOT) {
      if (marker < 0xFF00) damaged("a marker was expected");
      MarkerInfo mi = marker_info(marker);
      if (!mi.known) {  // skip two bytes at a time to the next known marker
        while (true) {
          uint32_t m;
          if (!r.u16(m)) damaged("stream too short");
          if (m >= 0xFF00) {
            MarkerInfo k = marker_info(m);
            if (!(state & k.states)) damaged("marker out of place");
            if (k.known) {
              marker = m;
              mi = k;
              break;
            }
          }
        }
        if (marker == SOT) break;
      }
      if (!(state & mi.states)) damaged("marker out of place");
      if (marker == SIZ) has_siz = true;
      else if (marker == COD) has_cod = true;
      else if (marker == QCD) has_qcd = true;
      uint32_t size;
      if (!r.u16(size)) damaged("stream too short");
      if (size < 2) damaged("invalid marker size");
      const uint8_t* body;
      if (!r.read(size - 2, body)) damaged("stream too short");
      handle(marker, Seg{body, size - 2u});
      if (!r.u16(marker)) damaged("stream too short");
    }
    if (!has_siz) damaged("no SIZ marker");
    if (!has_cod) damaged("no COD marker");
    if (!has_qcd) damaged("no QCD marker");
    merge_ppm();
    state = ST_TPHSOT;
  }

  // OpenJPEG's check for an encoder that counted one tile-part short
  bool need_parts_correction(size_t pos) {
    Reader r(src, n);
    r.pos = pos;
    while (true) {
      uint32_t m, size;
      if (!r.u16(m) || m != SOT) return false;
      if (!r.u16(size)) damaged("stream too short");
      if (size != 10) damaged("inconsistent SOT marker size");
      const uint8_t* body;
      if (!r.read(8, body)) damaged("stream too short");
      uint32_t isot, psot, tpsot, tnsot;
      read_sot_values(Seg{body, 8}, isot, psot, tpsot, tnsot);
      if (static_cast<int>(isot) == current_tile) return tpsot == tnsot;
      if (psot < 14) return false;
      if (r.left() < psot - 12) return false;
      r.pos += psot - 12;
    }
  }

  // reads tile-parts up to a tile to decode; false at the end
  bool read_tile_header(Reader& r, int& tile) {
    uint32_t marker = SOT;  // read already
    if (state == ST_EOC) marker = EOC;
    else if (state != ST_TPHSOT) return false;
    can_decode = false;
    while (!can_decode && marker != EOC) {
      while (marker != SOD) {
        if (r.left() == 0) {
          state = ST_NEOC;
          break;
        }
        uint32_t size;
        if (!r.u16(size)) damaged("stream too short");
        if (size < 2) damaged("inconsistent marker size");
        if (marker == 0x8080 && r.left() == 0) {
          state = ST_NEOC;
          break;
        }
        if ((state & ST_TPH) && sot_length != 0) {
          if (sot_length < size + 2) damaged("SOT length less than a marker segment");
          sot_length -= size + 2;
        }
        const MarkerInfo mi = marker_info(marker);
        if (!(state & mi.states)) damaged("marker out of place");
        const uint8_t* body;
        if (!r.read(size - 2, body)) damaged("stream too short");
        if (!mi.known) damaged("unknown marker in a tile-part header");
        handle(marker, Seg{body, size - 2u});
        if (!r.u16(marker)) damaged("stream too short");
      }
      if (r.left() == 0 && state == ST_NEOC) break;
      read_sod(r);
      if (can_decode && !parts_checked) {
        parts_checked = true;
        if (need_parts_correction(r.pos)) {
          parts_correction = 1;
          for (auto& t : tiles)
            if (t.second.nb_parts) t.second.nb_parts += 1;
          can_decode = false;
        }
      }
      if (!can_decode) {
        if (!r.u16(marker)) damaged("stream too short");
      }
    }
    if (marker == EOC && state != ST_EOC) {
      current_tile = 0;
      state = ST_EOC;
    }
    if (!can_decode) {
      auto it = tiles.lower_bound(current_tile);
      while (it != tiles.end() && !it->second.has_data) ++it;
      if (it == tiles.end()) return false;
      current_tile = it->first;
    }
    Tile& tcp = tiles[current_tile];
    if (tcp.ppt) {  // merge the PPT markers in Zppt order
      std::vector<uint8_t> merged;
      for (auto& m : tcp.ppt_markers) merged.insert(merged.end(), m.begin(), m.end());
      tcp.ppt_markers.clear();
      tcp.ppt_markers.push_back(std::move(merged));
    }
    tile = current_tile;
    return true;
  }

  void read_sod(Reader& r) {
    size_t len;
    if (last_tile_part) {
      if (r.left() < 2) damaged("tile-part length past the end of the stream");
      len = r.left() - 2;
    } else {
      if (sot_length >= 2) sot_length -= 2;
      len = sot_length;
    }
    if (len > r.left()) damaged("tile-part length past the end of the stream");
    Tile& tcp = tiles[current_tile];
    const uint8_t* p;
    r.read(len, p);
    tcp.data.insert(tcp.data.end(), p, p + len);
    if (len > 0) tcp.has_data = true;
    state = ST_TPHSOT;
  }

  // --- tiles ---
  void decode_all() {
    Reader r(src, n);
    read_main_header(r);
    planes.resize(numcomps);  // allocated by the first tile decoded, as OpenJPEG does
    int decoded = 0;
    while (true) {
      int tile;
      if (!read_tile_header(r, tile)) break;
      decode_tile(tile);
      any_tile = true;
      Tile& done = tiles[tile];
      done.data.clear();
      done.data.shrink_to_fit();
      done.has_data = false;
      // the marker after a decoded tile: EOC, SOT, or the end of the data
      can_decode = false;
      if (!(r.left() == 0 && state == ST_NEOC) && state != ST_EOC) {
        uint32_t m;
        if (!r.u16(m)) damaged("stream too short after a tile");
        if (m == EOC) {
          current_tile = 0;
          state = ST_EOC;
        } else if (m != SOT) {
          if (r.left() != 0) damaged("stream too short after a tile");
          state = ST_NEOC;
        }
      }
      if (r.left() == 0 && state == ST_NEOC) break;
      if (++decoded == tw * th) break;
    }
    if (!any_tile) damaged("no tile decoded");
  }

  void init_tile(int tileno, const TCP& tcp, std::vector<TileComp>& tcs) {
    const int p = tileno % tw, q = tileno / tw;
    const int64_t ttx0 = std::max(tx0 + p * tdx, x0), tty0 = std::max(ty0 + q * tdy, y0);
    const int64_t ttx1 = std::min(tx0 + (p + 1) * tdx, x1), tty1 = std::min(ty0 + (q + 1) * tdy, y1);
    tcs.resize(numcomps);
    for (int c = 0; c < numcomps; ++c) {
      const TCCP& t = tcp.tccps[c];
      TileComp& tc = tcs[c];
      tc.x0 = ceildiv(ttx0, comps[c].dx);
      tc.y0 = ceildiv(tty0, comps[c].dy);
      tc.x1 = ceildiv(ttx1, comps[c].dx);
      tc.y1 = ceildiv(tty1, comps[c].dy);
      tc.numres = t.numres;
      tc.res.assign(t.numres, Resolution());
      for (int r = 0; r < t.numres; ++r) {
        Resolution& res = tc.res[r];
        const int level = t.numres - 1 - r;
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        res.pdx = t.prcw[r];
        res.pdy = t.prch[r];
        const int64_t tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
        const int64_t tly = floordivpow2(res.y0, res.pdy) << res.pdy;
        const int64_t brx = ceildivpow2(res.x1, res.pdx) << res.pdx;
        const int64_t bry = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((brx - tlx) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((bry - tly) >> res.pdy);
        if (res.pw && static_cast<int64_t>(res.pw) * res.ph > (1 << 24)) damaged("too many precincts");
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = tlx;
          cbgy0 = tly;
          cbgw = res.pdx;
          cbgh = res.pdy;
        } else {
          cbgx0 = ceildivpow2(tlx, 1);
          cbgy0 = ceildivpow2(tly, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
        }
        const int cblkw = std::min(t.cblkw, cbgw), cblkh = std::min(t.cblkh, cbgh);
        const int nbands = r == 0 ? 1 : 3;
        res.bands.assign(nbands, Band());
        for (int b = 0; b < nbands; ++b) {
          Band& band = res.bands[b];
          band.bandno = r == 0 ? 0 : b + 1;
          if (r == 0) {
            band.x0 = ceildivpow2(tc.x0, level);
            band.y0 = ceildivpow2(tc.y0, level);
            band.x1 = ceildivpow2(tc.x1, level);
            band.y1 = ceildivpow2(tc.y1, level);
          } else {
            const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
            band.x0 = ceildivpow2(tc.x0 - (xob << level), level + 1);
            band.y0 = ceildivpow2(tc.y0 - (yob << level), level + 1);
            band.x1 = ceildivpow2(tc.x1 - (xob << level), level + 1);
            band.y1 = ceildivpow2(tc.y1 - (yob << level), level + 1);
          }
          const StepSize& ss = t.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
          const int log2_gain = t.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
          const int rb = comps[c].prec + log2_gain;
          band.stepsize = static_cast<float>((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
          band.numbps = ss.expn + t.numgbits - 1;
          const int nprec = res.pw * res.ph;
          band.precincts.assign(nprec, Precinct());
          for (int pi = 0; pi < nprec; ++pi) {
            Precinct& prc = band.precincts[pi];
            const int64_t sx = cbgx0 + static_cast<int64_t>(pi % res.pw) * (int64_t(1) << cbgw);
            const int64_t sy = cbgy0 + static_cast<int64_t>(pi / res.pw) * (int64_t(1) << cbgh);
            prc.x0 = std::max(sx, band.x0);
            prc.y0 = std::max(sy, band.y0);
            prc.x1 = std::min(sx + (int64_t(1) << cbgw), band.x1);
            prc.y1 = std::min(sy + (int64_t(1) << cbgh), band.y1);
            const int64_t cx0 = floordivpow2(prc.x0, cblkw) << cblkw;
            const int64_t cy0 = floordivpow2(prc.y0, cblkh) << cblkh;
            const int64_t cx1 = ceildivpow2(prc.x1, cblkw) << cblkw;
            const int64_t cy1 = ceildivpow2(prc.y1, cblkh) << cblkh;
            prc.cw = cx1 > cx0 ? static_cast<int>((cx1 - cx0) >> cblkw) : 0;
            prc.ch = cy1 > cy0 ? static_cast<int>((cy1 - cy0) >> cblkh) : 0;
            if (static_cast<int64_t>(prc.cw) * prc.ch > (1 << 24)) damaged("too many code-blocks");
            prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
            for (int k = 0; k < prc.cw * prc.ch; ++k) {
              CodeBlock& cb = prc.cblks[k];
              const int64_t bx = cx0 + static_cast<int64_t>(k % prc.cw) * (int64_t(1) << cblkw);
              const int64_t by = cy0 + static_cast<int64_t>(k / prc.cw) * (int64_t(1) << cblkh);
              cb.x0 = std::max(bx, prc.x0);
              cb.y0 = std::max(by, prc.y0);
              cb.x1 = std::min(bx + (int64_t(1) << cblkw), prc.x1);
              cb.y1 = std::min(by + (int64_t(1) << cblkh), prc.y1);
            }
            prc.incl.build(prc.cw, prc.ch);
            prc.imsb.build(prc.cw, prc.ch);
          }
        }
      }
    }
  }

  // --- tier 2 ---
  struct Packet {
    int layno, resno, compno, precno;
  };

  // Reads the tile's packets in their progression order (under POC, each
  // packet once, its first time), each as its order's loops reach it.  A
  // packet that reads no byte (no header byte left, no SOP, no EPH
  // required) leaves every later packet empty as well, so the order ends
  // there: the tile costs what its bytes hold, not what its header's layer
  // and precinct counts could hold.  The set of packets read is therefore
  // no larger than the tile's bytes.
  void read_packets(int tileno, const TCP& tcp, std::vector<TileComp>& tcs,
                    const std::vector<uint8_t>& data, std::vector<uint8_t>* hdr, size_t& hdr_pos) {
    const int p = tileno % tw, q = tileno / tw;
    const int64_t ptx0 = std::max(tx0 + p * tdx, x0), pty0 = std::max(ty0 + q * tdy, y0);
    const int64_t ptx1 = std::min(tx0 + (p + 1) * tdx, x1), pty1 = std::min(ty0 + (q + 1) * tdy, y1);
    int max_res = 0, max_prec = 1;
    for (int c = 0; c < numcomps; ++c) {
      max_res = std::max(max_res, tcs[c].numres);
      for (auto& r : tcs[c].res) max_prec = std::max(max_prec, r.pw * r.ph);
    }
    std::unordered_set<uint64_t> included;
    size_t pos = 0;
    tile_data = data.data();
    struct EndOfPackets {};
    auto emit = [&](int l, int r, int c, int pr) {
      const uint64_t key = ((static_cast<uint64_t>(l) * max_res + r) * numcomps + c) * max_prec + pr;
      if (!included.insert(key).second) return;
      const size_t pos0 = pos, hdr_pos0 = hdr_pos;
      pos += read_packet(Packet{l, r, c, pr}, tcs, tcp, data.data() + pos, data.size() - pos, hdr,
                         hdr_pos);
      if (pos == pos0 && hdr_pos == hdr_pos0) throw EndOfPackets();
    };
    std::vector<PocEntry> pocs;
    if (tcp.has_poc) {
      pocs = tcp.pocs;
    } else {
      pocs.push_back(PocEntry{0, 0, tcp.numlayers, max_res, numcomps, tcp.prg});
    }
    for (const PocEntry& poc : pocs)
      if (poc.prg < 0) damaged("unknown progression order");
    try {
      for (const PocEntry& poc : pocs) {
        const int l1 = std::min(poc.layno1, tcp.numlayers);
        const int r0 = poc.resno0, r1 = poc.resno1, c0 = poc.compno0, c1 = poc.compno1;
        // an order OpenJPEG does not know, or components out of range: no packets
        if (poc.prg > 4 || c0 >= numcomps || c1 >= numcomps + 1) continue;
        one_order(poc, l1, r0, r1, c0, c1, tcs, ptx0, pty0, ptx1, pty1, emit);
      }
    } catch (const EndOfPackets&) {
    }
  }

  template <typename Emit>
  void one_order(const PocEntry& poc, int l1, int r0, int r1, int c0, int c1,
                 const std::vector<TileComp>& tcs, int64_t ptx0, int64_t pty0, int64_t ptx1,
                 int64_t pty1, Emit& emit) {
    {
      auto precincts = [&](int l, int r, int c) {
        const Resolution& res = tcs[c].res[r];
        for (int pr = 0; pr < res.pw * res.ph; ++pr) emit(l, r, c, pr);
      };
      if (poc.prg == 0) {  // LRCP
        for (int l = 0; l < l1; ++l)
          for (int r = r0; r < r1; ++r)
            for (int c = c0; c < c1; ++c)
              if (r < tcs[c].numres) precincts(l, r, c);
        return;
      }
      if (poc.prg == 1) {  // RLCP
        for (int r = r0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = c0; c < c1; ++c)
              if (r < tcs[c].numres) precincts(l, r, c);
        return;
      }
      // position-driven orders
      auto steps = [&](int c, int64_t& dx, int64_t& dy) {
        for (int r = 0; r < tcs[c].numres; ++r) {
          const Resolution& res = tcs[c].res[r];
          const int lv = tcs[c].numres - 1 - r;
          if (res.pdx + lv < 32) {
            const int64_t v = static_cast<int64_t>(comps[c].dx) << (res.pdx + lv);
            if (v <= 0xFFFFFFFFLL) dx = dx == 0 ? v : std::min(dx, v);
          }
          if (res.pdy + lv < 32) {
            const int64_t v = static_cast<int64_t>(comps[c].dy) << (res.pdy + lv);
            if (v <= 0xFFFFFFFFLL) dy = dy == 0 ? v : std::min(dy, v);
          }
        }
      };
      // the packet of component c, resolution r at reference-grid (x, y), if any
      auto at = [&](int64_t x, int64_t y, int c, int r, int& precno) -> bool {
        if (r >= tcs[c].numres) return false;
        const Resolution& res = tcs[c].res[r];
        const int lv = tcs[c].numres - 1 - r;
        const int64_t cdx = static_cast<int64_t>(comps[c].dx) << lv;
        const int64_t cdy = static_cast<int64_t>(comps[c].dy) << lv;
        if (lv >= 32 || cdx > 0xFFFFFFFFLL || cdy > 0xFFFFFFFFLL) return false;
        const int64_t trx0 = ceildiv(ptx0, cdx), try0 = ceildiv(pty0, cdy);
        const int64_t trx1 = ceildiv(ptx1, cdx), try1 = ceildiv(pty1, cdy);
        const int rpx = res.pdx + lv, rpy = res.pdy + lv;
        if (rpx >= 31 || rpy >= 31) return false;
        const int64_t mx = static_cast<int64_t>(comps[c].dx) << rpx;
        const int64_t my = static_cast<int64_t>(comps[c].dy) << rpy;
        if (mx > 0xFFFFFFFFLL || my > 0xFFFFFFFFLL) return false;
        if (!(y % my == 0 || (y == pty0 && ((try0 << lv) % (int64_t(1) << rpy))))) return false;
        if (!(x % mx == 0 || (x == ptx0 && ((trx0 << lv) % (int64_t(1) << rpx))))) return false;
        if (res.pw == 0 || res.ph == 0) return false;
        if (trx0 == trx1 || try0 == try1) return false;
        const int64_t prci = floordivpow2(ceildiv(x, cdx), res.pdx) - floordivpow2(trx0, res.pdx);
        const int64_t prcj = floordivpow2(ceildiv(y, cdy), res.pdy) - floordivpow2(try0, res.pdy);
        precno = static_cast<int>(prci + prcj * res.pw);
        return true;
      };
      if (poc.prg == 2 || poc.prg == 3) {  // RPCL, PCRL
        int64_t dx = 0, dy = 0;
        for (int c = 0; c < numcomps; ++c) steps(c, dx, dy);
        if (dx == 0 || dy == 0) return;
        if (poc.prg == 2) {
          for (int r = r0; r < r1; ++r)
            for (int64_t y = pty0; y < pty1; y += dy - (y % dy))
              for (int64_t x = ptx0; x < ptx1; x += dx - (x % dx))
                for (int c = c0; c < c1; ++c) {
                  int pr;
                  if (!at(x, y, c, r, pr)) continue;
                  for (int l = 0; l < l1; ++l) emit(l, r, c, pr);
                }
        } else {
          for (int64_t y = pty0; y < pty1; y += dy - (y % dy))
            for (int64_t x = ptx0; x < ptx1; x += dx - (x % dx))
              for (int c = c0; c < c1; ++c)
                for (int r = r0; r < std::min(r1, tcs[c].numres); ++r) {
                  int pr;
                  if (!at(x, y, c, r, pr)) continue;
                  for (int l = 0; l < l1; ++l) emit(l, r, c, pr);
                }
        }
        return;
      }
      for (int c = c0; c < c1; ++c) {  // CPRL
        int64_t dx = 0, dy = 0;
        steps(c, dx, dy);
        if (dx == 0 || dy == 0) return;
        for (int64_t y = pty0; y < pty1; y += dy - (y % dy))
          for (int64_t x = ptx0; x < ptx1; x += dx - (x % dx))
            for (int r = r0; r < std::min(r1, tcs[c].numres); ++r) {
              int pr;
              if (!at(x, y, c, r, pr)) continue;
              for (int l = 0; l < l1; ++l) emit(l, r, c, pr);
            }
      }
    }
  }

  static uint32_t numpasses(BitIn& bio) {
    if (!bio.bit()) return 1;
    if (!bio.bit()) return 2;
    uint32_t n = bio.read(2);
    if (n != 3) return 3 + n;
    n = bio.read(5);
    if (n != 31) return 6 + n;
    return 37 + bio.read(7);
  }

  static void init_seg(CodeBlock& cb, int index, int cblksty, bool first) {
    if (static_cast<int>(cb.segs.size()) <= index) cb.segs.resize(index + 1);
    Segment& seg = cb.segs[index];
    seg = Segment();
    if (cblksty & 0x04) {
      seg.maxpasses = 1;
    } else if (cblksty & 0x01) {
      if (first) {
        seg.maxpasses = 10;
      } else {
        const int prev = cb.segs[index - 1].maxpasses;
        seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
      }
    } else {
      seg.maxpasses = 109;
    }
  }

  // one packet; returns the body bytes consumed from data[pos:]
  size_t read_packet(const Packet& pk, std::vector<TileComp>& tcs, const TCP& tcp,
                     const uint8_t* data, size_t avail, std::vector<uint8_t>* hdr, size_t& hdr_pos) {
    Resolution& res = tcs[pk.compno].res[pk.resno];
    const TCCP& tccp = tcp.tccps[pk.compno];
    if (pk.layno == 0) {
      for (auto& band : res.bands) {
        if (band.empty()) continue;
        if (pk.precno >= static_cast<int>(band.precincts.size())) damaged("invalid precinct");
        Precinct& prc = band.precincts[pk.precno];
        prc.incl.build(prc.cw, prc.ch);
        prc.imsb.build(prc.cw, prc.ch);
        for (auto& cb : prc.cblks) cb.numsegs = 0;
      }
    }
    size_t cur = 0;
    if (tcp.csty & 2) {  // SOP: skipped when present
      if (avail >= 6 && data[0] == 0xFF && data[1] == 0x91) cur = 6;
    }
    const uint8_t* hp;
    size_t hlen;
    if (hdr != nullptr) {
      hp = hdr->data() + hdr_pos;
      hlen = hdr->size() - hdr_pos;
    } else {
      hp = data + cur;
      hlen = avail - cur;
    }
    BitIn bio(hp, hlen);
    const bool present = bio.bit();
    if (present) {
      for (auto& band : res.bands) {
        if (band.empty()) continue;
        Precinct& prc = band.precincts[pk.precno];
        for (int k = 0; k < prc.cw * prc.ch; ++k) {
          CodeBlock& cb = prc.cblks[k];
          bool included;
          if (cb.numsegs == 0) included = prc.incl.decode(bio, k, pk.layno + 1);
          else included = bio.bit();
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (cb.numsegs == 0) {
            int i = 0;
            while (!prc.imsb.decode(bio, k, i)) ++i;
            cb.numbps = band.numbps + 1 - i;
            cb.mb = band.numbps;
            cb.numlenbits = 3;
          }
          uint32_t n_passes = numpasses(bio);
          int increment = 0;
          while (bio.bit()) ++increment;
          cb.numlenbits += increment;
          int segno;
          if (cb.numsegs == 0) {
            segno = 0;
            init_seg(cb, 0, tccp.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          }
          cb.numnewpasses = static_cast<int>(n_passes);
          int left = static_cast<int>(n_passes);
          const bool ht = tccp.cblksty & 0x40;
          do {
            Segment& seg = cb.segs[segno];
            // HT: the first segment takes one pass (the cleanup), a later
            // one all that are left (OpenJPEG's t2, in every layer)
            if (ht) seg.numnewpasses = segno == 0 ? 1 : left;
            else seg.numnewpasses = std::min(seg.maxpasses - seg.numpasses, left);
            const int bits = cb.numlenbits + floorlog2(static_cast<uint32_t>(seg.numnewpasses));
            if (bits > 32) damaged("code-block length field over 32 bits");
            seg.newlen = bio.read(bits);
            left -= seg.numnewpasses;
            if (left > 0) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          } while (left > 0);
        }
      }
    }
    bio.inalign();
    size_t hbytes = bio.numbytes();
    if (tcp.csty & 4) {  // EPH: required once signalled
      if (hlen - hbytes < 2) damaged("no room for a required EPH marker");
      if (hp[hbytes] != 0xFF || hp[hbytes + 1] != 0x92) damaged("expected an EPH marker");
      hbytes += 2;
    }
    if (hdr != nullptr) hdr_pos += hbytes; else cur += hbytes;
    if (!present) return cur;
    // the body
    bool partial = false;
    for (auto& band : res.bands) {
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.precno];
      for (auto& cb : prc.cblks) {
        if (cb.numnewpasses == 0) continue;
        int s;
        if (cb.numsegs == 0) {
          s = 0;
          cb.numsegs = 1;
        } else {
          s = cb.numsegs - 1;
          if (cb.segs[s].numpasses == cb.segs[s].maxpasses) {
            ++s;
            ++cb.numsegs;
          }
        }
        do {
          Segment& seg = cb.segs[s];
          if (cur + seg.newlen > avail || partial) damaged("code-block segment past the tile data");
          if (cb.nchunks++ == 0) cb.chunk0 = static_cast<size_t>(data + cur - tile_data);
          cb.data.insert(cb.data.end(), data + cur, data + cur + seg.newlen);
          cur += seg.newlen;
          seg.len += seg.newlen;
          seg.numpasses += seg.numnewpasses;
          cb.numnewpasses -= seg.numnewpasses;
          if (cb.numnewpasses > 0) {
            ++s;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
    return cur;
  }

  void decode_tile(int tileno) {
    Tile& tile = tiles[tileno];
    if (!tile.has_data) damaged("a tile without data");
    const TCP& tcp = params(tile);
    std::vector<TileComp> tcs;
    init_tile(tileno, tcp, tcs);
    std::vector<uint8_t>* hdr = nullptr;
    size_t hdr_pos = 0;
    if (ppm) {
      hdr = &ppm_data;
      hdr_pos = ppm_pos;
    } else if (tile.ppt) {
      hdr = &tile.ppt_markers[0];
    }
    read_packets(tileno, tcp, tcs, tile.data, hdr, hdr_pos);
    if (ppm) ppm_pos = hdr_pos;
    // tier 1 and dequantization
    T1 t1;
    HtBlock htb;
    std::vector<int32_t> vals;
    for (int c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const TCCP& tccp = tcp.tccps[c];
      const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      if (tccp.qmfbid == 1) tc.idata.assign(static_cast<size_t>(w * h), 0);
      else tc.fdata.assign(static_cast<size_t>(w * h), 0.f);
      for (int r = 0; r < tc.numres; ++r) {
        Resolution& res = tc.res[r];
        for (auto& band : res.bands) {
          if (band.empty()) continue;
          for (auto& prc : band.precincts) {
            for (auto& cb : prc.cblks) {
              int cw, chh;
              if (tccp.cblksty & 0x40) {
                const std::string err = htb.decode(cb, tccp.roishift, tccp.cblksty);
                if (!err.empty()) damaged(err);
                cw = htb.w;
                chh = htb.h;
                vals.resize(htb.data.size());
                for (size_t k = 0; k < vals.size(); ++k) {
                  const int32_t v = static_cast<int32_t>(htb.data[k] & 0x7FFFFFFF);
                  vals[k] = (htb.data[k] & 0x80000000u) ? -v : v;
                }
              } else {
                if (!t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty))
                  damaged("code-block with more than 30 bit-planes");
                cw = t1.w;
                chh = t1.h;
                vals.swap(t1.data);
              }
              if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                  std::fill(vals.begin(), vals.end(), 0);
                } else {
                  const int32_t thresh = 1 << tccp.roishift;
                  for (auto& v : vals) {
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= tccp.roishift;
                      v = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              if (tccp.qmfbid == 1) {
                for (int j = 0; j < chh; ++j)
                  for (int i = 0; i < cw; ++i)
                    tc.idata[(y + j) * w + x + i] = vals[j * cw + i] / 2;
              } else {
                const float step = 0.5f * band.stepsize;
                for (int j = 0; j < chh; ++j)
                  for (int i = 0; i < cw; ++i)
                    tc.fdata[(y + j) * w + x + i] = static_cast<float>(vals[j * cw + i]) * step;
              }
            }
          }
        }
      }
      if (tccp.qmfbid == 1) idwt53(tc); else idwt97(tc);
    }
    // the multiple component transform: the RCT or ICT as component 0's
    // wavelet says, over the three buffers as they hold their bits (where a
    // component took the other wavelet, OpenJPEG reads its integers as
    // floats or its floats as integers, and so does this)
    if (tcp.mct && numcomps >= 3) {
      for (int c = 1; c < 3; ++c)
        if (tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0 ||
            tcs[c].y1 - tcs[c].y0 != tcs[0].y1 - tcs[0].y0 || tcs[c].numres != tcs[0].numres)
          damaged("MCT over components of different sizes");
      const size_t nsamp = static_cast<size_t>((tcs[0].x1 - tcs[0].x0) * (tcs[0].y1 - tcs[0].y0));
      const bool ict = tcp.tccps[0].qmfbid == 0;
      for (int c = 1; c < 3; ++c) {  // into component 0's kind, bit for bit
        if ((tcp.tccps[c].qmfbid == 0) == ict) continue;
        if (ict) {
          tcs[c].fdata.resize(nsamp);
          std::memcpy(tcs[c].fdata.data(), tcs[c].idata.data(), nsamp * sizeof(float));
        } else {
          tcs[c].idata.resize(nsamp);
          std::memcpy(tcs[c].idata.data(), tcs[c].fdata.data(), nsamp * sizeof(int32_t));
        }
      }
      if (ict) {
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
        for (size_t i = 0; i < nsamp; ++i) {
          const float yv = c0[i], u = c1[i], v = c2[i];
          const float r = yv + (v * 1.402f);
          const float g = yv - (u * 0.34413f) - (v * 0.71414f);
          const float b = yv + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      } else {
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        auto add = [](int32_t a, int32_t b) {  // 32-bit wrap, as OpenJPEG's SSE2 adds
          return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
        };
        for (size_t i = 0; i < nsamp; ++i) {
          const int32_t yv = c0[i], u = c1[i], v = c2[i];
          const int32_t q = add(u, v) >> 2;  // arithmetic shift
          const int32_t g =
              static_cast<int32_t>(static_cast<uint32_t>(yv) - static_cast<uint32_t>(q));
          const int32_t r = add(v, g);
          const int32_t b = add(u, g);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
      for (int c = 1; c < 3; ++c) {  // and back into their own, bit for bit
        if ((tcp.tccps[c].qmfbid == 0) == ict) continue;
        if (ict) std::memcpy(tcs[c].idata.data(), tcs[c].fdata.data(), nsamp * sizeof(int32_t));
        else std::memcpy(tcs[c].fdata.data(), tcs[c].idata.data(), nsamp * sizeof(float));
      }
    }
    // DC level shift, clamp, and the copy into the image planes
    for (int c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const TCCP& tccp = tcp.tccps[c];
      const Comp& cp = comps[c];
      const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      int64_t lo, hi;
      if (cp.sgnd) {
        lo = -(int64_t(1) << (cp.prec - 1));
        hi = (int64_t(1) << (cp.prec - 1)) - 1;
      } else {
        lo = 0;
        hi = (int64_t(1) << cp.prec) - 1;
      }
      const int64_t shift = cp.sgnd ? 0 : int64_t(1) << (cp.prec - 1);
      std::vector<int32_t>& plane = planes[c];
      if (plane.empty()) plane.assign(static_cast<size_t>(cp.w) * cp.h, 0);
      for (int64_t j = 0; j < h; ++j) {
        const int64_t py = tc.y0 + j - cp.y0;
        if (py < 0 || py >= cp.h) continue;
        for (int64_t i = 0; i < w; ++i) {
          const int64_t px = tc.x0 + i - cp.x0;
          if (px < 0 || px >= cp.w) continue;
          int64_t v;
          if (tccp.qmfbid == 1) {
            v = static_cast<int64_t>(tc.idata[j * w + i]) + shift;
          } else {
            const float f = tc.fdata[j * w + i];
            if (f > 2147483648.0f) {
              plane[py * cp.w + px] = static_cast<int32_t>(hi);
              continue;
            }
            if (f < -2147483648.0f) {
              plane[py * cp.w + px] = static_cast<int32_t>(lo);
              continue;
            }
            if (std::isnan(f)) {
              v = INT64_MIN / 2;
            } else {
              v = static_cast<int64_t>(std::nearbyint(static_cast<double>(f))) + shift;
            }
          }
          plane[py * cp.w + px] = static_cast<int32_t>(std::max(lo, std::min(hi, v)));
        }
      }
    }
  }

  // --- inverse wavelet transforms ---
  // 5/3 on one line of len samples (the sn low ones first), cas the parity
  // of its first coordinate, as opj_idwt53_h / opj_idwt53_v compute it
  static void idwt53_line(int32_t* a, int sn, int len, int cas, std::vector<int32_t>& tmp) {
    const int dn = len - sn;
    if (cas == 0) {
      if (len <= 1) return;
    } else {
      if (len == 1) {
        a[0] /= 2;
        return;
      }
    }
    tmp.assign(len, 0);
    // interleave (low samples on the even coordinates), then the two lifting steps
    std::vector<int32_t> x(len);
    for (int i = 0; i < sn; ++i) x[2 * i + cas] = a[i];
    for (int i = 0; i < dn; ++i) x[2 * i + 1 - cas] = a[sn + i];
    auto odd = [&](int k) {  // the value at local index k (high sample), mirrored
      if (k < 0) k = -k;
      if (k >= len) k = 2 * (len - 1) - k;
      return x[k];
    };
    // even coordinates (low): local index k with (k + cas) even
    for (int k = cas; k < len; k += 2) x[k] = x[k] - ((odd(k - 1) + odd(k + 1) + 2) >> 2);
    for (int k = 1 - cas; k < len; k += 2) x[k] = x[k] + ((odd(k - 1) + odd(k + 1)) >> 1);
    std::copy(x.begin(), x.end(), a);
  }

  void idwt53(TileComp& tc) {
    const int64_t w = tc.x1 - tc.x0;
    std::vector<int32_t> line, tmp;
    for (int r = 1; r < tc.numres; ++r) {
      const Resolution& lo = tc.res[r - 1];
      const Resolution& res = tc.res[r];
      const int rw = static_cast<int>(res.x1 - res.x0), rh = static_cast<int>(res.y1 - res.y0);
      const int snh = static_cast<int>(lo.x1 - lo.x0), snv = static_cast<int>(lo.y1 - lo.y0);
      const int cash = static_cast<int>(res.x0 % 2), casv = static_cast<int>(res.y0 % 2);
      if (rw == 0 || rh == 0) continue;
      for (int j = 0; j < rh; ++j) idwt53_line(&tc.idata[j * w], snh, rw, cash, tmp);
      line.resize(rh);
      for (int i = 0; i < rw; ++i) {
        for (int j = 0; j < rh; ++j) line[j] = tc.idata[j * w + i];
        idwt53_line(line.data(), snv, rh, casv, tmp);
        for (int j = 0; j < rh; ++j) tc.idata[j * w + i] = line[j];
      }
    }
  }

  // 9/7 on one line, as opj_v8dwt_decode computes each lane
  static void idwt97_line(float* a, int sn, int len, int cas, std::vector<float>& wv) {
    const int dn = len - sn;
    if (cas == 0) {
      if (!(dn > 0 || sn > 1)) return;
    } else {
      if (!(sn > 0 || dn > 1)) return;
    }
    wv.assign(len + 2, 0.f);
    for (int i = 0; i < sn; ++i) wv[2 * i + cas] = a[i];
    for (int i = 0; i < dn; ++i) wv[2 * i + 1 - cas] = a[sn + i];
    const int ia = cas, ib = 1 - cas;
    const float K = 1.230174105f, two_invK = 1.625732422f;
    for (int i = 0; i < sn; ++i) wv[ia + 2 * i] = wv[ia + 2 * i] * K;
    for (int i = 0; i < dn; ++i) wv[ib + 2 * i] = wv[ib + 2 * i] * two_invK;
    // step2(l, w, end, m, c): w[-1] += (l + w) * c over i < min(end, m); then
    // the last one mirrored when m < end
    auto step2 = [&](int l, int w, int end, int m, float c) {
      int imax = std::min(end, m);
      if (m < 0) imax = end;  // OpenJPEG's unsigned wrap of a negative bound
      int fl = l, fw = w;
      for (int i = 0; i < imax; ++i) {
        wv[fw - 1] = wv[fw - 1] + ((wv[fl] + wv[fw]) * c);
        fl = fw;
        fw += 2;
      }
      if (m >= 0 && m < end) {
        c += c;
        wv[fw - 1] = wv[fw - 1] + wv[fl] * c;
      }
    };
    const float delta = 0.443506852f, gamma = 0.882911075f, beta = -0.052980118f,
                alpha = -1.586134342f;
    step2(ib, ia + 1, sn, std::min(sn, dn - ia), -delta);
    step2(ia, ib + 1, dn, std::min(dn, sn - ib), -gamma);
    step2(ib, ia + 1, sn, std::min(sn, dn - ia), -beta);
    step2(ia, ib + 1, dn, std::min(dn, sn - ib), -alpha);
    for (int k = 0; k < len; ++k) a[k] = wv[k];
  }

  void idwt97(TileComp& tc) {
    const int64_t w = tc.x1 - tc.x0;
    std::vector<float> line, wv;
    for (int r = 1; r < tc.numres; ++r) {
      const Resolution& lo = tc.res[r - 1];
      const Resolution& res = tc.res[r];
      const int rw = static_cast<int>(res.x1 - res.x0), rh = static_cast<int>(res.y1 - res.y0);
      const int snh = static_cast<int>(lo.x1 - lo.x0), snv = static_cast<int>(lo.y1 - lo.y0);
      const int cash = static_cast<int>(res.x0 % 2), casv = static_cast<int>(res.y0 % 2);
      if (rw == 0 || rh == 0) continue;
      for (int j = 0; j < rh; ++j) idwt97_line(&tc.fdata[j * w], snh, rw, cash, wv);
      line.resize(rh);
      for (int i = 0; i < rw; ++i) {
        for (int j = 0; j < rh; ++j) line[j] = tc.fdata[j * w + i];
        idwt97_line(line.data(), snv, rh, casv, wv);
        for (int j = 0; j < rh; ++j) tc.fdata[j * w + i] = line[j];
      }
    }
  }
};

int64_t fail_code(const Failure& f, char* msg, int64_t msg_len) {
  set_message(msg, msg_len, f.what);
  return f.code;
}

}  // namespace

// The main header's geometry: info[0:5] = image x0, y0, x1, y1, components;
// then 8 a component: dx, dy, width, height, x0, y0, precision, signed
// (5 + 8 * 16384 values at most, as SIZ holds at most 16384 components).
// Reads the main header and no tile.  Returns 0, or -1 (damaged, with a
// message).
extern "C" int64_t rcnn_j2k_header(const uint8_t* src, int64_t n, int64_t* info, char* msg,
                                   int64_t msg_len) {
  if (src == nullptr || info == nullptr || n < 0) return -1;
  try {
    Decoder dec(src, static_cast<size_t>(n));
    Reader r(src, static_cast<size_t>(n));
    dec.read_main_header(r);
    info[0] = dec.x0;
    info[1] = dec.y0;
    info[2] = dec.x1;
    info[3] = dec.y1;
    info[4] = dec.numcomps;
    for (int c = 0; c < dec.numcomps; ++c) {
      const Comp& cp = dec.comps[c];
      int64_t* o = info + 5 + 8 * c;
      o[0] = cp.dx; o[1] = cp.dy; o[2] = cp.w; o[3] = cp.h;
      o[4] = cp.x0; o[5] = cp.y0; o[6] = cp.prec; o[7] = cp.sgnd;
    }
    return 0;
  } catch (const Failure& f) {
    return fail_code(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    set_message(msg, msg_len, "JPEG 2000: out of memory");
    return -1;
  }
}

// Decodes the codestream into `out`: the components' planes one after the
// other (width x height int32 samples each, as rcnn_j2k_header gives them),
// `total` samples in all.  Returns 0 or -1 as rcnn_j2k_header.
extern "C" int64_t rcnn_j2k_decode(const uint8_t* src, int64_t n, int32_t* out, int64_t total,
                                   char* msg, int64_t msg_len) {
  if (src == nullptr || out == nullptr || n < 0) return -1;
  try {
    Decoder dec(src, static_cast<size_t>(n));
    dec.decode_all();
    int64_t need = 0;
    for (auto& p : dec.planes) need += static_cast<int64_t>(p.size());
    if (need != total) {
      set_message(msg, msg_len, "JPEG 2000: the planes differ from the caller's");
      return -1;
    }
    for (auto& p : dec.planes) {
      std::copy(p.begin(), p.end(), out);
      out += p.size();
    }
    return 0;
  } catch (const Failure& f) {
    return fail_code(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    set_message(msg, msg_len, "JPEG 2000: out of memory");
    return -1;
  }
}
