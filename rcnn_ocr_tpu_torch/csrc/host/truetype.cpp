// A TrueType reader, shaper and anti-aliasing rasterizer for the port's
// synthetic line generator (rcnn_ocr_tpu_torch/data/truetype.py).  It stands
// in for what PIL's ImageFont.truetype / textbbox / draw.text do with
// FreeType and raqm (HarfBuzz) at one pixel size, for fonts with TrueType
// outlines:
//
// * tables: head, hhea, maxp, hmtx, cmap (formats 4 and 12), loca, glyf
//   (simple and composite glyphs), GDEF's glyph classes, GSUB and GPOS;
// * layout: the text split into script runs as raqm splits it (common
//   characters take the script before them, a closing bracket its opening
//   one's), each run shaped with the default features HarfBuzz enables for
//   left-to-right text: GSUB single (1) and ligature (4) lookups, GPOS pair
//   adjustments (2, formats 1 and 2), extension lookups unwrapped; other
//   lookup types are skipped (the chained ccmp of the DejaVu fonts needs a
//   combining mark, which the generator's alphabets do not hold);
// * metrics in FreeType's integer arithmetic: advances are
//   FT_MulDiv(units, x_scale, 64) in 16.16 rounded to 26.6 as HarfBuzz's
//   FreeType functions do, GPOS values scaled as HarfBuzz's em_mult;
// * the outline is NOT hinted: points scaled to 26.6 with FT_MulFix, conic
//   arcs flattened into 2^k lines (k as FreeType's smooth rasterizer picks
//   it), and exact-area coverage accumulated in integer cells of 1/256
//   pixel with the nonzero rule.  Integer arithmetic throughout, so every
//   host gives the same bitmap;
// * PIL's placement: the pen in 26.6, each glyph drawn at the pen rounded
//   to a whole pixel, glyph coverage combined by maximum, the 'la' anchor
//   (top at the size's ascender, rounded up), the box from the glyphs'
//   control boxes (horizontal extents floored and ceiled, vertical ones
//   rounded as box_bottom says, standing in for the hinting FreeType
//   applies there) and the pen line, and mode L's blend (in * (255 - m) + ink * m) / 255 rounded
//   as PIL's DIV255.
//
// Entry points return 0 (or a count) on success and a negative value with a
// message on failure.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};

int64_t mul_fix(int64_t a, int64_t b) {  // FT_MulFix
  int64_t s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  return s * ((a * b + 0x8000) >> 16);
}

int64_t mul_div(int64_t a, int64_t b, int64_t c) {  // FT_MulDiv
  int64_t s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  if (c < 0) { c = -c; s = -s; }
  return c > 0 ? s * ((a * b + (c >> 1)) / c) : 0x7FFFFFFF;
}

int64_t div_fix(int64_t a, int64_t b) {  // FT_DivFix
  return mul_div(a, 65536, b);
}

// a / b rounded to nearest, halves away from zero (b != 0)
int64_t round_div(int64_t a, int64_t b) {
  bool neg = (a < 0) != (b < 0);
  int64_t ua = a < 0 ? -a : a, ub = b < 0 ? -b : b;
  int64_t q = (ua + ub / 2) / ub;
  return neg ? -q : q;
}

int64_t floor64(int64_t v) { return v & ~int64_t(63); }
int64_t ceil64(int64_t v) { return (v + 63) & ~int64_t(63); }

struct Point {
  int64_t x, y;
  bool on;
};

struct Outline {
  std::vector<Point> pts;
  std::vector<int> ends;  // last point index of each contour
};

struct Glyph {
  uint32_t id = 0;
  int64_t x_advance = 0, x_offset = 0;  // 26.6
};

class Font {
 public:
  explicit Font(std::vector<uint8_t> bytes) : d_(std::move(bytes)) { parse(); }

  int64_t x_scale(int size) const { return div_fix(int64_t(size) << 6, upem_); }

  // hhea ascender / descender in 26.6 at `size`, rounded outwards to whole
  // pixels as FreeType's size metrics are.
  int64_t ascender(int size) const { return ceil64(mul_fix(ascender_, x_scale(size))); }
  int64_t descender(int size) const { return floor64(mul_fix(descender_, x_scale(size))); }

  uint32_t glyph_of(uint32_t cp) const;
  std::vector<Glyph> shape(const std::vector<uint32_t>& text, int size) const;
  Outline outline(uint32_t gid, int size) const;

 private:
  std::vector<uint8_t> d_;
  uint32_t head_ = 0, hhea_ = 0, maxp_ = 0, hmtx_ = 0, loca_ = 0, glyf_ = 0;
  uint32_t glyf_len_ = 0, cmap_sub_ = 0, gdef_ = 0, gsub_ = 0, gpos_ = 0;
  int cmap_format_ = 0;
  int upem_ = 0, num_glyphs_ = 0, loca_long_ = 0, num_hmetrics_ = 0;
  int ascender_ = 0, descender_ = 0;

  void need(size_t off, size_t len) const {
    if (off > d_.size() || len > d_.size() - off) throw Fail("font data ends early");
  }
  uint8_t u8(size_t o) const { need(o, 1); return d_[o]; }
  uint16_t u16(size_t o) const { need(o, 2); return uint16_t(d_[o] << 8 | d_[o + 1]); }
  int16_t s16(size_t o) const { return int16_t(u16(o)); }
  uint32_t u32(size_t o) const {
    need(o, 4);
    return uint32_t(d_[o]) << 24 | uint32_t(d_[o + 1]) << 16 | uint32_t(d_[o + 2]) << 8 | d_[o + 3];
  }

  void parse();
  uint32_t table(const char* tag, uint32_t* len = nullptr) const;
  int64_t advance_units(uint32_t gid) const;
  int glyph_class(uint32_t gid) const;
  int coverage(uint32_t off, uint32_t gid) const;
  int class_of(uint32_t off, uint32_t gid) const;
  bool skipped(uint16_t flag, uint32_t gid) const;
  std::vector<uint16_t> lookups(uint32_t layout, uint32_t script_tag, bool gsub) const;
  void apply_gsub(uint32_t lookup, std::vector<Glyph>& run) const;
  void apply_gpos(uint32_t lookup, std::vector<Glyph>& run, int64_t x_mult) const;
  bool gsub_subtable(int type, uint32_t st, uint16_t flag, std::vector<Glyph>& run, size_t& i) const;
  bool pair_pos(uint32_t st, uint16_t flag, std::vector<Glyph>& run, size_t& i, int64_t x_mult) const;
  int64_t value_x(uint32_t rec, uint16_t format, int64_t x_mult, int64_t* placement) const;
  void load_glyph(uint32_t gid, int64_t scale, Outline& out, int depth) const;
};

uint32_t tag_of(const char* t) {
  return uint32_t(uint8_t(t[0])) << 24 | uint32_t(uint8_t(t[1])) << 16 |
         uint32_t(uint8_t(t[2])) << 8 | uint8_t(t[3]);
}

uint32_t Font::table(const char* tag, uint32_t* len) const {
  uint32_t want = tag_of(tag);
  uint16_t n = u16(4);
  for (uint32_t k = 0; k < n; ++k) {
    size_t rec = 12 + 16 * size_t(k);
    if (u32(rec) == want) {
      uint32_t off = u32(rec + 8), l = u32(rec + 12);
      need(off, l);
      if (len) *len = l;
      return off;
    }
  }
  return 0;
}

void Font::parse() {
  uint32_t version = u32(0);
  if (version != 0x00010000 && version != tag_of("true"))
    throw Fail("not a TrueType font (no glyf outlines)");
  head_ = table("head");
  hhea_ = table("hhea");
  maxp_ = table("maxp");
  hmtx_ = table("hmtx");
  loca_ = table("loca");
  glyf_ = table("glyf", &glyf_len_);
  uint32_t cmap = table("cmap");
  if (!head_ || !hhea_ || !maxp_ || !hmtx_ || !loca_ || !glyf_ || !cmap)
    throw Fail("a required table (head, hhea, maxp, hmtx, loca, glyf, cmap) is missing");
  upem_ = u16(head_ + 18);
  loca_long_ = s16(head_ + 50);
  num_glyphs_ = u16(maxp_ + 4);
  ascender_ = s16(hhea_ + 4);
  descender_ = s16(hhea_ + 6);
  num_hmetrics_ = u16(hhea_ + 34);
  if (upem_ < 16 || upem_ > 16384 || num_glyphs_ == 0 || num_hmetrics_ == 0 ||
      num_hmetrics_ > num_glyphs_ || (loca_long_ != 0 && loca_long_ != 1))
    throw Fail("bad head, maxp or hhea values");
  need(hmtx_, 4 * size_t(num_hmetrics_));
  need(loca_, (loca_long_ ? 4 : 2) * (size_t(num_glyphs_) + 1));
  // the Unicode subtable FreeType's charmap selection prefers: full
  // repertoire (format 12) first, then BMP (format 4)
  int best = 0;
  uint16_t n = u16(cmap + 2);
  for (uint32_t k = 0; k < n; ++k) {
    uint16_t pid = u16(cmap + 4 + 8 * k), eid = u16(cmap + 6 + 8 * k);
    uint32_t sub = cmap + u32(cmap + 8 + 8 * k);
    uint16_t fmt = u16(sub);
    int rank = 0;
    if (fmt == 12 && ((pid == 3 && eid == 10) || pid == 0)) rank = 2;
    else if (fmt == 4 && ((pid == 3 && eid == 1) || pid == 0)) rank = 1;
    if (rank > best) { best = rank; cmap_sub_ = sub; cmap_format_ = fmt; }
  }
  if (!best) throw Fail("no Unicode cmap subtable of format 4 or 12");
  gdef_ = table("GDEF");
  gsub_ = table("GSUB");
  gpos_ = table("GPOS");
}

uint32_t Font::glyph_of(uint32_t cp) const {
  uint32_t s = cmap_sub_;
  if (cmap_format_ == 12) {
    uint32_t groups = u32(s + 12);
    uint32_t lo = 0, hi = groups;
    while (lo < hi) {
      uint32_t mid = (lo + hi) / 2, g = s + 16 + 12 * mid;
      uint32_t start = u32(g), end = u32(g + 4);
      if (cp < start) hi = mid;
      else if (cp > end) lo = mid + 1;
      else {
        uint32_t gid = u32(g + 8) + (cp - start);
        return gid < uint32_t(num_glyphs_) ? gid : 0;
      }
    }
    return 0;
  }
  if (cp > 0xFFFF) return 0;
  uint16_t segx2 = u16(s + 6), segs = segx2 / 2;
  uint32_t ends = s + 14, starts = ends + segx2 + 2, deltas = starts + segx2, ranges = deltas + segx2;
  for (uint32_t k = 0; k < segs; ++k) {
    uint16_t end = u16(ends + 2 * k);
    if (cp > end) continue;
    uint16_t start = u16(starts + 2 * k);
    if (cp < start) return 0;
    uint16_t delta = u16(deltas + 2 * k), range = u16(ranges + 2 * k);
    uint32_t gid;
    if (range == 0) {
      gid = (cp + delta) & 0xFFFF;
    } else {
      gid = u16(ranges + 2 * k + range + 2 * (cp - start));
      if (gid) gid = (gid + delta) & 0xFFFF;
    }
    return gid < uint32_t(num_glyphs_) ? gid : 0;
  }
  return 0;
}

int64_t Font::advance_units(uint32_t gid) const {
  uint32_t k = std::min<uint32_t>(gid, uint32_t(num_hmetrics_ - 1));
  return u16(hmtx_ + 4 * k);
}

// ---- OpenType layout -------------------------------------------------------

int Font::coverage(uint32_t off, uint32_t gid) const {
  uint16_t fmt = u16(off);
  if (fmt == 1) {
    uint16_t n = u16(off + 2);
    uint32_t lo = 0, hi = n;
    while (lo < hi) {
      uint32_t mid = (lo + hi) / 2;
      uint16_t g = u16(off + 4 + 2 * mid);
      if (gid < g) hi = mid;
      else if (gid > g) lo = mid + 1;
      else return int(mid);
    }
    return -1;
  }
  if (fmt == 2) {
    uint16_t n = u16(off + 2);
    for (uint32_t k = 0; k < n; ++k) {
      uint32_t r = off + 4 + 6 * k;
      uint16_t start = u16(r), end = u16(r + 2);
      if (gid >= start && gid <= end) return int(u16(r + 4) + (gid - start));
    }
  }
  return -1;
}

int Font::class_of(uint32_t off, uint32_t gid) const {
  uint16_t fmt = u16(off);
  if (fmt == 1) {
    uint16_t first = u16(off + 2), n = u16(off + 4);
    return gid >= first && gid < uint32_t(first) + n ? u16(off + 6 + 2 * (gid - first)) : 0;
  }
  if (fmt == 2) {
    uint16_t n = u16(off + 2);
    for (uint32_t k = 0; k < n; ++k) {
      uint32_t r = off + 4 + 6 * k;
      if (gid >= u16(r) && gid <= u16(r + 2)) return u16(r + 4);
    }
  }
  return 0;
}

int Font::glyph_class(uint32_t gid) const {
  if (!gdef_) return 0;
  uint16_t off = u16(gdef_ + 4);
  return off ? class_of(gdef_ + off, gid) : 0;
}

bool Font::skipped(uint16_t flag, uint32_t gid) const {
  if (!(flag & 0x0E)) return false;
  int c = glyph_class(gid);
  return (c == 1 && (flag & 2)) || (c == 2 && (flag & 4)) || (c == 3 && (flag & 8));
}

// The lookups, in LookupList order, of the features HarfBuzz enables by
// default for horizontal left-to-right text, under `script_tag`'s default
// language system (else DFLT's, else latn's).
std::vector<uint16_t> Font::lookups(uint32_t layout, uint32_t script_tag, bool gsub) const {
  static const char* kGsub[] = {"rvrn", "ltra", "ltrm", "ccmp", "locl", "rlig", "rclt",
                                "calt", "liga", "clig", "abvm", "blwm"};
  static const char* kGpos[] = {"kern", "mark", "mkmk", "curs", "dist", "abvm", "blwm"};
  std::vector<uint16_t> out;
  if (!layout) return out;
  uint32_t scripts = layout + u16(layout + 4), features = layout + u16(layout + 6);
  uint32_t langsys = 0;
  for (uint32_t want : {script_tag, tag_of("DFLT"), tag_of("latn")}) {
    uint16_t n = u16(scripts);
    for (uint32_t k = 0; k < n && !langsys; ++k) {
      if (u32(scripts + 2 + 6 * k) != want) continue;
      uint32_t script = scripts + u16(scripts + 6 + 6 * k);
      uint16_t def = u16(script);
      if (def) langsys = script + def;
    }
    if (langsys) break;
  }
  if (!langsys) return out;
  auto enabled = [&](uint32_t tag) {
    for (const char* t : gsub ? std::vector<const char*>(std::begin(kGsub), std::end(kGsub))
                              : std::vector<const char*>(std::begin(kGpos), std::end(kGpos)))
      if (tag_of(t) == tag) return true;
    return false;
  };
  uint16_t nf = u16(features);
  auto add_feature = [&](uint16_t index) {
    if (index >= nf) return;
    uint32_t rec = features + 2 + 6 * uint32_t(index);
    if (!enabled(u32(rec))) return;
    uint32_t feat = features + u16(rec + 4);
    uint16_t nl = u16(feat + 2);
    for (uint32_t j = 0; j < nl; ++j) out.push_back(u16(feat + 4 + 2 * j));
  };
  uint16_t required = u16(langsys + 2);
  if (required != 0xFFFF) add_feature(required);
  uint16_t count = u16(langsys + 4);
  for (uint32_t k = 0; k < count; ++k) add_feature(u16(langsys + 6 + 2 * k));
  std::sort(out.begin(), out.end());
  out.erase(std::unique(out.begin(), out.end()), out.end());
  return out;
}

bool Font::gsub_subtable(int type, uint32_t st, uint16_t flag, std::vector<Glyph>& run,
                         size_t& i) const {
  if (type == 7) {  // extension
    return gsub_subtable(u16(st + 2), st + u32(st + 4), flag, run, i);
  }
  uint32_t gid = run[i].id;
  if (type == 1) {
    int c = coverage(st + u16(st + 2), gid);
    if (c < 0) return false;
    if (u16(st) == 1) run[i].id = (gid + u16(st + 4)) & 0xFFFF;
    else if (c < u16(st + 4)) run[i].id = u16(st + 6 + 2 * c);
    else return false;
    ++i;
    return true;
  }
  if (type == 4) {
    int c = coverage(st + u16(st + 2), gid);
    if (c < 0 || c >= u16(st + 4)) return false;
    uint32_t set = st + u16(st + 6 + 2 * c);
    uint16_t nlig = u16(set);
    for (uint32_t k = 0; k < nlig; ++k) {
      uint32_t lig = set + u16(set + 2 + 2 * k);
      uint16_t comps = u16(lig + 2);
      std::vector<size_t> at{i};
      size_t j = i;
      bool match = true;
      for (uint32_t m = 1; m < comps && match; ++m) {
        do { ++j; } while (j < run.size() && skipped(flag, run[j].id));
        match = j < run.size() && run[j].id == u16(lig + 4 + 2 * (m - 1));
        at.push_back(j);
      }
      if (!match) continue;
      run[i].id = u16(lig);
      for (size_t m = at.size(); m-- > 1;) run.erase(run.begin() + at[m]);
      ++i;
      return true;
    }
  }
  return false;  // other lookup types are not applied
}

void Font::apply_gsub(uint32_t lookup, std::vector<Glyph>& run) const {
  uint32_t list = gsub_ + u16(gsub_ + 8);
  if (lookup >= u16(list)) return;
  uint32_t lk = list + u16(list + 2 + 2 * lookup);
  uint16_t type = u16(lk), flag = u16(lk + 2), n = u16(lk + 4);
  for (size_t i = 0; i < run.size();) {
    if (skipped(flag, run[i].id)) { ++i; continue; }
    bool done = false;
    for (uint32_t k = 0; k < n && !done; ++k)
      done = gsub_subtable(type, lk + u16(lk + 6 + 2 * k), flag, run, i);
    if (!done) ++i;
  }
}

int64_t Font::value_x(uint32_t rec, uint16_t format, int64_t x_mult, int64_t* placement) const {
  // ValueRecord fields in order: XPlacement, YPlacement, XAdvance, YAdvance, devices
  auto scaled = [&](int16_t v) { return (int64_t(v) * x_mult + 32768) >> 16; };
  uint32_t p = rec;
  int64_t adv = 0;
  if (format & 1) { *placement += scaled(s16(p)); p += 2; }
  if (format & 2) p += 2;
  if (format & 4) { adv = scaled(s16(p)); p += 2; }
  return adv;
}

int value_size(uint16_t format) {
  int n = 0;
  for (int b = 0; b < 8; ++b) n += (format >> b) & 1;
  return 2 * n;
}

bool Font::pair_pos(uint32_t st, uint16_t flag, std::vector<Glyph>& run, size_t& i,
                    int64_t x_mult) const {
  uint16_t fmt = u16(st);
  int c = coverage(st + u16(st + 2), run[i].id);
  if (c < 0) return false;
  size_t j = i + 1;
  while (j < run.size() && skipped(flag, run[j].id)) ++j;
  if (j >= run.size()) return false;
  uint16_t vf1 = u16(st + 4), vf2 = u16(st + 6);
  int s1 = value_size(vf1), s2 = value_size(vf2);
  uint32_t r1 = 0, r2 = 0;
  if (fmt == 1) {
    if (c >= u16(st + 8)) return false;
    uint32_t set = st + u16(st + 10 + 2 * c);
    uint16_t n = u16(set);
    uint32_t rec_size = 2 + s1 + s2;
    uint32_t lo = 0, hi = n;
    bool found = false;
    while (lo < hi) {
      uint32_t mid = (lo + hi) / 2, rec = set + 2 + rec_size * mid;
      uint16_t second = u16(rec);
      if (run[j].id < second) hi = mid;
      else if (run[j].id > second) lo = mid + 1;
      else { r1 = rec + 2; r2 = rec + 2 + s1; found = true; break; }
    }
    if (!found) return false;
  } else if (fmt == 2) {
    uint32_t cd1 = st + u16(st + 8), cd2 = st + u16(st + 10);
    uint16_t n1 = u16(st + 12), n2 = u16(st + 14);
    int k1 = class_of(cd1, run[i].id), k2 = class_of(cd2, run[j].id);
    if (k1 >= n1 || k2 >= n2) return false;
    r1 = st + 16 + uint32_t(s1 + s2) * (uint32_t(k1) * n2 + uint32_t(k2));
    r2 = r1 + s1;
  } else {
    return false;
  }
  run[i].x_advance += value_x(r1, vf1, x_mult, &run[i].x_offset);
  run[j].x_advance += value_x(r2, vf2, x_mult, &run[j].x_offset);
  i = vf2 ? j + 1 : j;
  return true;
}

void Font::apply_gpos(uint32_t lookup, std::vector<Glyph>& run, int64_t x_mult) const {
  uint32_t list = gpos_ + u16(gpos_ + 8);
  if (lookup >= u16(list)) return;
  uint32_t lk = list + u16(list + 2 + 2 * lookup);
  uint16_t type = u16(lk), flag = u16(lk + 2), n = u16(lk + 4);
  for (size_t i = 0; i < run.size();) {
    if (skipped(flag, run[i].id)) { ++i; continue; }
    bool done = false;
    for (uint32_t k = 0; k < n && !done; ++k) {
      uint32_t st = lk + u16(lk + 6 + 2 * k);
      int t = type;
      if (t == 9) { t = u16(st + 2); st += u32(st + 4); }
      if (t == 2) done = pair_pos(st, flag, run, i, x_mult);
    }
    if (!done) ++i;
  }
}

// Unicode script of a code point, enough for the generator's alphabets:
// 'L'atin, 'C'yrillic, 'G'reek, 'I'nherited (combining marks), else common.
char script_of(uint32_t cp) {
  if ((cp >= 'A' && cp <= 'Z') || (cp >= 'a' && cp <= 'z') || cp == 0xAA || cp == 0xBA ||
      (cp >= 0xC0 && cp <= 0x24F && cp != 0xD7 && cp != 0xF7) || (cp >= 0x1E00 && cp <= 0x1EFF))
    return 'L';
  if ((cp >= 0x400 && cp <= 0x52F) || (cp >= 0x1C80 && cp <= 0x1C8F) ||
      (cp >= 0x2DE0 && cp <= 0x2DFF) || (cp >= 0xA640 && cp <= 0xA69F))
    return 'C';
  if (cp >= 0x370 && cp <= 0x3FF && cp != 0x37E && cp != 0x385 && cp != 0x387) return 'G';
  if (cp >= 0x300 && cp <= 0x36F) return 'I';
  return 0;
}

// raqm's paired characters: an opening one at an even index
const uint32_t kPaired[] = {0x28, 0x29, 0x3C, 0x3E, 0x5B, 0x5D, 0x7B, 0x7D, 0xAB, 0xBB,
                            0x2018, 0x2019, 0x201C, 0x201D, 0x2039, 0x203A, 0x3008, 0x3009,
                            0x300A, 0x300B, 0x300C, 0x300D, 0x300E, 0x300F, 0x3010, 0x3011};

int pair_index(uint32_t cp) {
  for (int k = 0; k < int(sizeof(kPaired) / sizeof(kPaired[0])); ++k)
    if (kPaired[k] == cp) return k;
  return -1;
}

std::vector<char> resolve_scripts(const std::vector<uint32_t>& text) {
  std::vector<char> s(text.size());
  std::vector<std::pair<char, int>> stack;
  char last = 0;
  for (size_t i = 0; i < text.size(); ++i) {
    char sc = script_of(text[i]);
    if (sc == 'I') {
      s[i] = last;
    } else if (sc) {
      s[i] = last = sc;
    } else {
      int p = pair_index(text[i]);
      if (p >= 0 && p % 2 == 0) {
        s[i] = last;
        stack.push_back({last, p});
      } else if (p >= 0) {
        while (!stack.empty() && stack.back().second != (p & ~1)) stack.pop_back();
        if (!stack.empty()) {
          s[i] = stack.back().first;
          stack.pop_back();
          if (s[i]) last = s[i];
        } else {
          s[i] = last;
        }
      } else {
        s[i] = last;
      }
    }
  }
  // characters before the first strong one take its script
  for (size_t i = text.size(); i-- > 1;)
    if (!s[i - 1]) s[i - 1] = s[i];
  return s;
}

uint32_t script_tag(char s) {
  switch (s) {
    case 'L': return tag_of("latn");
    case 'C': return tag_of("cyrl");
    case 'G': return tag_of("grek");
    default: return tag_of("DFLT");
  }
}

std::vector<Glyph> Font::shape(const std::vector<uint32_t>& text, int size) const {
  std::vector<Glyph> out;
  std::vector<char> scripts = resolve_scripts(text);
  int64_t xs = x_scale(size);
  // HarfBuzz's font scale from FreeType's (26.6 per em) and its em_mult factor
  int64_t hb_scale = (xs * upem_ + (1 << 15)) >> 16;
  int64_t x_mult = (hb_scale << 16) / upem_;
  size_t start = 0;
  while (start < text.size()) {
    size_t end = start + 1;
    while (end < text.size() && scripts[end] == scripts[start]) ++end;
    std::vector<Glyph> run;
    for (size_t k = start; k < end; ++k) {
      Glyph g;
      g.id = glyph_of(text[k]);
      run.push_back(g);
    }
    uint32_t tag = script_tag(scripts[start]);
    if (gsub_)
      for (uint16_t lk : lookups(gsub_, tag, true)) apply_gsub(lk, run);
    for (Glyph& g : run) {
      int64_t adv16 = mul_div(advance_units(g.id), xs, 64);  // 16.16, FT_Get_Advance
      g.x_advance = (adv16 + (1 << 9)) >> 10;
    }
    if (gpos_)
      for (uint16_t lk : lookups(gpos_, tag, false)) apply_gpos(lk, run, x_mult);
    out.insert(out.end(), run.begin(), run.end());
    start = end;
  }
  return out;
}

// ---- outlines ----------------------------------------------------------------

// a bound on a glyph's points, components included (a font is outside input)
constexpr size_t kMaxPoints = size_t(1) << 20;

void Font::load_glyph(uint32_t gid, int64_t scale, Outline& out, int depth) const {
  if (depth > 8) throw Fail("composite glyphs nest too deep");
  if (gid >= uint32_t(num_glyphs_)) throw Fail("glyph index out of range");
  uint32_t a, b;
  if (loca_long_) { a = u32(loca_ + 4 * gid); b = u32(loca_ + 4 * gid + 4); }
  else { a = 2u * u16(loca_ + 2 * gid); b = 2u * u16(loca_ + 2 * gid + 2); }
  if (b <= a) return;  // an empty glyph (the space)
  if (b > glyf_len_) throw Fail("glyph data past the glyf table");
  uint32_t g = glyf_ + a;
  int16_t contours = s16(g);
  if (contours >= 0) {
    uint32_t p = g + 10;
    size_t base = out.pts.size();
    int last = -1;
    for (int c = 0; c < contours; ++c) {
      int e = u16(p + 2 * c);
      if (e <= last && c) throw Fail("contour end points go backwards");
      last = e;
      out.ends.push_back(int(base) + e);
    }
    int n = contours ? last + 1 : 0;
    p += 2 * contours;
    p += 2 + u16(p);  // instructions: not run (no hinting)
    std::vector<uint8_t> flags;
    flags.reserve(n);
    while (int(flags.size()) < n) {
      uint8_t f = u8(p++);
      flags.push_back(f);
      if (f & 8) {
        uint8_t rep = u8(p++);
        for (int r = 0; r < rep && int(flags.size()) < n; ++r) flags.push_back(f);
      }
    }
    std::vector<int64_t> xs(n), ys(n);
    int64_t v = 0;
    for (int k = 0; k < n; ++k) {
      uint8_t f = flags[k];
      if (f & 2) { int d = u8(p++); v += (f & 16) ? d : -d; }
      else if (!(f & 16)) { v += s16(p); p += 2; }
      xs[k] = v;
    }
    v = 0;
    for (int k = 0; k < n; ++k) {
      uint8_t f = flags[k];
      if (f & 4) { int d = u8(p++); v += (f & 32) ? d : -d; }
      else if (!(f & 32)) { v += s16(p); p += 2; }
      ys[k] = v;
    }
    for (int k = 0; k < n; ++k)
      out.pts.push_back({mul_fix(xs[k], scale), mul_fix(ys[k], scale), bool(flags[k] & 1)});
    return;
  }
  // composite: each component loaded, transformed and offset in 26.6
  uint32_t p = g + 10;
  for (;;) {
    uint16_t flags = u16(p), comp = u16(p + 2);
    p += 4;
    int64_t arg1, arg2;
    if (flags & 1) { arg1 = s16(p); arg2 = s16(p + 2); p += 4; }
    else { arg1 = int8_t(u8(p)); arg2 = int8_t(u8(p + 1)); p += 2; }
    int64_t m[4] = {0x10000, 0, 0, 0x10000};  // 16.16
    bool transformed = false;
    if (flags & 8) { m[0] = m[3] = int64_t(s16(p)) * 4; p += 2; transformed = true; }
    else if (flags & 0x40) { m[0] = int64_t(s16(p)) * 4; m[3] = int64_t(s16(p + 2)) * 4; p += 4; transformed = true; }
    else if (flags & 0x80) {
      m[0] = int64_t(s16(p)) * 4; m[2] = int64_t(s16(p + 2)) * 4;
      m[1] = int64_t(s16(p + 4)) * 4; m[3] = int64_t(s16(p + 6)) * 4;
      p += 8; transformed = true;
    }
    Outline sub;
    load_glyph(comp, scale, sub, depth + 1);
    if (transformed)
      for (Point& q : sub.pts) {
        int64_t x = q.x, y = q.y;
        q.x = mul_fix(x, m[0]) + mul_fix(y, m[1]);
        q.y = mul_fix(x, m[2]) + mul_fix(y, m[3]);
      }
    int64_t dx, dy;
    if (flags & 2) {  // offsets in font units
      dx = arg1; dy = arg2;
      if (transformed && (flags & 0x800) && !(flags & 0x1000)) {  // SCALED_COMPONENT_OFFSET
        int64_t sx = dx, sy = dy;
        dx = mul_fix(sx, m[0]) + mul_fix(sy, m[1]);
        dy = mul_fix(sx, m[2]) + mul_fix(sy, m[3]);
      }
      dx = mul_fix(dx, scale);
      dy = mul_fix(dy, scale);
    } else {  // point matching: a point of the glyph so far onto one of the component
      size_t k1 = size_t(arg1), k2 = size_t(arg2);
      if (k1 >= out.pts.size() || k2 >= sub.pts.size()) throw Fail("bad composite point index");
      dx = out.pts[k1].x - sub.pts[k2].x;
      dy = out.pts[k1].y - sub.pts[k2].y;
    }
    size_t base = out.pts.size();
    if (base + sub.pts.size() > kMaxPoints) throw Fail("composite glyph has too many points");
    for (Point q : sub.pts) out.pts.push_back({q.x + dx, q.y + dy, q.on});
    for (int e : sub.ends) out.ends.push_back(int(base) + e);
    if (!(flags & 0x20)) break;
  }
}

Outline Font::outline(uint32_t gid, int size) const {
  Outline o;
  load_glyph(gid, x_scale(size), o, 0);
  return o;
}

// ---- the rasterizer ----------------------------------------------------------

constexpr int kBits = 8;  // cells of 1/256 pixel
constexpr int64_t kOne = 1 << kBits;

struct Raster {
  int w, h;  // pixels
  std::vector<int64_t> cover, area;  // (w + 1) x h cells, row 0 at the bottom

  Raster(int w_, int h_) : w(w_), h(h_), cover(size_t(w_ + 1) * h_), area(size_t(w_ + 1) * h_) {}

  static int64_t floor_div(int64_t a, int64_t b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

  // a piece inside one pixel row (ya, yb within [r, r + 1] pixels)
  void row_piece(int64_t xa, int64_t ya, int64_t xb, int64_t yb, int64_t row) {
    if (ya == yb) return;
    int64_t x0 = std::min(xa, xb), x1 = std::max(xa, xb);
    int64_t c0 = floor_div(x0, kOne), c1 = floor_div(x1, kOne);
    if (x1 == c1 * kOne && c1 > c0) --c1;  // ends on a cell boundary
    if (c0 == c1) {
      cell(c0, row, xa - c0 * kOne, xb - c0 * kOne, yb - ya);
      return;
    }
    // split at each vertical cell boundary crossed, y found by exact division
    int64_t dx = xb - xa, dy = yb - ya;
    int step = dx > 0 ? 1 : -1;
    int64_t c = floor_div(xa, kOne);
    if (dx < 0 && xa == c * kOne) --c;
    int64_t px = xa, py = ya;
    for (;;) {
      int64_t edge = step > 0 ? (c + 1) * kOne : c * kOne;
      bool last = step > 0 ? xb <= edge : xb >= edge;
      if (last) {
        cell(c, row, px - c * kOne, xb - c * kOne, yb - py);
        return;
      }
      // y at x = edge: ya + dy * (edge - xa) / dx, rounded to nearest
      int64_t ny = ya + round_div(dy * (edge - xa), dx);
      cell(c, row, px - c * kOne, edge - c * kOne, ny - py);
      px = edge;
      py = ny;
      c += step;
    }
  }

  void cell(int64_t cx, int64_t row, int64_t fa, int64_t fb, int64_t dy) {
    if (row < 0 || row >= h || dy == 0) return;
    if (cx < 0) { cx = 0; fa = fb = 0; }  // left of the bitmap: full cover
    if (cx > w) return;                   // right of it: covers nothing inside
    size_t k = size_t(row) * (w + 1) + size_t(cx);
    cover[k] += dy;
    area[k] += (fa + fb) * dy;
  }

  void line(int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
    if (y1 == y2) return;
    int64_t dy = y2 - y1, dx = x2 - x1;
    int step = dy > 0 ? 1 : -1;
    int64_t r = floor_div(y1, kOne);
    if (dy < 0 && y1 == r * kOne) --r;
    int64_t px = x1, py = y1;
    for (;;) {
      int64_t edge = step > 0 ? (r + 1) * kOne : r * kOne;
      bool last = step > 0 ? y2 <= edge : y2 >= edge;
      if (last) {
        row_piece(px, py, x2, y2, r);
        return;
      }
      int64_t nx = x1 + round_div(dx * (edge - y1), dy);
      row_piece(px, py, nx, edge, r);
      px = nx;
      py = edge;
      r += step;
    }
  }

  // quadratic arc from p0 over p1 to p2, split into 2^k lines
  void conic(int64_t x0, int64_t y0, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
    int64_t ddx = std::abs(x0 + x2 - 2 * x1), ddy = std::abs(y0 + y2 - 2 * y1);
    int64_t dev = std::max(ddx, ddy);
    int shift = 0;
    do { dev >>= 2; ++shift; } while (dev > kOne / 4);
    int64_t n = int64_t(1) << shift;
    int64_t ax = x0 + x2 - 2 * x1, bx = x1 - x0, ay = y0 + y2 - 2 * y1, by = y1 - y0;
    int64_t px = x0, py = y0, nn = n * n;
    for (int64_t k = 1; k <= n; ++k) {
      // P(k/n) = P0 + (2 B k n + A k^2) / n^2
      int64_t tx = 2 * bx * k * n + ax * k * k, ty = 2 * by * k * n + ay * k * k;
      int64_t nx = k == n ? x2 : x0 + round_div(tx, nn), ny = k == n ? y2 : y0 + round_div(ty, nn);
      line(px, py, nx, ny);
      px = nx;
      py = ny;
    }
  }

  // coverage 0..255 of pixel (x, row), row 0 at the bottom, written top-down
  void sweep(std::vector<uint8_t>& out) const {
    out.assign(size_t(w) * h, 0);
    for (int r = 0; r < h; ++r) {
      int64_t acc = 0;
      const int64_t* cv = &cover[size_t(r) * (w + 1)];
      const int64_t* ar = &area[size_t(r) * (w + 1)];
      uint8_t* dst = &out[size_t(h - 1 - r) * w];
      for (int x = 0; x < w; ++x) {
        int64_t raw = (acc + cv[x]) * 2 * kOne - ar[x];
        acc += cv[x];
        int64_t c = raw >> (kBits * 2 + 1 - 8);
        if (c < 0) c = ~c;
        dst[x] = uint8_t(c > 255 ? 255 : c);
      }
    }
  }
};

struct Bitmap {
  int left = 0, top = 0, w = 0, h = 0;  // pixels; top is the row above the baseline, y up
  std::vector<uint8_t> px;              // top-down rows
};

struct Box {
  int64_t x0, y0, x1, y1;  // 26.6 control box
};

Box control_box(const Outline& o) {
  Box b{0, 0, 0, 0};
  if (o.pts.empty()) return b;
  b = {o.pts[0].x, o.pts[0].y, o.pts[0].x, o.pts[0].y};
  for (const Point& p : o.pts) {
    b.x0 = std::min(b.x0, p.x); b.y0 = std::min(b.y0, p.y);
    b.x1 = std::max(b.x1, p.x); b.y1 = std::max(b.y1, p.y);
  }
  return b;
}

Bitmap render(const Outline& o) {
  Bitmap bm;
  if (o.pts.empty()) return bm;
  Box b = control_box(o);
  int64_t x0 = floor64(b.x0), y0 = floor64(b.y0), x1 = ceil64(b.x1), y1 = ceil64(b.y1);
  bm.left = int(x0 >> 6);
  bm.top = int(y1 >> 6);
  bm.w = int((x1 - x0) >> 6);
  bm.h = int((y1 - y0) >> 6);
  if (bm.w <= 0 || bm.h <= 0) { bm.w = bm.h = 0; return bm; }
  if (int64_t(bm.w) * bm.h > (int64_t(1) << 26)) throw Fail("glyph bitmap too large");
  Raster ras(bm.w, bm.h);
  auto X = [&](int64_t v) { return (v - x0) * (kOne / 64); };
  auto Y = [&](int64_t v) { return (v - y0) * (kOne / 64); };
  size_t first = 0;
  for (int end : o.ends) {
    size_t last = size_t(end);
    if (last < first || last >= o.pts.size()) throw Fail("bad contour");
    size_t n = last - first + 1;
    if (n >= 2) {
      auto pt = [&](size_t k) { return o.pts[first + (k % n)]; };
      // start on an on-curve point, or the midpoint of two off-curve ones
      int64_t sx, sy;
      size_t k0 = 0;
      while (k0 < n && !pt(k0).on) ++k0;
      if (k0 == n) {
        sx = (pt(0).x + pt(1).x) / 2;  // all off-curve
        sy = (pt(0).y + pt(1).y) / 2;
        k0 = 0;
      } else {
        sx = pt(k0).x;
        sy = pt(k0).y;
      }
      int64_t cx = sx, cy = sy;
      bool have_ctrl = false;
      int64_t qx = 0, qy = 0;
      for (size_t s = 1; s <= n; ++s) {
        Point p = pt(k0 + s);
        if (p.on) {
          if (have_ctrl) ras.conic(X(cx), Y(cy), X(qx), Y(qy), X(p.x), Y(p.y));
          else ras.line(X(cx), Y(cy), X(p.x), Y(p.y));
          cx = p.x; cy = p.y; have_ctrl = false;
        } else if (have_ctrl) {
          int64_t mx = (qx + p.x) / 2, my = (qy + p.y) / 2;
          ras.conic(X(cx), Y(cy), X(qx), Y(qy), X(mx), Y(my));
          cx = mx; cy = my; qx = p.x; qy = p.y;
        } else {
          qx = p.x; qy = p.y; have_ctrl = true;
        }
      }
      // close back to the start
      if (have_ctrl) ras.conic(X(cx), Y(cy), X(qx), Y(qy), X(sx), Y(sy));
      else if (cx != sx || cy != sy) ras.line(X(cx), Y(cy), X(sx), Y(sy));
    }
    first = last + 1;
  }
  ras.sweep(bm.px);
  return bm;
}

int64_t pixel(int64_t v) { return (v + 32) >> 6; }  // PIL's PIXEL: nearest, halves up

// A glyph's bottom in the text box, in pixels.  FreeType hints the DejaVu
// outlines vertically, which snaps a bottom to the pixel grid; without the
// bytecode this rounds (halves away from zero) and takes an overshoot below
// the baseline of less than 3/4 pixel as the baseline itself.  Against
// PIL's hinted boxes this gives the line's baseline row on 86% of the
// generator's lines at font size 44 and 95% at 67 (six DejaVu fonts).
int64_t box_bottom(int64_t v) {
  if (v > -48 && v < 0) return 0;
  return v >= 0 ? (v + 32) >> 6 : -((-v + 32) >> 6);
}

struct Layout {
  std::vector<Glyph> glyphs;
  std::vector<int64_t> pen_px;  // each glyph's origin, whole pixels
  std::vector<Outline> outlines;
  int64_t x_min = 0, x_max = 0, y_min = 0, y_max = 0, ascender = 0, descender = 0;  // pixels
};

Layout lay_out(const Font& f, const std::vector<uint32_t>& text, int size) {
  Layout L;
  L.glyphs = f.shape(text, size);
  int64_t pos = 0;
  for (const Glyph& g : L.glyphs) {
    int64_t px = pixel(pos + g.x_offset);
    pos += g.x_advance;
    L.x_max = std::max(L.x_max, pixel(pos));
    Outline o = f.outline(g.id, size);
    if (!o.pts.empty()) {
      Box b = control_box(o);
      L.x_min = std::min(L.x_min, (floor64(b.x0) >> 6) + px);
      L.x_max = std::max(L.x_max, (ceil64(b.x1) >> 6) + px);
      L.y_min = std::min(L.y_min, box_bottom(b.y0));
      L.y_max = std::max(L.y_max, pixel(b.y1));
    }
    L.pen_px.push_back(px);
    L.outlines.push_back(std::move(o));
  }
  L.ascender = f.ascender(size) >> 6;
  L.descender = f.descender(size) >> 6;
  return L;
}

void put_msg(char* msg, int64_t len, const std::string& s) {
  if (!msg || len <= 0) return;
  size_t n = std::min<size_t>(size_t(len - 1), s.size());
  std::memcpy(msg, s.data(), n);
  msg[n] = 0;
}

}  // namespace

extern "C" {

// Parse a font file's bytes; *handle gets the font (free with rcnn_tt_close).
int64_t rcnn_tt_open(const uint8_t* data, int64_t n, int64_t* handle, char* msg, int64_t msg_len) {
  try {
    if (!data || n < 12) throw Fail("too short for a font file");
    Font* f = new Font(std::vector<uint8_t>(data, data + n));
    *handle = reinterpret_cast<int64_t>(f);
    return 0;
  } catch (const std::exception& e) {
    put_msg(msg, msg_len, e.what());
    return -1;
  }
}

int64_t rcnn_tt_close(int64_t handle) {
  delete reinterpret_cast<Font*>(handle);
  return 0;
}

// Shape `n` code points at pixel `size`: glyph ids, x advances and x
// offsets (26.6) into arrays of `cap`; returns the glyph count.
int64_t rcnn_tt_shape(int64_t handle, int64_t size, const uint32_t* text, int64_t n, int32_t* ids,
                      int64_t* advances, int64_t* offsets, int64_t cap, char* msg, int64_t msg_len) {
  try {
    const Font* f = reinterpret_cast<const Font*>(handle);
    std::vector<Glyph> g = f->shape(std::vector<uint32_t>(text, text + n), int(size));
    if (int64_t(g.size()) > cap) throw Fail("more glyphs than the output holds");
    for (size_t k = 0; k < g.size(); ++k) {
      ids[k] = int32_t(g[k].id);
      advances[k] = g[k].x_advance;
      offsets[k] = g[k].x_offset;
    }
    return int64_t(g.size());
  } catch (const std::exception& e) {
    put_msg(msg, msg_len, e.what());
    return -1;
  }
}

// The text's box as PIL's font.getbbox(text) gives it with the 'la'
// anchor: box[0..3] = left, top, right, bottom (pixels, y down, top at the
// ascender); box[4], box[5] = ascender, descender (pixels, y up).
int64_t rcnn_tt_text_box(int64_t handle, int64_t size, const uint32_t* text, int64_t n,
                         int64_t* box, char* msg, int64_t msg_len) {
  try {
    const Font* f = reinterpret_cast<const Font*>(handle);
    Layout L = lay_out(*f, std::vector<uint32_t>(text, text + n), int(size));
    box[0] = L.x_min;
    box[1] = L.ascender - L.y_max;
    box[2] = L.x_max;
    box[3] = L.ascender - L.y_min;
    box[4] = L.ascender;
    box[5] = L.descender;
    return 0;
  } catch (const std::exception& e) {
    put_msg(msg, msg_len, e.what());
    return -1;
  }
}

// draw.text((x, y), text, fill=ink) on a uint8 canvas [h, w] as PIL draws
// it in mode L with the 'la' anchor.
int64_t rcnn_tt_draw(int64_t handle, int64_t size, const uint32_t* text, int64_t n,
                     uint8_t* canvas, int64_t h, int64_t w, int64_t x, int64_t y, int64_t ink,
                     char* msg, int64_t msg_len) {
  try {
    const Font* f = reinterpret_cast<const Font*>(handle);
    Layout L = lay_out(*f, std::vector<uint32_t>(text, text + n), int(size));
    int64_t mw = L.x_max - L.x_min;
    if (mw <= 0) return 0;
    // glyph coverage combined by maximum in a mask spanning the text's
    // columns and every row a glyph reaches
    int64_t top = L.y_max, bottom = L.y_min;
    std::vector<Bitmap> bms;
    for (const Outline& o : L.outlines) {
      bms.push_back(render(o));
      if (bms.back().w) {
        top = std::max<int64_t>(top, bms.back().top);
        bottom = std::min<int64_t>(bottom, bms.back().top - bms.back().h);
      }
    }
    int64_t mh = top - bottom;
    if (mw * mh > (int64_t(1) << 28)) throw Fail("text mask too large");
    std::vector<uint8_t> mask(size_t(mw * mh), 0);
    for (size_t k = 0; k < bms.size(); ++k) {
      const Bitmap& bm = bms[k];
      for (int r = 0; r < bm.h; ++r) {
        int64_t my = top - bm.top + r;
        for (int c = 0; c < bm.w; ++c) {
          int64_t mx = L.pen_px[k] + bm.left + c - L.x_min;
          if (mx < 0 || mx >= mw) continue;
          uint8_t v = bm.px[size_t(r) * bm.w + c];
          uint8_t& t = mask[size_t(my * mw + mx)];
          if (t < v) t = v;
        }
      }
    }
    // the mask's origin on the canvas: (x + x_min, y + ascender - top)
    int64_t ox = x + L.x_min, oy = y + L.ascender - top;
    for (int64_t r = 0; r < mh; ++r) {
      int64_t cy = oy + r;
      if (cy < 0 || cy >= h) continue;
      for (int64_t c = 0; c < mw; ++c) {
        int64_t cx = ox + c;
        if (cx < 0 || cx >= w) continue;
        int m = mask[size_t(r * mw + c)];
        uint8_t& out = canvas[cy * w + cx];
        int t = out * (255 - m) + int(ink) * m + 128;
        out = uint8_t(((t >> 8) + t) >> 8);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    put_msg(msg, msg_len, e.what());
    return -1;
  }
}

}  // extern "C"
