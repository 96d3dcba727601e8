// GIF's LZW in host C++, as OpenCV's GIF reader decodes a frame.
//
// GIF's LZW is not TIFF's: codes are read least significant bit first,
// starting at `min_code_size` + 1 bits (OpenCV takes minimum code sizes 2
// to 11), with Clear (1 << min_code_size) resetting the table and the
// width, and the width growing by one when the next free entry reaches
// 1 << width, up to 12 bits.  A table of 4,096 entries stays full until a
// Clear (a "deferred clear"): codes keep their 12 bits and add no entries.
// A code equal to the next free entry is the previous string plus its own
// first index.  End of Information (Clear + 1) acts as OpenCV's decoder
// takes it: as a Clear while data follows it, as the end where none does
// (codes left in its last byte are dropped).
//
// Codes past a full frame, as OpenCV's reader takes them: a string that
// starts inside the frame and runs past its end fails; strings after the
// frame's last index are dropped, unless the data goes on past the byte
// that completed them (then the frame fails).
//
// Errors, where OpenCV fails the frame (and cv2.imdecode returns None):
// return -1 with a message: a code past the next free entry (or equal to
// it right after a Clear), indices past the frame as above, or data that
// ends before the frame is full.

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace {

void set_message(char* msg, int64_t msg_len, const std::string& text) {
  if (msg != nullptr && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", text.c_str());
  }
}

constexpr int kMaxBits = 12, kSize = 1 << kMaxBits;

}  // namespace

// Decodes the LZW data `src[0:n]` (a frame's sub-blocks joined) into
// `dst[0:dst_len]` (colour indices).  Returns the indices the data held
// (dst_len or more, those past dst_len dropped), or -1 with a message.
extern "C" int64_t rcnn_gif_lzw_decode(const uint8_t* src, int64_t n, int64_t min_code_size,
                                       uint8_t* dst, int64_t dst_len, char* msg,
                                       int64_t msg_len) {
  if (src == nullptr || dst == nullptr || n < 0 || dst_len < 0) return -1;
  if (min_code_size < 2 || min_code_size > 11) {
    set_message(msg, msg_len, "LZW minimum code size out of range");
    return -1;
  }
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<int32_t> prefix(kSize, -1);
  std::vector<uint8_t> suffix(kSize, 0), first(kSize, 0);
  std::vector<uint16_t> length(kSize, 0);
  for (int i = 0; i < clear; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int width = static_cast<int>(min_code_size) + 1, next = eoi + 1, prev = -1;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t pos = 0, out = 0;
  while (true) {
    while (nacc < width && pos < n) {
      if (out > dst_len) {  // indices past the frame, and more data to read
        set_message(msg, msg_len, "LZW data holds more indices than the frame");
        return -1;
      }
      acc |= static_cast<uint64_t>(src[pos++]) << nacc;
      nacc += 8;
    }
    if (nacc < width) break;  // the data ends without End of Information
    const int code = static_cast<int>(acc & ((1u << width) - 1));
    acc >>= width;
    nacc -= width;
    if (code == clear) {
      width = static_cast<int>(min_code_size) + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi && pos >= n) break;
    if (code == eoi) {
      width = static_cast<int>(min_code_size) + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code > next || (code == next && prev < 0)) {
      set_message(msg, msg_len, "LZW code past the table");
      return -1;
    }
    int len;
    if (prev >= 0 && next < kSize) {  // the new entry: prev + the first index of code
      const uint8_t k = code == next ? first[prev] : first[code];
      prefix[next] = prev;
      suffix[next] = k;
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
      if (next == (1 << width) && width < kMaxBits) ++width;
    }
    len = length[code];
    if (out >= dst_len) {  // past a full frame: counted, not written
      out += len;
      prev = code;
      continue;
    }
    if (out + len > dst_len) {
      set_message(msg, msg_len, "LZW string runs past the end of the frame");
      return -1;
    }
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      dst[out + i] = suffix[c];
      c = prefix[c];
    }
    out += len;
    prev = code;
  }
  if (out < dst_len) {
    set_message(msg, msg_len, "LZW data ends before the frame is full");
    return -1;
  }
  return out;
}
