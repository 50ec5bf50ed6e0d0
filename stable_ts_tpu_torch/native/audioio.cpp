// Native audio decoding for stable_ts_tpu_torch.
//
// Self-contained FLAC decoder (the reference shells out to ffmpeg for all
// decode work — audio/utils.py:63-125; this build has no ffmpeg). Supports
// the full FLAC subset in practice: constant/verbatim/fixed/LPC subframes,
// rice/rice2 residual coding, all channel assignments (independent,
// left-side, right-side, mid-side), wasted bits, 8/12/16/20/24/32 bps,
// variable and fixed block sizes.
//
// C ABI (ctypes):
//   int flac_decode(const uint8_t* data, size_t len,
//                   int32_t** out, int64_t* n_frames, int* sr, int* channels,
//                   int* bps);
//   void free_samples(int32_t* p);
// Returns 0 on success; negative error codes otherwise.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool eof() const { return byte_pos_ >= len_; }
  size_t byte_pos() const { return byte_pos_; }

  void align_to_byte() {
    if (bit_pos_) {
      bit_pos_ = 0;
      ++byte_pos_;
    }
  }

  void seek_byte(size_t pos) {
    byte_pos_ = pos;
    bit_pos_ = 0;
  }

  // Read up to 32 bits (unsigned).
  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      v = (v << 1) | read_bit();
    }
    return v;
  }

  uint64_t read_bits64(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      v = (v << 1) | read_bit();
    }
    return v;
  }

  int32_t read_signed(int n) {
    uint32_t v = read_bits(n);
    // sign-extend
    if (n > 0 && n < 32 && (v & (1u << (n - 1)))) {
      v |= ~((1u << n) - 1);
    }
    return static_cast<int32_t>(v);
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!failed_ && read_bit() == 0) ++q;
    return q;
  }

  uint32_t read_bit() {
    if (byte_pos_ >= len_) {
      failed_ = true;
      return 0;
    }
    uint32_t bit = (data_[byte_pos_] >> (7 - bit_pos_)) & 1u;
    if (++bit_pos_ == 8) {
      bit_pos_ = 0;
      ++byte_pos_;
    }
    return bit;
  }

  bool failed() const { return failed_; }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t byte_pos_ = 0;
  int bit_pos_ = 0;
  bool failed_ = false;
};

struct StreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

// Extended UTF-8 coded number (frame/sample index), up to 56 bits.
bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t first = br.read_bits(8);
  if (br.failed()) return false;
  int extra;
  uint64_t v;
  if ((first & 0x80) == 0) { v = first; extra = 0; }
  else if ((first & 0xE0) == 0xC0) { v = first & 0x1F; extra = 1; }
  else if ((first & 0xF0) == 0xE0) { v = first & 0x0F; extra = 2; }
  else if ((first & 0xF8) == 0xF0) { v = first & 0x07; extra = 3; }
  else if ((first & 0xFC) == 0xF8) { v = first & 0x03; extra = 4; }
  else if ((first & 0xFE) == 0xFC) { v = first & 0x01; extra = 5; }
  else if (first == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = br.read_bits(8);
    if (br.failed() || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Decode one residual partition set into warmed-up buffer (order..block_size).
bool read_residuals(BitReader& br, uint32_t block_size, uint32_t order,
                    std::vector<int64_t>& buf) {
  uint32_t method = br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0x0F : 0x1F;
  uint32_t part_order = br.read_bits(4);
  uint32_t n_parts = 1u << part_order;
  if ((block_size >> part_order) < order && n_parts > 1) {
    // first partition must still hold at least `order` fewer samples
  }
  uint32_t idx = order;
  for (uint32_t p = 0; p < n_parts; ++p) {
    uint32_t count = block_size >> part_order;
    if (p == 0) {
      if (count < order) return false;
      count -= order;
    }
    uint32_t param = br.read_bits(param_bits);
    if (param == escape) {
      uint32_t raw_bits = br.read_bits(5);
      for (uint32_t i = 0; i < count; ++i) {
        buf[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint32_t r = param ? br.read_bits(param) : 0;
        uint64_t u = (static_cast<uint64_t>(q) << param) | r;
        // zigzag decode
        int64_t v = (u >> 1) ^ -static_cast<int64_t>(u & 1);
        buf[idx++] = v;
      }
    }
    if (br.failed()) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, uint32_t block_size, uint32_t bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  uint32_t type = br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bits(1)) {  // wasted bits flag
    wasted = br.read_unary() + 1;
  }
  if (br.failed()) return false;
  bps -= wasted;
  out.assign(block_size, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
    uint32_t order = type - 8;
    for (uint32_t i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!read_residuals(br, block_size, order, out)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (uint32_t i = 1; i < block_size; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < block_size; ++i)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < block_size; ++i)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < block_size; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC, order 1-32
    uint32_t order = (type & 0x1F) + 1;
    for (uint32_t i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t precision = br.read_bits(4);
    if (precision == 0x0F) return false;
    precision += 1;
    int32_t shift = br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (uint32_t i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!read_residuals(br, block_size, order, out)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (uint32_t j = 0; j < order; ++j) {
        pred += coefs[j] * out[i - 1 - j];
      }
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
  }
  return !br.failed();
}

}  // namespace

extern "C" {

int flac_decode(const uint8_t* data, size_t len, int32_t** out,
                int64_t* n_frames_out, int* sr_out, int* channels_out,
                int* bps_out) {
  if (len < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  StreamInfo info;
  bool have_info = false;
  // metadata blocks
  while (pos + 4 <= len) {
    uint8_t header = data[pos];
    bool last = header & 0x80;
    uint8_t type = header & 0x7F;
    uint32_t size = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (type == 0 && size >= 34) {  // STREAMINFO
      const uint8_t* b = data + pos;
      info.min_block = (b[0] << 8) | b[1];
      info.max_block = (b[2] << 8) | b[3];
      info.sample_rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4);
      info.channels = ((b[12] >> 1) & 0x07) + 1;
      info.bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      info.total_samples = (static_cast<uint64_t>(b[13] & 0x0F) << 32) |
                           (static_cast<uint64_t>(b[14]) << 24) |
                           (b[15] << 16) | (b[16] << 8) | b[17];
      have_info = true;
    }
    pos += size;
    if (last) break;
  }
  if (!have_info || info.sample_rate == 0 || info.channels == 0) return -2;

  std::vector<int32_t> pcm;  // interleaved
  if (info.total_samples) {
    pcm.reserve(static_cast<size_t>(info.total_samples * info.channels));
  }

  BitReader br(data, len);
  br.seek_byte(pos);
  std::vector<std::vector<int64_t>> chan(info.channels);

  while (true) {
    br.align_to_byte();
    if (br.byte_pos() + 2 > len) break;
    // frame sync: 14 bits 0b11111111111110
    uint32_t sync = br.read_bits(14);
    if (br.failed()) break;
    if (sync != 0x3FFE) return -3;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);  // reserved
    uint64_t frame_number;
    if (!read_utf8_number(br, &frame_number)) return -4;

    uint32_t block_size;
    if (bs_code == 0) return -5;
    else if (bs_code == 1) block_size = 192;
    else if (bs_code <= 5) block_size = 576u << (bs_code - 2);
    else if (bs_code == 6) block_size = br.read_bits(8) + 1;
    else if (bs_code == 7) block_size = br.read_bits(16) + 1;
    else block_size = 256u << (bs_code - 8);

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    uint32_t bps = info.bps;
    switch (ss_code) {
      case 0: break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -6;
    }
    br.read_bits(8);  // CRC-8 (unchecked)

    uint32_t n_ch;
    int assignment = 0;  // 0=independent, 1=left-side, 2=right-side, 3=mid-side
    if (ch_code < 8) {
      n_ch = ch_code + 1;
    } else if (ch_code == 8) { n_ch = 2; assignment = 1; }
    else if (ch_code == 9) { n_ch = 2; assignment = 2; }
    else if (ch_code == 10) { n_ch = 2; assignment = 3; }
    else return -7;
    if (n_ch != info.channels) return -8;

    for (uint32_t c = 0; c < n_ch; ++c) {
      uint32_t sub_bps = bps;
      if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) ||
          (assignment == 3 && c == 1)) {
        sub_bps += 1;  // side channel carries one extra bit
      }
      if (!decode_subframe(br, block_size, sub_bps, chan[c])) return -9;
    }
    br.align_to_byte();
    br.read_bits(16);  // CRC-16 (unchecked)
    if (br.failed()) return -10;

    // undo inter-channel decorrelation
    if (assignment == 1) {  // left-side: ch0=left, ch1=side; right = left - side
      for (uint32_t i = 0; i < block_size; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (assignment == 2) {  // right-side: ch0=side, ch1=right; left = right + side
      for (uint32_t i = 0; i < block_size; ++i) chan[0][i] = chan[0][i] + chan[1][i];
    } else if (assignment == 3) {  // mid-side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t mid = chan[0][i];
        int64_t side = chan[1][i];
        mid = (mid << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    for (uint32_t i = 0; i < block_size; ++i) {
      for (uint32_t c = 0; c < n_ch; ++c) {
        pcm.push_back(static_cast<int32_t>(chan[c][i]));
      }
    }
    if (info.total_samples &&
        pcm.size() >= info.total_samples * info.channels) {
      break;
    }
  }

  int64_t n_frames = static_cast<int64_t>(pcm.size() / info.channels);
  if (info.total_samples && n_frames > static_cast<int64_t>(info.total_samples)) {
    n_frames = static_cast<int64_t>(info.total_samples);
  }
  auto* buf = static_cast<int32_t*>(malloc(sizeof(int32_t) * n_frames * info.channels));
  if (!buf) return -11;
  memcpy(buf, pcm.data(), sizeof(int32_t) * n_frames * info.channels);
  *out = buf;
  *n_frames_out = n_frames;
  *sr_out = static_cast<int>(info.sample_rate);
  *channels_out = static_cast<int>(info.channels);
  *bps_out = static_cast<int>(info.bps);
  return 0;
}

void free_samples(int32_t* p) { free(p); }

}  // extern "C"
