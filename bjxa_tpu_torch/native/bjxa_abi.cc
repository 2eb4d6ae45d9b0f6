// bjxa-tpu drop-in C ABI — libbjxa-compatible implementation.
//
// Implements the 19 reference symbols (reference src/bjxa.h /
// src/libbjxa.map) on top of the bjxa-tpu native codec core (xa_core.h).
// The *observable contract* — prototypes, bjxa_format_t layout, return
// values, and the errno taxonomy (EFAULT/EINVAL/ENOBUFS/EPROTO/EIO,
// reference bjxa.3.rst.in:205-276) — matches the reference so existing C
// users can switch by relinking.  The design underneath is this project's
// own: plain value structs with explicit progress counters and the shared
// whole-block primitives, no function-pointer dispatch, no per-sample
// callbacks.
//
// Known deliberate divergence (PARITY.md "Known divergences"): a stereo
// data_len that is a whole number of single-channel blocks but not of
// effective blocks is rejected at parse time with EPROTO; reference
// assert builds SIGABRT on it later, NDEBUG builds floor the block count.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

#include "xa_core.h"

#include "include/bjxa.h"

namespace {

using bjxa_core::kBlockSamples;

constexpr uint32_t kDecoderMagic = 0x7A58441Du;
constexpr uint32_t kEncoderMagic = 0x7A58451Eu;

// ---------------------------------------------------------------------------
// little-endian buffer primitives (host-endian independent)

inline uint32_t rd_le(const uint8_t** p, int nbytes) {
  uint32_t v = 0;
  for (int i = 0; i < nbytes; i++)
    v |= static_cast<uint32_t>((*p)[i]) << (8 * i);
  *p += nbytes;
  return v;
}

inline void wr_le(uint8_t** p, uint32_t v, int nbytes) {
  for (int i = 0; i < nbytes; i++)
    (*p)[i] = static_cast<uint8_t>(v >> (8 * i));
  *p += nbytes;
}

inline bool tag_eq(const uint8_t** p, const char* tag) {
  const size_t n = std::strlen(tag);
  const bool ok = std::memcmp(*p, tag, n) == 0;
  *p += n;
  return ok;
}

// ---------------------------------------------------------------------------
// codec objects

struct StreamInfo {
  uint32_t data_len;  // XA payload bytes
  uint32_t samples;   // PCM frames per channel
  uint16_t rate;
  uint8_t bits;
  uint8_t channels;

  uint32_t block_size() const { return bjxa_core::block_size_for(bits); }
  uint32_t block_size_xa() const { return block_size() * channels; }
  uint32_t block_size_pcm() const { return kBlockSamples * channels * 2; }
  uint32_t blocks() const { return data_len / block_size_xa(); }
  uint32_t data_len_pcm() const { return samples * channels * 2; }
};

// Remaining work, counted down block by block (the analog of the
// reference's embedded bjxa_format_t progress, src/libbjxa.c:654-657).
struct Progress {
  uint32_t blocks;
  uint32_t pcm_left;
};

}  // namespace

struct bjxa_decoder {
  uint32_t magic;
  bool ready;
  StreamInfo si;
  Progress pr;
  int32_t taps[2][2];
};

struct bjxa_encoder {
  uint32_t magic;
  bool ready;
  bool search;
  StreamInfo si;
  Progress pr;
  int32_t taps[2][2];
};

namespace {

// errno-contract helpers.  Each returns true when the check FAILED (errno
// already set), so call sites read as `if (bad_obj(dec)) return -1;`.

inline bool bad_ptr(const void* p) {
  if (p != nullptr) return false;
  errno = EFAULT;
  return true;
}

template <typename T>
inline bool bad_obj(const T* o, uint32_t magic) {
  if (bad_ptr(o)) return true;
  if (o->magic != magic) {
    errno = EINVAL;
    return true;
  }
  return false;
}

inline bool fail(int err) {
  errno = err;
  return true;
}

// Validation matrix shared with the Python parser (format/xa.py::validate,
// mirroring reference src/libbjxa.c:425-437).  Returns false with
// errno=EPROTO on any violation.
bool validate_xa(const StreamInfo& si) {
  if (si.data_len == 0 || si.samples == 0 || si.rate == 0) return !fail(EPROTO);
  if (si.bits != 4 && si.bits != 6 && si.bits != 8) return !fail(EPROTO);
  if (si.channels != 1 && si.channels != 2) return !fail(EPROTO);
  if (si.data_len % si.block_size() != 0) return !fail(EPROTO);
  if (si.data_len % si.block_size_xa() != 0) return !fail(EPROTO);
  const uint64_t max_samples =
      (static_cast<uint64_t>(kBlockSamples) * si.data_len) /
      (si.block_size() * si.channels);
  if (max_samples < si.samples) return !fail(EPROTO);
  if (max_samples - si.samples >= kBlockSamples) return !fail(EPROTO);
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// lifecycle

bjxa_decoder_t* bjxa_decoder(void) {
  errno = 0;
  auto* dec =
      static_cast<bjxa_decoder_t*>(std::calloc(1, sizeof(bjxa_decoder_t)));
  if (dec != nullptr) dec->magic = kDecoderMagic;
  return dec;
}

int bjxa_free_decoder(bjxa_decoder_t** decp) {
  if (bad_ptr(decp) || bad_obj(*decp, kDecoderMagic)) return -1;
  std::memset(*decp, 0, sizeof(**decp));
  std::free(*decp);
  *decp = nullptr;
  return 0;
}

bjxa_encoder_t* bjxa_encoder(void) {
  errno = 0;
  auto* enc =
      static_cast<bjxa_encoder_t*>(std::calloc(1, sizeof(bjxa_encoder_t)));
  if (enc != nullptr) enc->magic = kEncoderMagic;
  return enc;
}

int bjxa_free_encoder(bjxa_encoder_t** encp) {
  if (bad_ptr(encp) || bad_obj(*encp, kEncoderMagic)) return -1;
  std::memset(*encp, 0, sizeof(**encp));
  std::free(*encp);
  *encp = nullptr;
  return 0;
}

// ---------------------------------------------------------------------------
// XA header

ssize_t bjxa_parse_header(bjxa_decoder_t* dec, const void* src, size_t len) {
  if (bad_obj(dec, kDecoderMagic) || bad_ptr(src)) return -1;
  if (len < BJXA_HEADER_SIZE_XA) return fail(ENOBUFS), -1;

  // Parse into locals; commit only after every check passes, so a failed
  // mid-stream reparse leaves the previous state intact (the reference's
  // transactional contract, src/libbjxa.c:409-451).
  const uint8_t* p = static_cast<const uint8_t*>(src);
  if (!tag_eq(&p, "KWD1")) return fail(EPROTO), -1;
  StreamInfo si;
  si.data_len = rd_le(&p, 4);
  si.samples = rd_le(&p, 4);
  si.rate = static_cast<uint16_t>(rd_le(&p, 2));
  si.bits = static_cast<uint8_t>(rd_le(&p, 1));
  si.channels = static_cast<uint8_t>(rd_le(&p, 1));
  rd_le(&p, 4);  // loop pointer, ignored on decode
  int32_t taps[2][2];
  for (int c = 0; c < 2; c++)
    for (int t = 0; t < 2; t++)
      taps[c][t] = static_cast<int16_t>(rd_le(&p, 2));
  rd_le(&p, 4);  // pad, ignored

  if (!validate_xa(si)) return -1;

  dec->si = si;
  std::memcpy(dec->taps, taps, sizeof(taps));
  dec->pr.blocks = si.blocks();
  dec->pr.pcm_left = si.data_len_pcm();
  dec->ready = true;
  return BJXA_HEADER_SIZE_XA;
}

ssize_t bjxa_fread_header(bjxa_decoder_t* dec, FILE* file) {
  uint8_t buf[BJXA_HEADER_SIZE_XA];

  if (bad_obj(dec, kDecoderMagic) || bad_ptr(file)) return -1;
  if (fread(buf, sizeof buf, 1, file) != 1) {
    if (feof(file)) errno = EIO;
    return -1;
  }
  return bjxa_parse_header(dec, buf, sizeof buf);
}

// ---------------------------------------------------------------------------
// decode

int bjxa_decode_format(bjxa_decoder_t* dec, bjxa_format_t* fmt) {
  if (bad_obj(dec, kDecoderMagic) || bad_ptr(fmt)) return -1;
  if (!dec->ready) return fail(EINVAL), -1;

  // Full-stream values, independent of decode progress (the reference
  // recomputes from the immutable header fields, src/libbjxa.c:580-600).
  fmt->data_len_pcm = dec->si.data_len_pcm();
  fmt->blocks = dec->si.blocks();
  fmt->block_size_pcm = static_cast<uint8_t>(dec->si.block_size_pcm());
  fmt->block_size_xa = static_cast<uint8_t>(dec->si.block_size_xa());
  fmt->samples_rate = dec->si.rate;
  fmt->sample_bits = 16;
  fmt->channels = dec->si.channels;
  return 0;
}

int bjxa_decode(bjxa_decoder_t* dec, void* dst, size_t dst_len,
                const void* src, size_t src_len) {
  if (bad_obj(dec, kDecoderMagic) || bad_ptr(dst) || bad_ptr(src)) return -1;
  if (!dec->ready) return fail(EINVAL), -1;
  if (dec->pr.blocks == 0) return fail(EPROTO), -1;

  const StreamInfo& si = dec->si;
  const uint32_t bs_xa = si.block_size_xa();
  const uint32_t bs_pcm = si.block_size_pcm();
  if (dst_len < bs_pcm || src_len < bs_xa) return fail(ENOBUFS), -1;

  const uint8_t* src_p = static_cast<const uint8_t*>(src);
  uint8_t* dst_p = static_cast<uint8_t*>(dst);
  int blocks = 0;
  int32_t ranged[kBlockSamples];
  int16_t pcm[2 * kBlockSamples];

  uint32_t pcm_block = bs_pcm < dec->pr.pcm_left ? bs_pcm : dec->pr.pcm_left;
  while (dec->pr.blocks > 0 && dst_len >= pcm_block && src_len >= bs_xa) {
    for (uint32_t c = 0; c < si.channels; c++) {
      bjxa_core::unpack(src_p + 1, si.bits, ranged);
      if (!bjxa_core::filter_block(ranged, src_p[0], &dec->taps[c][0],
                                   &dec->taps[c][1], pcm + c, si.channels))
        return fail(EPROTO), -1;
      src_p += si.block_size();
      src_len -= si.block_size();
    }
    // Native-endian int16 frames; LE serialization is bjxa_dump_pcm's job.
    std::memcpy(dst_p, pcm, pcm_block);
    dst_p += pcm_block;
    dst_len -= pcm_block;
    blocks++;
    dec->pr.pcm_left -= pcm_block;
    dec->pr.blocks--;
    if (pcm_block > dec->pr.pcm_left) pcm_block = dec->pr.pcm_left;
  }
  return blocks;
}

// ---------------------------------------------------------------------------
// RIFF/WAVE container

ssize_t bjxa_parse_riff_header(bjxa_format_t* fmt, const void* src,
                               size_t len) {
  if (bad_ptr(fmt) || bad_ptr(src)) return -1;
  if (len < BJXA_HEADER_SIZE_RIFF) return fail(ENOBUFS), -1;

  const uint8_t* p = static_cast<const uint8_t*>(src);
  if (!tag_eq(&p, "RIFF")) return fail(EPROTO), -1;
  const uint32_t riff_len = rd_le(&p, 4);
  if (!tag_eq(&p, "WAVEfmt ")) return fail(EPROTO), -1;
  const uint32_t fmt_len = rd_le(&p, 4);
  const uint32_t fmt_tag = rd_le(&p, 2);
  const uint32_t channels = rd_le(&p, 2);
  const uint32_t rate = rd_le(&p, 4);
  const uint32_t byte_rate = rd_le(&p, 4);
  const uint32_t frame_size = rd_le(&p, 2);
  const uint32_t sample_bits = rd_le(&p, 2);
  if (!tag_eq(&p, "data")) return fail(EPROTO), -1;
  const uint32_t data_len = rd_le(&p, 4);

  // Strict canonical-44-byte matrix (reference src/libbjxa.c:855-863).
  if (riff_len < BJXA_HEADER_SIZE_RIFF - 8 + data_len) return fail(EPROTO), -1;
  if (fmt_len != 16 || fmt_tag != 1) return fail(EPROTO), -1;
  if (channels != 1 && channels != 2) return fail(EPROTO), -1;
  if (rate == 0 || rate >= 0xFFFF) return fail(EPROTO), -1;
  if (frame_size != channels * 2) return fail(EPROTO), -1;
  if (byte_rate != rate * frame_size) return fail(EPROTO), -1;
  if (data_len % frame_size != 0) return fail(EPROTO), -1;
  if (sample_bits != 16) return fail(EPROTO), -1;

  std::memset(fmt, 0, sizeof(*fmt));
  fmt->data_len_pcm = data_len;
  fmt->samples_rate = static_cast<uint16_t>(rate);
  fmt->sample_bits = 16;
  fmt->channels = static_cast<uint8_t>(channels);
  return BJXA_HEADER_SIZE_RIFF;
}

ssize_t bjxa_fread_riff_header(bjxa_format_t* fmt, FILE* file) {
  uint8_t buf[BJXA_HEADER_SIZE_RIFF];

  if (bad_ptr(fmt) || bad_ptr(file)) return -1;
  if (fread(buf, sizeof buf, 1, file) != 1) {
    if (feof(file)) errno = EIO;
    return -1;
  }
  return bjxa_parse_riff_header(fmt, buf, sizeof buf);
}

ssize_t bjxa_dump_riff_header(bjxa_decoder_t* dec, void* dst, size_t len) {
  if (bad_obj(dec, kDecoderMagic) || bad_ptr(dst)) return -1;
  if (len < BJXA_HEADER_SIZE_RIFF) return fail(ENOBUFS), -1;
  if (!dec->ready) return fail(EINVAL), -1;

  const StreamInfo& si = dec->si;
  uint8_t* p = static_cast<uint8_t*>(dst);
  std::memcpy(p, "RIFF", 4);
  p += 4;
  wr_le(&p, BJXA_HEADER_SIZE_RIFF - 8 + si.data_len_pcm(), 4);
  std::memcpy(p, "WAVEfmt ", 8);
  p += 8;
  wr_le(&p, 16, 4);  // canonical PCM fmt chunk length
  wr_le(&p, 1, 2);   // WAVE_FORMAT_PCM
  wr_le(&p, si.channels, 2);
  wr_le(&p, si.rate, 4);
  wr_le(&p, si.rate * si.channels * 2, 4);
  wr_le(&p, si.channels * 2, 2);
  wr_le(&p, 16, 2);
  std::memcpy(p, "data", 4);
  p += 4;
  wr_le(&p, si.data_len_pcm(), 4);
  return BJXA_HEADER_SIZE_RIFF;
}

ssize_t bjxa_fwrite_riff_header(bjxa_decoder_t* dec, FILE* file) {
  uint8_t buf[BJXA_HEADER_SIZE_RIFF];

  if (bad_obj(dec, kDecoderMagic) || bad_ptr(file)) return -1;
  if (bjxa_dump_riff_header(dec, buf, sizeof buf) < 0) return -1;
  if (fwrite(buf, sizeof buf, 1, file) != 1) return -1;
  return BJXA_HEADER_SIZE_RIFF;
}

// ---------------------------------------------------------------------------
// PCM serialization

int bjxa_dump_pcm(void* dst, const int16_t* src, size_t len) {
  if (bad_ptr(dst) || bad_ptr(src)) return -1;
  if (len == 0 || (len & 1) != 0) return fail(ENOBUFS), -1;

  uint8_t* p = static_cast<uint8_t*>(dst);
  for (; len > 0; len -= 2)
    wr_le(&p, static_cast<uint16_t>(*src++), 2);
  return 0;
}

int bjxa_fwrite_pcm(const int16_t* src, size_t len, FILE* file) {
  uint8_t buf[2 * kBlockSamples];

  if (bad_ptr(src) || bad_ptr(file)) return -1;
  if (len == 0 || (len & 1) != 0) return fail(ENOBUFS), -1;

  while (len > 0) {
    const size_t chunk = len < sizeof buf ? len : sizeof buf;
    if (bjxa_dump_pcm(buf, src, chunk) != 0) return -1;
    if (fwrite(buf, chunk, 1, file) != 1) return -1;
    src += chunk / 2;
    len -= chunk;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// encode

int bjxa_encode_init(bjxa_encoder_t* enc, bjxa_format_t* fmt, uint8_t bits) {
  if (bad_obj(enc, kEncoderMagic) || bad_ptr(fmt)) return -1;
  if (fmt->sample_bits != 16) return fail(EINVAL), -1;
  if (bits != 4 && bits != 6 && bits != 8) return fail(EINVAL), -1;
  if (fmt->channels != 1 && fmt->channels != 2) return fail(EPROTO), -1;

  StreamInfo si;
  si.bits = bits;
  si.channels = fmt->channels;
  si.rate = fmt->samples_rate;
  si.samples = fmt->data_len_pcm / (si.channels * 2u);
  if (si.samples == 0 || si.rate == 0) return fail(EPROTO), -1;
  if (fmt->data_len_pcm % si.samples != 0) return fail(EPROTO), -1;

  // Partial last block rounds up (reference src/libbjxa.c:727-730).
  const uint32_t nblocks = (si.samples + kBlockSamples - 1) / kBlockSamples;
  si.data_len = nblocks * si.block_size() * si.channels;

  fmt->block_size_xa = static_cast<uint8_t>(si.block_size_xa());
  fmt->block_size_pcm = static_cast<uint8_t>(si.block_size_pcm());
  fmt->blocks = nblocks;

  enc->si = si;
  std::memset(enc->taps, 0, sizeof(enc->taps));
  enc->pr.blocks = nblocks;
  enc->pr.pcm_left = fmt->data_len_pcm;
  enc->ready = true;
  return 0;
}

int bjxa_encode_format(bjxa_encoder_t* enc, bjxa_format_t* fmt) {
  if (bad_obj(enc, kEncoderMagic) || bad_ptr(fmt)) return -1;
  if (!enc->ready) return fail(EINVAL), -1;

  fmt->data_len_pcm = enc->si.data_len_pcm();
  fmt->blocks = enc->si.blocks();
  fmt->block_size_pcm = static_cast<uint8_t>(enc->si.block_size_pcm());
  fmt->block_size_xa = static_cast<uint8_t>(enc->si.block_size_xa());
  fmt->samples_rate = enc->si.rate;
  fmt->sample_bits = enc->si.bits;
  fmt->channels = enc->si.channels;
  return 0;
}

int bjxa_encode(bjxa_encoder_t* enc, void* dst, size_t dst_len,
                const void* src, size_t src_len) {
  if (bad_obj(enc, kEncoderMagic) || bad_ptr(dst) || bad_ptr(src)) return -1;
  if (!enc->ready) return fail(EINVAL), -1;
  if (enc->pr.blocks == 0) return fail(EPROTO), -1;

  const StreamInfo& si = enc->si;
  const uint32_t bs_xa = si.block_size_xa();
  const uint32_t bs_pcm = si.block_size_pcm();
  if (dst_len < bs_xa || src_len < bs_pcm) return fail(ENOBUFS), -1;

  const int16_t* src_p = static_cast<const int16_t*>(src);
  uint8_t* dst_p = static_cast<uint8_t*>(dst);
  int blocks = 0;
  int32_t vals[kBlockSamples];
  int32_t coded[kBlockSamples];

  uint32_t pcm_block = bs_pcm < enc->pr.pcm_left ? bs_pcm : enc->pr.pcm_left;
  while (enc->pr.blocks > 0 && dst_len >= bs_xa && src_len >= pcm_block) {
    const uint32_t samples = pcm_block / (si.channels * 2u);
    for (uint32_t c = 0; c < si.channels; c++) {
      // De-interleave this channel, zero-padding a partial final block
      // (reference src/libbjxa.c:686-690).
      for (uint32_t n = 0; n < kBlockSamples; n++)
        vals[n] = n < samples ? src_p[n * si.channels + c] : 0;
      if (enc->search) {
        bjxa_core::search_block(vals, si.bits, &enc->taps[c][0],
                                &enc->taps[c][1], dst_p, coded);
        bjxa_core::pack(coded, si.bits, dst_p + 1);
      } else {
        // Reference behavior: profile 0, pure truncation to the top bits.
        dst_p[0] = 0;
        bjxa_core::pack(vals, si.bits, dst_p + 1);
      }
      dst_p += si.block_size();
      dst_len -= si.block_size();
    }
    src_p += pcm_block / 2;
    src_len -= pcm_block;
    blocks++;
    enc->pr.pcm_left -= pcm_block;
    enc->pr.blocks--;
    if (pcm_block > enc->pr.pcm_left) pcm_block = enc->pr.pcm_left;
  }
  return blocks;
}

ssize_t bjxa_dump_header(bjxa_encoder_t* enc, void* dst, size_t len) {
  if (bad_obj(enc, kEncoderMagic) || bad_ptr(dst)) return -1;
  if (len < BJXA_HEADER_SIZE_XA) return fail(ENOBUFS), -1;
  if (!enc->ready || enc->si.data_len == 0) return fail(EINVAL), -1;

  uint8_t* p = static_cast<uint8_t*>(dst);
  std::memcpy(p, "KWD1", 4);
  p += 4;
  wr_le(&p, enc->si.data_len, 4);
  wr_le(&p, enc->si.samples, 4);
  wr_le(&p, enc->si.rate, 2);
  wr_le(&p, enc->si.bits, 1);
  wr_le(&p, enc->si.channels, 1);
  wr_le(&p, 0, 4);  // loop pointer
  wr_le(&p, 0, 2);  // predictor seeds x4
  wr_le(&p, 0, 2);
  wr_le(&p, 0, 2);
  wr_le(&p, 0, 2);
  wr_le(&p, 0, 4);  // pad
  return BJXA_HEADER_SIZE_XA;
}

ssize_t bjxa_fwrite_header(bjxa_encoder_t* enc, FILE* file) {
  uint8_t buf[BJXA_HEADER_SIZE_XA];

  if (bad_obj(enc, kEncoderMagic) || bad_ptr(file)) return -1;
  if (bjxa_dump_header(enc, buf, sizeof buf) < 0) return -1;
  if (fwrite(buf, sizeof buf, 1, file) != 1) return -1;
  return BJXA_HEADER_SIZE_XA;
}

// ---------------------------------------------------------------------------
// bjxa-tpu extensions

int bjxa_tpu_encode_search(bjxa_encoder_t* enc, int enable) {
  if (bad_obj(enc, kEncoderMagic)) return -1;
  enc->search = enable != 0;
  return 0;
}

const char* bjxa_tpu_version(void) { return "0.5.0"; }

}  // extern "C"
