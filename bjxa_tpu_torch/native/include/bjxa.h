/*
 * bjxa-tpu drop-in C API — libbjxa-compatible surface.
 *
 * This header declares the same 19 functions, the same value struct and
 * the same errno-based error contract as the reference libbjxa
 * (reference src/bjxa.h; contract documented in docs/bjxa-tpu.3.md and
 * the reference bjxa.3 man page), so existing C users of the reference
 * library can recompile against this implementation unchanged.  The
 * prototypes and struct layout ARE the ABI and therefore match the
 * reference declaration-for-declaration; everything behind them is the
 * bjxa-tpu native engine (bjxa_abi.cc, built on xa_core.h).
 *
 * Unlike the reference header this one pulls in its own dependencies, so
 * it can be included first.
 *
 * Extensions beyond the reference surface live at the bottom under the
 * BJXA_TPU_* name prefix and the LIBBJXA_TPU_0.5 symbol version node.
 */

#ifndef BJXA_TPU_BJXA_H
#define BJXA_TPU_BJXA_H

#include <stdint.h>
#include <stdio.h>
#include <sys/types.h>

#ifdef __cplusplus
extern "C" {
#endif

#define BJXA_HEADER_SIZE_XA	32
#define BJXA_HEADER_SIZE_RIFF	44

typedef struct bjxa_decoder bjxa_decoder_t;
typedef struct bjxa_encoder bjxa_encoder_t;

typedef struct {
	uint32_t	data_len_pcm;
	uint32_t	blocks;
	uint8_t		block_size_pcm;
	uint8_t		block_size_xa;
	uint16_t	samples_rate;
	uint8_t		sample_bits;
	uint8_t		channels;
} bjxa_format_t;

/* decoder */

bjxa_decoder_t * bjxa_decoder(void);
int bjxa_free_decoder(bjxa_decoder_t **);

ssize_t bjxa_parse_header(bjxa_decoder_t *, const void *, size_t);
ssize_t bjxa_fread_header(bjxa_decoder_t *, FILE *);

int bjxa_decode_format(bjxa_decoder_t *, bjxa_format_t *);
int bjxa_decode(bjxa_decoder_t *, void *, size_t, const void *, size_t);

ssize_t bjxa_dump_riff_header(bjxa_decoder_t *, void *, size_t);
ssize_t bjxa_fwrite_riff_header(bjxa_decoder_t *, FILE *);

int bjxa_dump_pcm(void *, const int16_t *, size_t);
int bjxa_fwrite_pcm(const int16_t *, size_t, FILE *);

/* encoder */

bjxa_encoder_t * bjxa_encoder(void);
int bjxa_free_encoder(bjxa_encoder_t **);

int bjxa_encode_init(bjxa_encoder_t *, bjxa_format_t *, uint8_t);

ssize_t bjxa_parse_riff_header(bjxa_format_t *, const void *, size_t);
ssize_t bjxa_fread_riff_header(bjxa_format_t *, FILE *);

int bjxa_encode_format(bjxa_encoder_t *, bjxa_format_t *);
int bjxa_encode(bjxa_encoder_t *, void *, size_t, const void *, size_t);

ssize_t bjxa_dump_header(bjxa_encoder_t *, void *, size_t);
ssize_t bjxa_fwrite_header(bjxa_encoder_t *, FILE *);

/* bjxa-tpu extensions (absent from the reference ABI) */

/*
 * Toggle the 80-profile search encode on an initialized encoder (the
 * reference encoder always writes profile 0 / pure truncation, which is
 * what bjxa_encode does by default for byte parity).  Search mode trades
 * ~80x the encode work for ~+10 dB SNR at every bit depth.  Returns 0,
 * or -1 with errno = EINVAL/EFAULT on a bad encoder.
 */
int bjxa_tpu_encode_search(bjxa_encoder_t *, int enable);

/* Version string of the bjxa-tpu native engine, e.g. "0.5.0". */
const char * bjxa_tpu_version(void);

#ifdef __cplusplus
}
#endif

#endif /* BJXA_TPU_BJXA_H */
