/*
 * bjxa — native command-line tool built on the drop-in C ABI.
 *
 * Same user surface as the reference CLI (reference src/bjxa.c:36-52):
 * `bjxa help|decode|encode`, `--bits 4|6|8` (default 6), `-` or an
 * omitted filename meaning stdin/stdout, perror-style error labels and
 * exit(1) on failure.  Written in plain C against include/bjxa.h — it
 * doubles as the proof that the public header needs nothing but libc.
 *
 * Extension over the reference surface: `encode --search` switches the
 * encoder from reference-parity truncation to the 80-profile search
 * (bjxa_tpu_encode_search).
 *
 * This is an original driver: single streaming loop per direction with
 * caller-side progress bookkeeping (bjxa_decode_format reports full
 * totals; remaining PCM is tracked here), no compile-time dual modes.
 */

#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <bjxa.h>

#define BLOCK_MAX_XA   (2 * (8 * 4 + 1))   /* stereo 8-bit effective block */
#define BLOCK_MAX_PCM  (2 * 32 * 2)        /* stereo block of int16 */

static const char *progname = "bjxa";

static void
usage(FILE *to)
{
	fprintf(to,
	    "Usage: %s <action> [args...]\n"
	    "\n"
	    "Available actions:\n"
	    "  help\n"
	    "    Show this message and exit.\n"
	    "  decode [<xa file> [<wav file>]]\n"
	    "    Convert an XA file into a WAV file.\n"
	    "  encode [--bits <4|6|8>] [--search] [<wav file> [<xa file>]]\n"
	    "    Convert a WAV file into an XA file; --bits defaults to 6.\n"
	    "    --search enables the filter-profile search (better SNR;\n"
	    "    without it the output matches the reference encoder).\n"
	    "\n"
	    "A missing file name or '-' means standard input or output.\n",
	    progname);
}

static int
die_usage(const char *msg)
{
	fprintf(stderr, "%s: %s\n", progname, msg);
	usage(stderr);
	return (1);
}

static FILE *
open_arg(const char *name, FILE *dflt, const char *mode)
{
	FILE *f;

	if (name == NULL || strcmp(name, "-") == 0)
		return (dflt);
	f = fopen(name, mode);
	if (f == NULL)
		perror(name);
	return (f);
}

static void
close_arg(FILE *f)
{
	if (f != stdin && f != stdout && f != NULL)
		fclose(f);
}

static int
do_decode(FILE *in, FILE *out)
{
	bjxa_decoder_t *dec;
	bjxa_format_t fmt;
	uint8_t xa_buf[BLOCK_MAX_XA];
	int16_t pcm_buf[BLOCK_MAX_PCM / 2];
	uint32_t pcm_left, take, blocks;
	int status = 1;

	dec = bjxa_decoder();
	if (dec == NULL) {
		perror("bjxa_decoder");
		return (1);
	}
	if (bjxa_fread_header(dec, in) < 0) {
		perror("bjxa_fread_header");
		goto out_free;
	}
	if (bjxa_decode_format(dec, &fmt) < 0) {
		perror("bjxa_decode_format");
		goto out_free;
	}
	if (bjxa_fwrite_riff_header(dec, out) < 0) {
		perror("bjxa_fwrite_riff_header");
		goto out_free;
	}

	pcm_left = fmt.data_len_pcm;
	for (blocks = fmt.blocks; blocks > 0; blocks--) {
		if (fread(xa_buf, fmt.block_size_xa, 1, in) != 1) {
			fprintf(stderr, "fread: %s\n",
			    feof(in) ? "End of file" : strerror(errno));
			goto out_free;
		}
		if (bjxa_decode(dec, pcm_buf, fmt.block_size_pcm, xa_buf,
		    fmt.block_size_xa) != 1) {
			perror("bjxa_decode");
			goto out_free;
		}
		take = fmt.block_size_pcm;
		if (take > pcm_left)
			take = pcm_left;
		if (bjxa_fwrite_pcm(pcm_buf, take, out) < 0) {
			perror("bjxa_fwrite_pcm");
			goto out_free;
		}
		pcm_left -= take;
	}
	status = 0;

out_free:
	if (bjxa_free_decoder(&dec) < 0) {
		perror("bjxa_free_decoder");
		status = 1;
	}
	return (status);
}

static int
do_encode(FILE *in, FILE *out, uint8_t bits, int search)
{
	bjxa_encoder_t *enc;
	bjxa_format_t fmt;
	uint8_t xa_buf[BLOCK_MAX_XA];
	uint8_t pcm_buf[BLOCK_MAX_PCM];
	uint32_t pcm_left, take, blocks;
	int status = 1;

	enc = bjxa_encoder();
	if (enc == NULL) {
		perror("bjxa_encoder");
		return (1);
	}
	if (bjxa_fread_riff_header(&fmt, in) < 0) {
		perror("bjxa_fread_riff_header");
		goto out_free;
	}
	if (bjxa_encode_init(enc, &fmt, bits) < 0) {
		perror("bjxa_encode_init");
		goto out_free;
	}
	if (search && bjxa_tpu_encode_search(enc, 1) < 0) {
		perror("bjxa_tpu_encode_search");
		goto out_free;
	}
	if (bjxa_fwrite_header(enc, out) < 0) {
		perror("bjxa_fwrite_header");
		goto out_free;
	}

	pcm_left = fmt.data_len_pcm;
	for (blocks = fmt.blocks; blocks > 0; blocks--) {
		take = fmt.block_size_pcm;
		if (take > pcm_left)
			take = pcm_left;
		if (fread(pcm_buf, take, 1, in) != 1) {
			fprintf(stderr, "fread: %s\n",
			    feof(in) ? "End of file" : strerror(errno));
			goto out_free;
		}
		/* src_len is buffer capacity: the library consumes only the
		 * remaining-PCM minimum, so the full size is always claimed
		 * even when the final fread was short. */
		if (bjxa_encode(enc, xa_buf, fmt.block_size_xa, pcm_buf,
		    fmt.block_size_pcm) != 1) {
			perror("bjxa_encode");
			goto out_free;
		}
		if (fwrite(xa_buf, fmt.block_size_xa, 1, out) != 1) {
			perror("fwrite");
			goto out_free;
		}
		pcm_left -= take;
	}
	status = 0;

out_free:
	if (bjxa_free_encoder(&enc) < 0) {
		perror("bjxa_free_encoder");
		status = 1;
	}
	return (status);
}

int
main(int argc, char **argv)
{
	FILE *in, *out;
	long bits = 6;
	int search = 0, status;
	char *end;

	if (argv[0] != NULL)
		progname = argv[0];
	if (argc < 2)
		return (die_usage("Missing an action"));

	if (strcmp(argv[1], "help") == 0) {
		usage(stdout);
		return (0);
	}

	if (strcmp(argv[1], "decode") == 0) {
		if (argc > 4)
			return (die_usage("Too many arguments"));
		in = open_arg(argc > 2 ? argv[2] : NULL, stdin, "rb");
		if (in == NULL)
			return (1);
		out = open_arg(argc > 3 ? argv[3] : NULL, stdout, "wb");
		if (out == NULL) {
			close_arg(in);
			return (1);
		}
		status = do_decode(in, out);
		close_arg(in);
		close_arg(out);
		return (status);
	}

	if (strcmp(argv[1], "encode") == 0) {
		int i = 2;

		while (i < argc && argv[i][0] == '-' &&
		    strcmp(argv[i], "-") != 0) {
			if (strcmp(argv[i], "--bits") == 0) {
				if (i + 1 >= argc)
					return (die_usage(
					    "Missing --bits value"));
				bits = strtol(argv[i + 1], &end, 10);
				if (*end != '\0' || (bits != 4 && bits != 6 &&
				    bits != 8))
					return (die_usage(
					    "Invalid --bits value"));
				i += 2;
			} else if (strcmp(argv[i], "--search") == 0) {
				search = 1;
				i++;
			} else {
				return (die_usage("Unknown option"));
			}
		}
		if (argc - i > 2)
			return (die_usage("Too many arguments"));
		in = open_arg(i < argc ? argv[i] : NULL, stdin, "rb");
		if (in == NULL)
			return (1);
		out = open_arg(i + 1 < argc ? argv[i + 1] : NULL, stdout,
		    "wb");
		if (out == NULL) {
			close_arg(in);
			return (1);
		}
		status = do_encode(in, out, (uint8_t)bits, search);
		close_arg(in);
		close_arg(out);
		return (status);
	}

	return (die_usage("Unknown action"));
}
