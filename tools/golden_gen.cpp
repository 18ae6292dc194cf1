// Golden-vector generator: compiles against the UNMODIFIED reference
// sources (mounted read-only at /root/reference) and dumps, for a set of
// deterministic inputs:
//   - normalized histograms  (<case>.hist_<B>)          raw 256*u16 freqs
//   - encoded blobs or their sizes+SHA-like FNV hashes  (<case>.<codec>_<B>[.bin|.meta])
// so this framework's encoders/decoders can be checked for bit-exact
// wire-format parity without shipping reference code in this repo.
//
// Build (see tools/gen_golden.sh):
//   g++ -O2 -std=c++20 -mxsave -I/root/reference/src golden_gen.cpp \
//       <reference .cpp files> -o golden_gen
// Usage: golden_gen <input.bin> <outdir> <case-name> [--small]
//   --small also emits full blobs for raw codecs (for direct decode tests).

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include "hist.h"
#include "rANS32x16_16w.h"
#include "rANS32x32_16w.h"
#include "rANS32x64_16w.h"
#include "rans32x32_32blk_16w.h"
#include "rans32x32_32blk_8w.h"
#include "block_rANS32x32_16w.h"
#include "block_rANS32x64_16w.h"
#include "mt_rANS32x32_16w.h"
#include "mt_rANS32x64_16w.h"

static uint64_t fnv1a(const uint8_t *p, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; i++) { h ^= p[i]; h *= 1099511628211ull; }
  return h;
}

static void write_file(const std::string &path, const void *data, size_t size) {
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "can't open %s\n", path.c_str()); exit(1); }
  fwrite(data, 1, size, f);
  fclose(f);
}

static void write_meta(const std::string &path, size_t size, uint64_t hash) {
  char buf[128];
  int n = snprintf(buf, sizeof(buf), "%zu %016llx\n", size, (unsigned long long)hash);
  write_file(path, buf, (size_t)n);
}

typedef size_t (*enc_hist_fn)(const uint8_t *, size_t, uint8_t *, size_t, const hist_t *);
typedef size_t (*enc_fn)(const uint8_t *, size_t, uint8_t *, size_t);

int main(int argc, char **argv) {
  if (argc < 4) { fprintf(stderr, "usage: %s input outdir case [--small]\n", argv[0]); return 1; }
  const bool small = argc > 4 && strcmp(argv[4], "--small") == 0;

  FILE *f = fopen(argv[1], "rb");
  if (!f) { fprintf(stderr, "no input\n"); return 1; }
  fseek(f, 0, SEEK_END);
  size_t len = (size_t)ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(len);
  if (fread(data.data(), 1, len, f) != len) return 1;
  fclose(f);

  std::string outdir = argv[2], name = argv[3];
  size_t cap = mt_rANS32x64_16w_capacity(len) + rANS32x32_32blk_16w_capacity(len) + (1 << 20);
  std::vector<uint8_t> out(cap);

  struct { const char *tag; enc_hist_fn fn; int bits; } raw[] = {
#define RAWROW(N, B) {"raw" #N "_" #B, rANS32x##N##_16w_encode_scalar_##B, B}
    RAWROW(16,10), RAWROW(16,11), RAWROW(16,12), RAWROW(16,13), RAWROW(16,14), RAWROW(16,15),
    RAWROW(32,10), RAWROW(32,11), RAWROW(32,12), RAWROW(32,13), RAWROW(32,14), RAWROW(32,15),
    RAWROW(64,10), RAWROW(64,11), RAWROW(64,12), RAWROW(64,13), RAWROW(64,14), RAWROW(64,15),
#undef RAWROW
  };

  struct { const char *tag; enc_hist_fn fn; int bits; } blk32[] = {
    {"32blk16w_10", rANS32x32_32blk_16w_encode_scalar_10, 10},
    {"32blk16w_12", rANS32x32_32blk_16w_encode_scalar_12, 12},
    {"32blk16w_15", rANS32x32_32blk_16w_encode_scalar_15, 15},
    {"32blk8w_10", rANS32x32_32blk_8w_encode_scalar_10, 10},
    {"32blk8w_12", rANS32x32_32blk_8w_encode_scalar_12, 12},
    {"32blk8w_15", rANS32x32_32blk_8w_encode_scalar_15, 15},
  };

  struct { const char *tag; enc_fn fn; } adaptive[] = {
    {"block64_15", block_rANS32x64_16w_encode_15},
    {"block64_12", block_rANS32x64_16w_encode_12},
    {"block64_10", block_rANS32x64_16w_encode_10},
    {"block32_12", block_rANS32x32_16w_encode_12},
    {"mt64_15", mt_rANS32x64_16w_encode_15},
    {"mt64_12", mt_rANS32x64_16w_encode_12},
    {"mt64_10", mt_rANS32x64_16w_encode_10},
    {"mt32_12", mt_rANS32x32_16w_encode_12},
  };

  for (int bits = 10; bits <= 15; bits++) {
    hist_t hist;
    make_hist(&hist, data.data(), len, (size_t)bits);
    write_file(outdir + "/" + name + ".hist_" + std::to_string(bits),
               hist.symbolCount, sizeof(hist.symbolCount));
  }

  for (auto &r : raw) {
    hist_t hist;
    make_hist(&hist, data.data(), len, (size_t)r.bits);
    size_t sz = r.fn(data.data(), len, out.data(), cap, &hist);
    write_meta(outdir + "/" + name + "." + r.tag + ".meta", sz, fnv1a(out.data(), sz));
    if (small)
      write_file(outdir + "/" + name + "." + r.tag + ".bin", out.data(), sz);
  }

  for (auto &r : blk32) {
    hist_t hist;
    make_hist(&hist, data.data(), len, (size_t)r.bits);
    size_t sz = r.fn(data.data(), len, out.data(), cap, &hist);
    write_meta(outdir + "/" + name + "." + r.tag + ".meta", sz, fnv1a(out.data(), sz));
    if (small)
      write_file(outdir + "/" + name + "." + r.tag + ".bin", out.data(), sz);
  }

  for (auto &r : adaptive) {
    size_t sz = r.fn(data.data(), len, out.data(), cap);
    write_meta(outdir + "/" + name + "." + std::string(r.tag) + ".meta", sz, fnv1a(out.data(), sz));
    if (small)
      write_file(outdir + "/" + name + "." + r.tag + ".bin", out.data(), sz);
  }

  printf("ok %s (%zu bytes)\n", name.c_str(), len);
  return 0;
}
