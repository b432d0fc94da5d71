// Huffman decoder for the PIZ EXR codec (host code).
//
// The port's copy of the JAX package's native PIZ decoder. The wavelet
// and LUT stages of utils/piz.py are vectorized numpy and fast; the
// canonical-Huffman bitstream decode is a per-symbol bit loop, which in
// Python takes tens of seconds for an 800x800 image. This C function
// replaces it, with OpenEXR's ``hufUncompress`` semantics: 20-byte header,
// 6-bit packed code lengths with zero-run escapes, 14-bit primary decode
// table with long-code lists, and the run-length pseudo-symbol = max
// symbol index.
//
// Contract (mirrors utils/piz.py::_huf_uncompress_plain):
//   piz_huf_decode(data, n_data, out, n_out) -> 0 on success, negative
//   error codes otherwise; ``out`` receives exactly n_out uint16 symbols.
//
// Built by esrnerf_tpu_torch/ops/kernels.py (g++ -O3 -fPIC -shared) and
// loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int HUF_ENCBITS = 16;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

struct BitReader {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t acc = 0;
  int nbits = 0;
  bool fail = false;

  int read(int n) {
    while (nbits < n) {
      if (pos >= end) { fail = true; return 0; }
      acc = (acc << 8) | data[pos++];
      nbits += 8;
    }
    nbits -= n;
    return int((acc >> nbits) & ((1u << n) - 1));
  }
};

// canonical codes from lengths: hcode[i] = (code << 6) | len
void canonical_codes(std::vector<int64_t>& hcode) {
  // count per length (hcode currently holds lengths)
  int64_t cnt[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int l = int(hcode[i]);
    if (l > 0) cnt[l] += 1;
  }
  int64_t c = 0;
  int64_t first[59] = {0};
  for (int i = 58; i > 0; --i) {
    int64_t nc = (c + cnt[i]) >> 1;
    first[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = l | (first[l]++ << 6);
  }
}

}  // namespace

extern "C" int piz_huf_decode(const uint8_t* data, int64_t n_data,
                              uint16_t* out, int64_t n_out) {
  if (n_out == 0) return 0;
  if (n_data < 20) return -1;
  uint32_t im, iM, table_len, nbits, reserved;
  std::memcpy(&im, data + 0, 4);
  std::memcpy(&iM, data + 4, 4);
  std::memcpy(&table_len, data + 8, 4);
  std::memcpy(&nbits, data + 12, 4);
  std::memcpy(&reserved, data + 16, 4);
  (void)table_len;
  (void)reserved;
  if (!(im < iM && iM < uint32_t(HUF_ENCSIZE))) return -2;

  // ---- unpack the 6-bit packed code-length table
  std::vector<int64_t> hcode(HUF_ENCSIZE, 0);
  BitReader tr{data, 20, n_data};
  for (uint32_t i = im; i <= iM;) {
    int l = tr.read(6);
    if (tr.fail) return -3;
    if (l == LONG_ZEROCODE_RUN) {
      i += tr.read(8) + SHORTEST_LONG_RUN;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      i += l - SHORT_ZEROCODE_RUN + 2;
    } else {
      hcode[i] = l;
      i += 1;
    }
    if (i > iM + 1) return -4;
  }
  canonical_codes(hcode);

  // ---- build the 14-bit primary table + long-code lists
  std::vector<int8_t> short_len(HUF_DECSIZE, 0);
  std::vector<int32_t> short_lit(HUF_DECSIZE, 0);
  std::vector<std::vector<int32_t>> longs(HUF_DECSIZE);
  for (uint32_t i = im; i <= iM; ++i) {
    int64_t c = hcode[i];
    int l = int(c & 63);
    if (!l) continue;
    int64_t code = c >> 6;
    if (l > HUF_DECBITS) {
      longs[code >> (l - HUF_DECBITS)].push_back(int32_t(i));
    } else {
      int64_t base = code << (HUF_DECBITS - l);
      int64_t n = int64_t(1) << (HUF_DECBITS - l);
      for (int64_t j = 0; j < n; ++j) {
        short_len[base + j] = int8_t(l);
        short_lit[base + j] = int32_t(i);
      }
    }
  }

  // ---- bit-serial decode
  const int rlc = int(iM);
  int64_t oi = 0;
  uint64_t c = 0;
  int lc = 0;
  int64_t ipos = tr.pos;  // table is byte-aligned at its end
  const int64_t iend = ipos + (int64_t(nbits) + 7) / 8;
  if (iend > n_data) return -5;

  auto emit = [&](int sym) -> int {
    if (sym == rlc) {
      if (lc < 8) {
        if (ipos >= iend) return -6;
        c = (c << 8) | data[ipos++];
        lc += 8;
      }
      int cs = int((c >> (lc - 8)) & 0xFF);
      lc -= 8;
      if (oi == 0 || oi + cs > n_out) return -7;
      uint16_t prev = out[oi - 1];
      for (int k = 0; k < cs; ++k) out[oi + k] = prev;
      oi += cs;
    } else {
      if (oi >= n_out) return -8;
      out[oi++] = uint16_t(sym);
    }
    return 0;
  };

  while (ipos < iend) {
    c = (c << 8) | data[ipos++];
    lc += 8;
    while (lc >= HUF_DECBITS) {
      int pl = int((c >> (lc - HUF_DECBITS)) & HUF_DECMASK);
      int l = short_len[pl];
      int sym;
      if (l) {
        lc -= l;
        sym = short_lit[pl];
      } else {
        sym = -1;
        for (int32_t j : longs[pl]) {
          int cl = int(hcode[j] & 63);
          int64_t cv = hcode[j] >> 6;
          while (lc < cl && ipos < iend) {
            c = (c << 8) | data[ipos++];
            lc += 8;
          }
          if (lc >= cl &&
              cv == int64_t((c >> (lc - cl)) & ((uint64_t(1) << cl) - 1))) {
            lc -= cl;
            sym = j;
            break;
          }
        }
        if (sym < 0) return -9;
      }
      int rc = emit(sym);
      if (rc) return rc;
    }
  }
  // flush the whole-bit tail
  int tail = int((8 - nbits) & 7);
  c >>= tail;
  lc -= tail;
  while (lc > 0) {
    int pl = int((c << (HUF_DECBITS - lc)) & HUF_DECMASK);
    int l = short_len[pl];
    if (l && l <= lc) {
      lc -= l;
      int sym = short_lit[pl];
      if (sym == rlc) return -10;
      if (oi >= n_out) return -8;
      out[oi++] = uint16_t(sym);
    } else {
      break;
    }
  }
  return oi == n_out ? 0 : -11;
}
