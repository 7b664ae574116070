// rANS range coder of the port's real bitstream path (coding/rans.py).
//
// Host C++ with a plain C ABI, loaded through ctypes; built at first use with
// the host C++ compiler by ops/_build.py (no -march flag: the library runs on
// any x86-64 host, and integer rANS gives the same bytes without it). The
// stream format and the C ABI are those of the JAX package's coder, so
// either package decodes the other's streams:
//   * 64-bit rANS state with 32-bit renormalisation, 16-bit quantized CDFs
//     (precision 2^16)
//   * CDF-table registry shared by y (Gaussian scale table) and z
//     (per-QP factorized) coders
//   * CompressAI-style escape/bypass coding for out-of-range symbols
//   * fused int16 (symbol<<8 | index) encode_y path and int8 + per-channel
//     offset encode_z path
//   * optional two-stream split (set_use_two_encoders) so decode can be
//     parallelized; streams are framed [u32 len0][stream0][stream1]

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
// 64-bit rANS state, 32-bit-word renormalization (ryg rans64 layout): one
// branch + at most one 4-byte emission per symbol instead of a byte-wise
// while loop — measurably faster on both sides of the coder.
constexpr uint64_t kRans64L = 1ull << 31;  // renormalization lower bound
constexpr int kBypassPrecision = 4;    // bypass chunk bits
constexpr int kMaxBypassVal = (1 << kBypassPrecision) - 1;

struct CdfTable {
  // cdfs laid out row-major: n_rows x row_len int32 (quantized, last = 2^16)
  std::vector<int32_t> cdfs;
  std::vector<int32_t> lengths;  // cdf_length per row (entries used)
  std::vector<int32_t> offsets;  // symbol value offset per row
  int row_len = 0;
  int n_rows = 0;
};

struct PendingSymbol {
  int32_t value;   // raw symbol value (before offset)
  int32_t index;   // cdf row
  int32_t group;   // cdf table id
};

class RansEncImpl {
 public:
  std::vector<CdfTable> tables;
  std::vector<PendingSymbol> pending[2];
  std::vector<uint8_t> encoded;
  bool two_streams = false;

  // Precomputed per-(row, symbol) encode entries (ryg rans64 scheme): the
  // per-symbol 64-bit division becomes a 128-bit reciprocal multiply.
  struct EncSym {
    uint64_t rcp_freq;
    uint64_t bias;       // start (+ freq-1 wraps for the freq==1 case)
    uint32_t freq;
    uint32_t cmpl_freq;  // (1<<16) - freq
    uint32_t rcp_shift;
  };
  std::vector<std::vector<EncSym>> enc_syms;  // parallel to `tables`

  int add_cdf(const CdfTable& t) {
    tables.push_back(t);
    std::vector<EncSym> es(size_t(t.n_rows) * t.row_len);
    for (int r = 0; r < t.n_rows; ++r) {
      const int32_t* cdf = t.cdfs.data() + size_t(r) * t.row_len;
      const int32_t len = t.lengths[r];
      for (int sidx = 0; sidx + 1 < len; ++sidx) {
        const uint32_t start = static_cast<uint32_t>(cdf[sidx]);
        const uint32_t freq =
            static_cast<uint32_t>(cdf[sidx + 1] - cdf[sidx]);
        EncSym& e = es[size_t(r) * t.row_len + sidx];
        e.freq = freq;
        e.cmpl_freq = (1u << kProbBits) - freq;
        if (freq < 2) {
          // freq==0 rows never encode; freq==1: multiply-by-~0 trick
          e.rcp_freq = ~0ull;
          e.rcp_shift = 0;
          e.bias = start + (1u << kProbBits) - 1;
        } else {
          uint32_t shift = 0;
          while (freq > (1u << shift)) shift++;
          e.rcp_freq = static_cast<uint64_t>(
              (((static_cast<__uint128_t>(1) << (shift + 63)) + freq - 1)
               / freq));
          e.rcp_shift = shift - 1;
          e.bias = start;
        }
      }
    }
    enc_syms.push_back(std::move(es));
    return static_cast<int>(tables.size()) - 1;
  }

  void reset() {
    pending[0].clear();
    pending[1].clear();
    encoded.clear();
  }

  void put(int32_t value, int32_t index, int32_t group) {
    pending[0].push_back({value, index, group});
  }

  // Two-stream mode splits EACH batch call half/half, mirroring the
  // decoder's per-call split (decode_batch), so both sides stay in sync.
  void put_batch_split(const PendingSymbol* syms, size_t n) {
    if (!two_streams) {
      pending[0].insert(pending[0].end(), syms, syms + n);
      return;
    }
    size_t half = n / 2;
    pending[0].insert(pending[0].end(), syms, syms + half);
    pending[1].insert(pending[1].end(), syms + half, syms + n);
  }

  // rANS encode of a pending list (LIFO -> iterate in reverse), returns bytes
  std::vector<uint8_t> encode_stream(const std::vector<PendingSymbol>& syms) {
    std::vector<uint8_t> out;
    out.reserve(syms.size());
    uint64_t state = kRans64L;

    auto emit32 = [&]() {
      out.push_back(static_cast<uint8_t>(state & 0xff));
      out.push_back(static_cast<uint8_t>((state >> 8) & 0xff));
      out.push_back(static_cast<uint8_t>((state >> 16) & 0xff));
      out.push_back(static_cast<uint8_t>((state >> 24) & 0xff));
      state >>= 32;
    };

    // division-free encode (ryg rans64): q = floor(x / freq) via a 128-bit
    // reciprocal multiply, then x' = x + bias + q * cmpl_freq
    auto put_sym = [&](const EncSym& e) {
      const uint64_t x_max = ((kRans64L >> kProbBits) << 32) * e.freq;
      if (state >= x_max) emit32();
      const uint64_t q = static_cast<uint64_t>(
          (static_cast<__uint128_t>(state) * e.rcp_freq) >> 64) >> e.rcp_shift;
      state = state + e.bias + q * e.cmpl_freq;
    };

    auto put_bits = [&](uint32_t val, int nbits) {
      // bypass raw bits: uniform pow2 freq -> pure shifts, no division
      const int freq_log = kProbBits - nbits;
      const uint64_t x_max = ((kRans64L >> kProbBits) << 32) << freq_log;
      if (state >= x_max) emit32();
      state = ((state >> freq_log) << kProbBits) +
              (state & ((1ull << freq_log) - 1)) +
              (static_cast<uint64_t>(val) << freq_log);
    };

    for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
      const CdfTable& t = tables[it->group];
      const int32_t len = t.lengths[it->index];   // entries in cdf row
      const int32_t max_sym = len - 2;            // last valid = escape
      int32_t s = it->value - t.offsets[it->index];

      if (s < 0 || s >= max_sym) {
        // escape: bypass-code the raw overflow (sign-folded) value.
        // Decode order: [escape symbol][unary chunk count][data chunks],
        // so in this reverse (LIFO) encoder we emit data chunks first,
        // then the unary count, then fall through to the escape symbol.
        uint32_t raw = static_cast<uint32_t>(
            s < 0 ? -2 * s - 1 : 2 * (s - max_sym));
        int n_chunks = 0;
        uint32_t tmp = raw;
        do {
          n_chunks++;
          tmp >>= kBypassPrecision;
        } while (tmp);
        // data chunks, little-endian; encode reversed
        for (int i = n_chunks - 1; i >= 0; --i)
          put_bits((raw >> (i * kBypassPrecision)) & kMaxBypassVal,
                   kBypassPrecision);
        // unary count: (n_chunks-1) "continue" markers (== kMaxBypassVal)
        // terminated by one non-max chunk; encode reversed
        put_bits(0, kBypassPrecision);  // terminator decoded last in unary
        for (int i = 0; i < n_chunks - 1; ++i)
          put_bits(kMaxBypassVal, kBypassPrecision);
        s = max_sym;
      }

      put_sym(enc_syms[it->group][size_t(it->index) * t.row_len + s]);
    }
    // flush state (8 bytes, little endian at the back). NOTE: 4 bytes more
    // than the old 32-bit coder's flush — a per-STREAM constant that is
    // invisible at 1080p (~3e-5 bpp) but measurable in tiny-crop evals
    // (+0.008 bpp/frame at 64px); est-vs-real bpp gaps are not comparable
    // across this format change.
    for (int i = 0; i < 8; ++i) {
      out.push_back(static_cast<uint8_t>(state & 0xff));
      state >>= 8;
    }
    // bytes were emitted in reverse decode order
    std::vector<uint8_t> rev(out.rbegin(), out.rend());
    return rev;
  }

  void flush() {
    encoded.clear();
    if (!two_streams) {
      encoded = encode_stream(pending[0]);
    } else {
      // the whole point of the split: both streams encode concurrently
      // (the reference's set_use_two_entropy_coders exists to parallelize,
      // src/models/entropy_models.py:79-81)
      std::vector<uint8_t> sa, sb;
      std::thread tb([&] { sb = encode_stream(pending[1]); });
      sa = encode_stream(pending[0]);
      tb.join();
      uint32_t len_a = static_cast<uint32_t>(sa.size());
      encoded.resize(4);
      std::memcpy(encoded.data(), &len_a, 4);
      encoded.insert(encoded.end(), sa.begin(), sa.end());
      encoded.insert(encoded.end(), sb.begin(), sb.end());
    }
    pending[0].clear();
    pending[1].clear();
  }
};

class RansDecImpl {
 public:
  std::vector<CdfTable> tables;
  // Per-row bucket index over the 16-bit cum space: bucket[b] = max{s :
  // cdf[s] <= (b << (kProbBits - kBucketBits))}. Turns the per-symbol
  // binary search (6-8 mispredicting iterations) into one bucket load plus
  // an expected-O(1) forward scan — symbols sharing a bucket have freq
  // <= 2^(kProbBits - kBucketBits), so long scans only happen for symbols
  // that are rarely decoded. ~0.5KB per CDF row.
  static constexpr int kBucketBits = 8;
  static constexpr int kBucketCount = 1 << kBucketBits;
  std::vector<std::vector<int16_t>> bucket_idx;  // parallel to `tables`
  std::vector<uint8_t> stream;
  std::vector<int32_t> decoded;
  bool two_streams = false;

  struct Cursor {
    const uint8_t* ptr;
    const uint8_t* end;
    uint64_t state;
  };
  Cursor cur[2];
  // pending decode bookkeeping for two-stream mode
  size_t total_symbols_hint = 0;

  int add_cdf(const CdfTable& t) {
    tables.push_back(t);
    // build the bucket index: one (kBucketCount + 1) row per CDF row; the
    // +1 sentinel caps the forward scan at the row's last real symbol
    std::vector<int16_t> idx(size_t(t.n_rows) * (kBucketCount + 1));
    constexpr int shift = kProbBits - kBucketBits;
    for (int r = 0; r < t.n_rows; ++r) {
      const int32_t* cdf = t.cdfs.data() + size_t(r) * t.row_len;
      const int32_t len = t.lengths[r];
      int16_t* row = idx.data() + size_t(r) * (kBucketCount + 1);
      int s = 0;
      for (int b = 0; b < kBucketCount; ++b) {
        const uint32_t lo_cum = uint32_t(b) << shift;
        while (s + 1 <= len - 2 &&
               static_cast<uint32_t>(cdf[s + 1]) <= lo_cum)
          ++s;
        row[b] = static_cast<int16_t>(s);
      }
      row[kBucketCount] = static_cast<int16_t>(len - 2);
    }
    bucket_idx.push_back(std::move(idx));
    return static_cast<int>(tables.size()) - 1;
  }

  void set_stream(const uint8_t* data, size_t n) {
    stream.assign(data, data + n);
    decoded.clear();
    if (!two_streams) {
      init_cursor(cur[0], stream.data(), stream.size());
    } else {
      uint32_t len_a;
      std::memcpy(&len_a, stream.data(), 4);
      init_cursor(cur[0], stream.data() + 4, len_a);
      init_cursor(cur[1], stream.data() + 4 + len_a,
                  stream.size() - 4 - len_a);
    }
  }

  static void init_cursor(Cursor& c, const uint8_t* data, size_t n) {
    c.ptr = data;
    c.end = data + n;
    c.state = 0;
    for (int i = 0; i < 8; ++i)
      c.state = (c.state << 8) | (c.ptr < c.end ? *c.ptr++ : 0);
  }

  static void renorm(Cursor& c) {
    if (c.state < kRans64L) {  // pull one 32-bit word (big-endian in-stream
      //                          order: the encoder reverses its buffer)
      uint32_t w = 0;
      for (int i = 0; i < 4; ++i)
        w = (w << 8) | (c.ptr < c.end ? *c.ptr++ : 0);
      c.state = (c.state << 32) | w;
    }
  }

  uint32_t get_bits(Cursor& c, int nbits) {
    uint32_t freq = 1u << (kProbBits - nbits);
    uint32_t cum = static_cast<uint32_t>(c.state) & (kProbScale - 1);
    uint32_t val = cum / freq;
    c.state = uint64_t(freq) * (c.state >> kProbBits) + (cum % freq);
    renorm(c);
    return val;
  }

  int32_t decode_one(Cursor& c, int32_t index, int32_t group) {
    const CdfTable& t = tables[group];
    const int32_t* cdf = t.cdfs.data() + size_t(index) * t.row_len;
    const int32_t len = t.lengths[index];
    const int32_t max_sym = len - 2;

    uint32_t cum = static_cast<uint32_t>(c.state) & (kProbScale - 1);
    // bucket-indexed lookup for s with cdf[s] <= cum < cdf[s+1]: start at
    // the bucket's floor symbol and scan forward (expected O(1); see
    // bucket_idx comment). Bit-identical result to the old binary search.
    const int16_t* row = bucket_idx[group].data()
        + size_t(index) * (kBucketCount + 1);
    const int b = static_cast<int>(cum >> (kProbBits - kBucketBits));
    int s = row[b];
    const int s_hi = row[b + 1];
    while (s < s_hi && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
    uint32_t start = static_cast<uint32_t>(cdf[s]);
    uint32_t freq = static_cast<uint32_t>(cdf[s + 1] - cdf[s]);
    c.state = uint64_t(freq) * (c.state >> kProbBits) + cum - start;
    renorm(c);

    int32_t value;
    if (s == max_sym) {
      // escape: unary chunk count then data chunks
      int n_chunks = 1;
      while (get_bits(c, kBypassPrecision) == (1u << kBypassPrecision) - 1)
        n_chunks++;
      uint32_t raw = 0;
      for (int i = 0; i < n_chunks; ++i)
        raw |= get_bits(c, kBypassPrecision) << (i * kBypassPrecision);
      int32_t sraw = static_cast<int32_t>(raw);
      value = (sraw & 1) ? -(sraw + 1) / 2 : sraw / 2 + max_sym;
    } else {
      value = s;
    }
    return value + t.offsets[index];
  }

  void decode_batch(const int32_t* indexes, size_t n, int32_t group) {
    if (!two_streams) {
      for (size_t i = 0; i < n; ++i)
        decoded.push_back(decode_one(cur[0], indexes[i], group));
    } else {
      // decode the two independent streams on two threads; each half only
      // touches its own cursor and a disjoint slice of `decoded`
      size_t half = n / 2;
      size_t base = decoded.size();
      decoded.resize(base + n);
      int32_t* out = decoded.data() + base;
      std::thread t1([&] {
        for (size_t i = half; i < n; ++i)
          out[i] = decode_one(cur[1], indexes[i], group);
      });
      for (size_t i = 0; i < half; ++i)
        out[i] = decode_one(cur[0], indexes[i], group);
      t1.join();
    }
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- encoder
void* rans_encoder_new() { return new RansEncImpl(); }
void rans_encoder_free(void* h) { delete static_cast<RansEncImpl*>(h); }
void rans_encoder_reset(void* h) { static_cast<RansEncImpl*>(h)->reset(); }
void rans_encoder_set_two(void* h, int two) {
  static_cast<RansEncImpl*>(h)->two_streams = two != 0;
}

int rans_encoder_add_cdf(void* h, const int32_t* cdfs, const int32_t* lengths,
                         const int32_t* offsets, int n_rows, int row_len) {
  CdfTable t;
  t.cdfs.assign(cdfs, cdfs + size_t(n_rows) * row_len);
  t.lengths.assign(lengths, lengths + n_rows);
  t.offsets.assign(offsets, offsets + n_rows);
  t.row_len = row_len;
  t.n_rows = n_rows;
  return static_cast<RansEncImpl*>(h)->add_cdf(t);
}

// classic interface: separate symbol + index arrays
void rans_encoder_encode_with_indexes(void* h, const int16_t* symbols,
                                      const int32_t* indexes, size_t n,
                                      int group) {
  auto* e = static_cast<RansEncImpl*>(h);
  std::vector<PendingSymbol> batch(n);
  for (size_t i = 0; i < n; ++i) batch[i] = {symbols[i], indexes[i], group};
  e->put_batch_split(batch.data(), n);
}

// fused RT interface: int16 packed (symbol<<8)|index
void rans_encoder_encode_y(void* h, const int16_t* packed, size_t n,
                           int group) {
  auto* e = static_cast<RansEncImpl*>(h);
  std::vector<PendingSymbol> batch(n);
  for (size_t i = 0; i < n; ++i) {
    int32_t value = packed[i] >> 8;          // arithmetic shift keeps sign
    int32_t index = packed[i] & 0xff;
    batch[i] = {value, index, group};
  }
  e->put_batch_split(batch.data(), n);
}

// z interface: int8 symbols, row = start_offset + i / per_channel_size
void rans_encoder_encode_z(void* h, const int8_t* symbols, size_t n, int group,
                           int start_offset, int per_channel_size) {
  auto* e = static_cast<RansEncImpl*>(h);
  std::vector<PendingSymbol> batch(n);
  for (size_t i = 0; i < n; ++i) {
    int32_t index = start_offset + static_cast<int32_t>(i / per_channel_size);
    batch[i] = {symbols[i], index, group};
  }
  e->put_batch_split(batch.data(), n);
}

void rans_encoder_flush(void* h) { static_cast<RansEncImpl*>(h)->flush(); }

size_t rans_encoder_stream_size(void* h) {
  return static_cast<RansEncImpl*>(h)->encoded.size();
}

void rans_encoder_get_stream(void* h, uint8_t* out) {
  auto* e = static_cast<RansEncImpl*>(h);
  std::memcpy(out, e->encoded.data(), e->encoded.size());
}

// ---------------------------------------------------------------- decoder
void* rans_decoder_new() { return new RansDecImpl(); }
void rans_decoder_free(void* h) { delete static_cast<RansDecImpl*>(h); }
void rans_decoder_set_two(void* h, int two) {
  static_cast<RansDecImpl*>(h)->two_streams = two != 0;
}

int rans_decoder_add_cdf(void* h, const int32_t* cdfs, const int32_t* lengths,
                         const int32_t* offsets, int n_rows, int row_len) {
  CdfTable t;
  t.cdfs.assign(cdfs, cdfs + size_t(n_rows) * row_len);
  t.lengths.assign(lengths, lengths + n_rows);
  t.offsets.assign(offsets, offsets + n_rows);
  t.row_len = row_len;
  t.n_rows = n_rows;
  return static_cast<RansDecImpl*>(h)->add_cdf(t);
}

void rans_decoder_set_stream(void* h, const uint8_t* data, size_t n) {
  static_cast<RansDecImpl*>(h)->set_stream(data, n);
}

void rans_decoder_decode_batch(void* h, const int32_t* indexes, size_t n,
                               int group) {
  static_cast<RansDecImpl*>(h)->decode_batch(indexes, n, group);
}

// z: row = start_offset + i / per_channel_size, n symbols
void rans_decoder_decode_z(void* h, size_t n, int group, int start_offset,
                           int per_channel_size) {
  auto* d = static_cast<RansDecImpl*>(h);
  std::vector<int32_t> indexes(n);
  for (size_t i = 0; i < n; ++i)
    indexes[i] = start_offset + static_cast<int32_t>(i / per_channel_size);
  d->decode_batch(indexes.data(), n, group);
}

size_t rans_decoder_decoded_size(void* h) {
  return static_cast<RansDecImpl*>(h)->decoded.size();
}

void rans_decoder_get_decoded(void* h, int32_t* out) {
  auto* d = static_cast<RansDecImpl*>(h);
  std::memcpy(out, d->decoded.data(), d->decoded.size() * sizeof(int32_t));
  d->decoded.clear();
}

// ------------------------------------------------------------ cdf helper
// pmf (float) -> quantized cdf with total 2^precision; zero bins get
// probability stolen from the largest bin (CompressAI-compatible semantics).
void pmf_to_quantized_cdf_c(const float* pmf, int n, int precision,
                            int32_t* out /* n+1 entries */) {
  double total = 0;
  for (int i = 0; i < n; ++i) total += pmf[i] > 0 ? pmf[i] : 0;
  if (total <= 0) total = 1;
  const int32_t scale = 1 << precision;

  out[0] = 0;
  for (int i = 0; i < n; ++i) {
    double p = pmf[i] > 0 ? pmf[i] : 0;
    int32_t f = static_cast<int32_t>(p / total * scale + 0.5);
    out[i + 1] = out[i] + f;
  }
  // normalize end to scale
  int32_t diff = scale - out[n];
  // add the difference to the largest bin (keeps order, avoids zeros)
  if (diff != 0) {
    int best = 0;
    int32_t best_f = -1;
    for (int i = 0; i < n; ++i) {
      int32_t f = out[i + 1] - out[i];
      if (f > best_f) { best_f = f; best = i; }
    }
    for (int i = best + 1; i <= n; ++i) out[i] += diff;
  }
  // steal to fix zero-frequency bins
  for (int i = 0; i < n; ++i) {
    if (out[i + 1] - out[i] == 0) {
      // find the largest bin and steal 1
      int best = -1;
      int32_t best_f = 1;
      for (int j = 0; j < n; ++j) {
        int32_t f = out[j + 1] - out[j];
        if (f > best_f) { best_f = f; best = j; }
      }
      if (best < 0) break;
      if (best < i) {
        for (int j = best + 1; j <= i; ++j) out[j] -= 1;
      } else {
        for (int j = i + 1; j <= best; ++j) out[j] += 1;
      }
    }
  }
}

}  // extern "C"
