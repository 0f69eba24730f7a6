// Native stack loader: multi-threaded TIFF page decoder.
//
// The registration pipeline (kcmc_tpu_torch) consumes image stacks far
// faster than single-threaded Python can decode them when pages are
// LZW/Deflate/PackBits-compressed, so decoding is the runtime's native
// component: this library parses classic and BigTIFF multi-page files
// (single-sample grayscale, stripped layout) once up front, then
// decodes arbitrary page ranges straight into a caller-provided buffer
// with a std::thread pool (one pread'ing, decompressing worker per
// shard of pages).
//
// Exposed as a tiny C ABI consumed by kcmc_tpu_torch/io/tiff.py via ctypes
// (the image has no pybind11; ctypes keeps the boundary dependency-free).
// The Python module has a pure-NumPy fallback implementing the same
// subset, which doubles as the correctness oracle in tests/test_torch_io.py.
//
// Supported: compression none(1) / LZW(5, MSB-first with early change) /
// Deflate(8 and old-style 32946, via zlib) / PackBits(32773);
// 8/16/32-bit unsigned, signed, and 32/64-bit float samples; II and MM
// byte orders; RowsPerStrip in any layout. Tiled TIFFs are rejected.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Strip {
  uint64_t offset;
  uint64_t nbytes;
  uint32_t rows;
};

struct Page {
  std::vector<Strip> strips;
};

struct Stack {
  std::string path;
  uint32_t width = 0, height = 0;
  uint32_t bits = 0;          // bits per sample
  uint32_t sample_format = 1; // 1 uint, 2 int, 3 float
  uint32_t compression = 1;
  bool big_endian = false;
  std::vector<Page> pages;
  std::string error;
};

// ---------------------------------------------------------------------------
// low-level file reading
// ---------------------------------------------------------------------------

struct Reader {
  FILE* f = nullptr;
  bool swap = false;  // file endianness != host (host assumed little)
  ~Reader() { if (f) fclose(f); }

  bool seek(uint64_t off) { return fseeko(f, (off_t)off, SEEK_SET) == 0; }
  bool read(void* dst, size_t n) { return fread(dst, 1, n, f) == n; }

  template <typename T>
  bool get(T* out) {
    if (!read(out, sizeof(T))) return false;
    if (swap) {
      auto* b = reinterpret_cast<unsigned char*>(out);
      for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
    }
    return true;
  }
};

uint64_t swap64(uint64_t v) { return __builtin_bswap64(v); }
uint32_t swap32(uint32_t v) { return __builtin_bswap32(v); }
uint16_t swap16(uint16_t v) { return __builtin_bswap16(v); }

// One parsed IFD entry's values, normalized to uint64.
struct Entry {
  uint16_t tag = 0;
  std::vector<uint64_t> values;
};

// TIFF type sizes indexed by type id (0 unused).
const uint32_t kTypeSize[14] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 8};

// Read an IFD entry's out-of-line value array from `offset`.
bool read_entry_values(Reader& r, uint16_t type, uint64_t count,
                       uint64_t offset, std::vector<uint64_t>* out) {
  out->clear();
  uint32_t tsz = type < 14 ? kTypeSize[type] : 0;
  if (tsz == 0) return false;
  // count comes straight from the file: bound it (largest legitimate
  // arrays are strip tables — one entry per image row at most)
  if (count == 0 || count > (1u << 24)) return false;
  out->reserve(count);
  std::vector<unsigned char> buf;
  buf.resize((size_t)tsz * count);
  off_t keep = ftello(r.f);
  uint64_t value_or_offset = offset;
  if (!r.seek(value_or_offset)) return false;
  if (!r.read(buf.data(), buf.size())) return false;
  fseeko(r.f, keep, SEEK_SET);
  for (uint64_t i = 0; i < count; ++i) {
    const unsigned char* p = buf.data() + (size_t)i * tsz;
    uint64_t v = 0;
    switch (tsz) {
      case 1: v = p[0]; break;
      case 2: { uint16_t x; memcpy(&x, p, 2); v = r.swap ? swap16(x) : x; } break;
      case 4: { uint32_t x; memcpy(&x, p, 4); v = r.swap ? swap32(x) : x; } break;
      case 8: { uint64_t x; memcpy(&x, p, 8); v = r.swap ? swap64(x) : x; } break;
    }
    out->push_back(v);
  }
  return true;
}

// ---------------------------------------------------------------------------
// decompressors
// ---------------------------------------------------------------------------

// TIFF LZW: MSB-first variable-width codes, ClearCode=256, EOI=257,
// "early change" width bumps at next_code 511/1023/2047 (the de-facto
// standard variant written by libtiff, tifffile, ImageJ, ...).
bool lzw_decode(const unsigned char* src, size_t n, unsigned char* dst,
                size_t dst_cap, size_t* written) {
  struct Ent { int32_t prev; unsigned char ch; };
  std::vector<Ent> table(4096);
  unsigned char scratch[4096];
  uint64_t bitbuf = 0;
  int bits = 0;
  size_t si = 0, di = 0;
  int width = 9, next_code = 258;
  int32_t prev = -1;

  auto first_byte = [&](int code) -> int {
    while (code >= 258) code = table[code].prev;
    return code;  // a literal < 256
  };
  auto emit = [&](int code) -> bool {
    int len = 0, c = code;
    while (true) {
      if (len >= 4096) return false;
      if (c < 256) { scratch[len++] = (unsigned char)c; break; }
      scratch[len++] = table[c].ch;
      c = table[c].prev;
    }
    if (di + (size_t)len > dst_cap) return false;
    for (int i = len - 1; i >= 0; --i) dst[di++] = scratch[i];
    return true;
  };

  for (;;) {
    while (bits < width && si < n) { bitbuf = (bitbuf << 8) | src[si++]; bits += 8; }
    if (bits < width) break;
    int code = (int)((bitbuf >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == 256) { width = 9; next_code = 258; prev = -1; continue; }
    if (code == 257) break;
    if (prev < 0) {
      if (code >= 256) return false;
      if (!emit(code)) return false;
    } else if (code < next_code && code != 256 && code != 257) {
      if (!emit(code)) return false;
      if (next_code < 4096) {
        table[next_code].prev = prev;
        table[next_code].ch = (unsigned char)first_byte(code);
        ++next_code;
      }
    } else if (code == next_code && next_code < 4096) {
      // KwKwK: the new entry is prev + first(prev), emitted immediately.
      table[next_code].prev = prev;
      table[next_code].ch = (unsigned char)first_byte(prev);
      ++next_code;
      if (!emit(code)) return false;
    } else {
      return false;  // invalid code stream
    }
    if (next_code >= 2047) width = 12;
    else if (next_code >= 1023) width = 11;
    else if (next_code >= 511) width = 10;
    prev = code;
  }
  *written = di;
  return true;
}

bool zlib_decode(const unsigned char* src, size_t n, unsigned char* dst,
                 size_t dst_cap, size_t* written) {
  uLongf out_len = (uLongf)dst_cap;
  int rc = uncompress(dst, &out_len, src, (uLong)n);
  if (rc != Z_OK) return false;
  *written = out_len;
  return true;
}

bool packbits_decode(const unsigned char* src, size_t n, unsigned char* dst,
                     size_t dst_cap, size_t* written) {
  size_t si = 0, di = 0;
  while (si < n) {
    signed char c = (signed char)src[si++];
    if (c >= 0) {
      size_t len = (size_t)c + 1;
      if (si + len > n || di + len > dst_cap) return false;
      memcpy(dst + di, src + si, len);
      si += len;
      di += len;
    } else if (c != -128) {
      size_t len = (size_t)(-c) + 1;
      if (si >= n || di + len > dst_cap) return false;
      memset(dst + di, src[si++], len);
      di += len;
    }
  }
  *written = di;
  return true;
}

// ---------------------------------------------------------------------------
// page decoding
// ---------------------------------------------------------------------------

bool decode_page(const Stack& st, int fd, const Page& page, unsigned char* out) {
  const size_t bytes_per_px = st.bits / 8;
  const size_t row_bytes = (size_t)st.width * bytes_per_px;
  std::vector<unsigned char> comp;
  size_t out_off = 0;
  for (const Strip& s : page.strips) {
    size_t want = row_bytes * s.rows;
    if (st.compression == 1) {
      // clamp to the expected strip size: StripByteCounts comes from the
      // file and must never size a write into the caller's buffer
      size_t take = s.nbytes < want ? s.nbytes : want;
      if (pread(fd, out + out_off, take, (off_t)s.offset) != (ssize_t)take)
        return false;
      if (take < want) memset(out + out_off + take, 0, want - take);
    } else {
      comp.resize(s.nbytes);
      if (pread(fd, comp.data(), s.nbytes, (off_t)s.offset) != (ssize_t)s.nbytes)
        return false;
      size_t written = 0;
      bool ok = false;
      if (st.compression == 5)
        ok = lzw_decode(comp.data(), s.nbytes, out + out_off, want, &written);
      else if (st.compression == 8 || st.compression == 32946)
        ok = zlib_decode(comp.data(), s.nbytes, out + out_off, want, &written);
      else if (st.compression == 32773)
        ok = packbits_decode(comp.data(), s.nbytes, out + out_off, want, &written);
      if (!ok) return false;
      if (written < want) memset(out + out_off + written, 0, want - written);
    }
    out_off += want;
  }
  // byte-swap to host (little) endianness if needed
  if (st.big_endian && bytes_per_px > 1) {
    size_t n = (size_t)st.width * st.height;
    if (bytes_per_px == 2) {
      uint16_t* p = reinterpret_cast<uint16_t*>(out);
      for (size_t i = 0; i < n; ++i) p[i] = swap16(p[i]);
    } else if (bytes_per_px == 4) {
      uint32_t* p = reinterpret_cast<uint32_t*>(out);
      for (size_t i = 0; i < n; ++i) p[i] = swap32(p[i]);
    } else if (bytes_per_px == 8) {
      uint64_t* p = reinterpret_cast<uint64_t*>(out);
      for (size_t i = 0; i < n; ++i) p[i] = swap64(p[i]);
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// dtype codes matching kcmc_tpu_torch/io/tiff.py: 0 u8, 1 u16, 2 u32, 3 i8,
// 4 i16, 5 i32, 6 f32, 7 f64.
struct KcmcStackInfo {
  uint64_t n_pages;
  uint32_t width;
  uint32_t height;
  int32_t dtype;
};

const char* kcmc_last_error(void* handle) {
  return handle ? static_cast<Stack*>(handle)->error.c_str() : "null handle";
}

int kcmc_open(const char* path, void** handle, KcmcStackInfo* info) {
  auto st = new Stack();
  st->path = path;
  *handle = st;

  Reader r;
  r.f = fopen(path, "rb");
  if (!r.f) { st->error = "cannot open file"; return 1; }

  unsigned char hdr[4];
  if (!r.read(hdr, 4)) { st->error = "short header"; return 1; }
  if (hdr[0] == 'I' && hdr[1] == 'I') r.swap = false;
  else if (hdr[0] == 'M' && hdr[1] == 'M') r.swap = true;
  else { st->error = "not a TIFF"; return 1; }
  st->big_endian = r.swap;
  uint16_t magic = hdr[3] | (hdr[2] << 8);
  if (!r.swap) magic = hdr[2] | (hdr[3] << 8);
  bool big_tiff = magic == 43;
  if (magic != 42 && magic != 43) { st->error = "bad TIFF magic"; return 1; }

  uint64_t ifd_off = 0;
  if (big_tiff) {
    uint16_t off_size, zero;
    if (!r.get(&off_size) || !r.get(&zero) || off_size != 8) {
      st->error = "bad BigTIFF header";
      return 1;
    }
    if (!r.get(&ifd_off)) { st->error = "bad BigTIFF header"; return 1; }
  } else {
    uint32_t off32;
    if (!r.get(&off32)) { st->error = "bad header"; return 1; }
    ifd_off = off32;
  }

  bool first = true;
  while (ifd_off != 0) {
    if (!r.seek(ifd_off)) { st->error = "bad IFD offset"; return 1; }
    uint64_t n_entries;
    if (big_tiff) {
      if (!r.get(&n_entries)) { st->error = "bad IFD"; return 1; }
    } else {
      uint16_t n16;
      if (!r.get(&n16)) { st->error = "bad IFD"; return 1; }
      n_entries = n16;
    }
    uint32_t width = 0, height = 0, bits = 8, comp = 1, spp = 1, fmt = 1;
    uint32_t rows_per_strip = 0xFFFFFFFF;
    std::vector<uint64_t> strip_offsets, strip_counts;
    bool tiled = false;

    for (uint64_t e = 0; e < n_entries; ++e) {
      uint16_t tag, type;
      uint64_t count;
      if (!r.get(&tag) || !r.get(&type)) { st->error = "bad entry"; return 1; }
      if (big_tiff) {
        if (!r.get(&count)) { st->error = "bad entry"; return 1; }
      } else {
        uint32_t c32;
        if (!r.get(&c32)) { st->error = "bad entry"; return 1; }
        count = c32;
      }
      // value field: 4 bytes (classic) or 8 (BigTIFF); may be inline
      unsigned char raw[8] = {0};
      size_t field = big_tiff ? 8 : 4;
      if (!r.read(raw, field)) { st->error = "bad entry"; return 1; }
      uint32_t tsz = type < 14 ? kTypeSize[type] : 0;
      if (tsz == 0 || count == 0) continue;  // unknown type / empty: skip
      std::vector<uint64_t> vals;
      if (tsz * count <= field) {
        // inline values (endianness per file)
        for (uint64_t i = 0; i < count; ++i) {
          const unsigned char* p = raw + i * tsz;
          uint64_t v = 0;
          switch (tsz) {
            case 1: v = p[0]; break;
            case 2: { uint16_t x; memcpy(&x, p, 2); v = r.swap ? swap16(x) : x; } break;
            case 4: { uint32_t x; memcpy(&x, p, 4); v = r.swap ? swap32(x) : x; } break;
            case 8: { uint64_t x; memcpy(&x, p, 8); v = r.swap ? swap64(x) : x; } break;
          }
          vals.push_back(v);
        }
      } else {
        uint64_t off = 0;
        if (big_tiff) { memcpy(&off, raw, 8); if (r.swap) off = swap64(off); }
        else { uint32_t o32; memcpy(&o32, raw, 4); if (r.swap) o32 = swap32(o32); off = o32; }
        if (!read_entry_values(r, type, count, off, &vals)) {
          st->error = "bad entry values";
          return 1;
        }
      }
      if (vals.empty()) continue;
      switch (tag) {
        case 256: width = (uint32_t)vals[0]; break;
        case 257: height = (uint32_t)vals[0]; break;
        case 258: bits = (uint32_t)vals[0]; break;
        case 259: comp = (uint32_t)vals[0]; break;
        case 273: strip_offsets = vals; break;
        case 277: spp = (uint32_t)vals[0]; break;
        case 278: rows_per_strip = (uint32_t)vals[0]; break;
        case 279: strip_counts = vals; break;
        case 322: case 323: case 324: case 325: tiled = true; break;
        case 339: fmt = (uint32_t)vals[0]; break;
        default: break;
      }
    }

    // next IFD offset
    if (big_tiff) {
      if (!r.get(&ifd_off)) ifd_off = 0;
    } else {
      uint32_t n32 = 0;
      if (!r.get(&n32)) n32 = 0;
      ifd_off = n32;
    }

    if (tiled) { st->error = "tiled TIFF not supported"; return 1; }
    if (spp != 1) { st->error = "only single-sample (grayscale) TIFF supported"; return 1; }
    if (comp != 1 && comp != 5 && comp != 8 && comp != 32946 && comp != 32773) {
      st->error = "unsupported compression " + std::to_string(comp);
      return 1;
    }
    if (bits != 8 && bits != 16 && bits != 32 && bits != 64) {
      st->error = "unsupported BitsPerSample";
      return 1;
    }
    if (strip_offsets.empty() || strip_offsets.size() != strip_counts.size()) {
      st->error = "missing strip tables";
      return 1;
    }
    if (first) {
      st->width = width;
      st->height = height;
      st->bits = bits;
      st->compression = comp;
      st->sample_format = fmt;
      first = false;
    } else if (width != st->width || height != st->height || bits != st->bits ||
               comp != st->compression || fmt != st->sample_format) {
      st->error = "non-uniform pages";
      return 1;
    }

    Page pg;
    uint32_t rps = rows_per_strip == 0xFFFFFFFF ? height : rows_per_strip;
    if (rps == 0) rps = height;
    uint32_t rows_left = height;
    for (size_t i = 0; i < strip_offsets.size(); ++i) {
      Strip s;
      s.offset = strip_offsets[i];
      s.nbytes = strip_counts[i];
      s.rows = rows_left < rps ? rows_left : rps;
      rows_left -= s.rows;
      pg.strips.push_back(s);
    }
    st->pages.push_back(std::move(pg));
  }

  if (st->pages.empty()) { st->error = "no pages"; return 1; }
  int dtype = -1;
  if (st->sample_format == 3) dtype = st->bits == 32 ? 6 : (st->bits == 64 ? 7 : -1);
  else if (st->sample_format == 2)
    dtype = st->bits == 8 ? 3 : st->bits == 16 ? 4 : st->bits == 32 ? 5 : -1;
  else dtype = st->bits == 8 ? 0 : st->bits == 16 ? 1 : st->bits == 32 ? 2 : -1;
  if (dtype < 0) { st->error = "unsupported sample format"; return 1; }

  info->n_pages = st->pages.size();
  info->width = st->width;
  info->height = st->height;
  info->dtype = dtype;
  return 0;
}

int kcmc_read_pages(void* handle, uint64_t lo, uint64_t hi, void* out,
                    int n_threads) {
  auto* st = static_cast<Stack*>(handle);
  if (!st) return 1;
  if (hi > st->pages.size() || lo > hi) { st->error = "page range"; return 1; }
  const size_t page_bytes =
      (size_t)st->width * st->height * (st->bits / 8);
  uint64_t n = hi - lo;
  if (n == 0) return 0;
  int workers = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if ((uint64_t)workers > n) workers = (int)n;
  if (workers < 1) workers = 1;

  std::atomic<uint64_t> next(lo);
  std::atomic<bool> failed(false);
  auto work = [&]() {
    int fd = open(st->path.c_str(), O_RDONLY);
    if (fd < 0) { failed = true; return; }
    for (;;) {
      uint64_t p = next.fetch_add(1);
      if (p >= hi || failed) break;
      unsigned char* dst =
          static_cast<unsigned char*>(out) + (p - lo) * page_bytes;
      if (!decode_page(*st, fd, st->pages[p], dst)) { failed = true; break; }
    }
    close(fd);
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < workers; ++i) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  if (failed) { st->error = "decode failed"; return 1; }
  return 0;
}

void kcmc_close(void* handle) { delete static_cast<Stack*>(handle); }

// ---------------------------------------------------------------------------
// Parallel page encoder (the write half of the streaming runtime):
// zlib-deflate n same-size pages concurrently. Python's single-threaded
// zlib caps compressed streaming at ~40 MB/s; the batch drain hands the
// whole corrected batch here and appends the pre-compressed strips.
// ---------------------------------------------------------------------------

uint64_t kcmc_deflate_bound(uint64_t page_bytes) {
  return compressBound((uLong)page_bytes);
}

// Encoder provenance: the version string of the zlib this library links.
// io/tiff.py records it in resume checkpoints — byte-identical resume of
// a deflate stream holds only when the resumed run compresses through
// the same zlib build (a zlib-ng or version-skewed libz produces valid
// but different bytes).
const char* kcmc_zlib_version(void) { return zlibVersion(); }

// src: contiguous (n_pages, page_bytes); dst: n_pages * bound bytes;
// out_sizes[i] receives page i's compressed size. level: zlib 1..9.
// Returns 0 on success. Output is bitwise identical to Python's
// zlib.compress(data, level) (same library, same parameters), so files
// written through either path agree byte for byte.
int kcmc_deflate_pages(const void* src, uint64_t n_pages, uint64_t page_bytes,
                       int level, void* dst, uint64_t bound,
                       uint64_t* out_sizes, int n_threads) {
  if (n_pages == 0) return 0;
  int workers =
      n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if ((uint64_t)workers > n_pages) workers = (int)n_pages;
  if (workers < 1) workers = 1;

  std::atomic<uint64_t> next(0);
  std::atomic<bool> failed(false);
  auto work = [&]() {
    for (;;) {
      uint64_t p = next.fetch_add(1);
      if (p >= n_pages || failed) break;
      uLongf out_n = (uLongf)bound;
      const Bytef* in =
          static_cast<const Bytef*>(src) + p * page_bytes;
      Bytef* out = static_cast<Bytef*>(dst) + p * bound;
      if (compress2(out, &out_n, in, (uLong)page_bytes, level) != Z_OK) {
        failed = true;
        break;
      }
      out_sizes[p] = (uint64_t)out_n;
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < workers; ++i) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return failed ? 1 : 0;
}

}  // extern "C"
