// Native NRRD decode + raw-cache loader.
//
// The episodic eval re-reads gzip-compressed NRRD volumes from disk on every
// episode (the reference does the same through pynrrd,
// dataset/few_shot_reader.py:326-334). This library:
//   * parses the NRRD header and inflates gzip/zlib payloads with zlib
//     directly into a caller buffer (no intermediate copies);
//   * converts NRRD → a flat ".rawcache" file once, after which loads are a
//     single pread into the caller's buffer (or an OS page-cache hit).
//
// Exposed as plain C symbols for ctypes (rpnet_tpu_torch/core/native_cache.py).
// A copy of rpnet_tpu/native/nrrd_cache.cpp with the same symbols and the
// same .rawcache layout, so the two packages' caches interchange. Built with
// g++ -O3 -shared -fPIC ... -lz at first use (ops/kernels.build_shared).
// Raw-cache layout: magic "RPNC" | u32 version | u32 dtype_code | u32 ndim |
// u64 sizes[ndim] | payload (C-order of the reversed-transposed array, i.e.
// the NRRD on-disk element order: first listed axis fastest).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x43504e52;  // "RNPC" little-endian bytes "RPNC"
constexpr uint32_t kVersion = 1;

struct Header {
  uint32_t dtype_code = 0;  // numpy-ish: 1=i1 2=u1 3=i2 4=u2 5=i4 6=u4
                            //            7=i8 8=u8 9=f4 10=f8
  uint32_t ndim = 0;
  std::vector<uint64_t> sizes;
  std::string encoding;     // raw | gzip | zlib
  long payload_offset = 0;
  size_t elem_size = 0;
};

size_t dtype_size(uint32_t code) {
  switch (code) {
    case 1: case 2: return 1;
    case 3: case 4: return 2;
    case 5: case 6: case 9: return 4;
    case 7: case 8: case 10: return 8;
  }
  return 0;
}

uint32_t dtype_from_nrrd(const std::string& t) {
  std::string s;
  for (char c : t) s += static_cast<char>(tolower(c));
  if (s == "signed char" || s == "int8" || s == "int8_t") return 1;
  if (s == "uchar" || s == "unsigned char" || s == "uint8" || s == "uint8_t") return 2;
  if (s == "short" || s == "short int" || s == "signed short" || s == "int16" || s == "int16_t") return 3;
  if (s == "ushort" || s == "unsigned short" || s == "uint16" || s == "uint16_t") return 4;
  if (s == "int" || s == "signed int" || s == "int32" || s == "int32_t") return 5;
  if (s == "uint" || s == "unsigned int" || s == "uint32" || s == "uint32_t") return 6;
  if (s == "longlong" || s == "long long" || s == "int64" || s == "int64_t") return 7;
  if (s == "ulonglong" || s == "unsigned long long" || s == "uint64" || s == "uint64_t") return 8;
  if (s == "float") return 9;
  if (s == "double") return 10;
  return 0;
}

bool parse_header(FILE* f, Header* h) {
  char line[4096];
  if (!fgets(line, sizeof(line), f)) return false;
  if (strncmp(line, "NRRD", 4) != 0) return false;
  h->encoding = "raw";
  while (fgets(line, sizeof(line), f)) {
    size_t len = strlen(line);
    while (len && (line[len - 1] == '\n' || line[len - 1] == '\r')) line[--len] = 0;
    if (len == 0) break;           // blank line = end of header
    if (line[0] == '#') continue;
    char* colon = strstr(line, ": ");
    if (!colon) {
      colon = strstr(line, ":=");
      if (!colon) continue;
    }
    std::string key(line, colon - line);
    std::string val(colon + 2);
    for (auto& c : key) c = static_cast<char>(tolower(c));
    if (key == "type") {
      h->dtype_code = dtype_from_nrrd(val);
    } else if (key == "dimension") {
      h->ndim = static_cast<uint32_t>(atoi(val.c_str()));
    } else if (key == "sizes") {
      h->sizes.clear();
      const char* p = val.c_str();
      char* end = nullptr;
      while (*p) {
        uint64_t v = strtoull(p, &end, 10);
        if (end == p) break;
        h->sizes.push_back(v);
        p = end;
      }
    } else if (key == "encoding") {
      for (auto& c : val) c = static_cast<char>(tolower(c));
      h->encoding = val;
    } else if (key == "endian") {
      if (val != "little") return false;  // big-endian unsupported
    } else if (key == "data file" || key == "datafile") {
      return false;                        // detached headers unsupported
    }
  }
  h->payload_offset = ftell(f);
  h->elem_size = dtype_size(h->dtype_code);
  return h->elem_size != 0 && h->ndim > 0 && h->sizes.size() == h->ndim;
}

size_t total_elems(const Header& h) {
  size_t n = 1;
  for (uint64_t s : h.sizes) n *= static_cast<size_t>(s);
  return n;
}

bool inflate_all(const unsigned char* src, size_t src_len,
                 unsigned char* dst, size_t dst_len, bool gzip_wrapper) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  // 15 window bits; +32 autodetects zlib/gzip wrappers
  if (inflateInit2(&zs, gzip_wrapper ? (15 + 32) : 15) != Z_OK) return false;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_len);
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return (ret == Z_STREAM_END || ret == Z_OK) && zs.total_out == dst_len;
}

bool read_payload(FILE* f, const Header& h, unsigned char* out, size_t out_len) {
  fseek(f, 0, SEEK_END);
  long end = ftell(f);
  size_t comp_len = static_cast<size_t>(end - h.payload_offset);
  fseek(f, h.payload_offset, SEEK_SET);
  if (h.encoding == "raw") {
    return fread(out, 1, out_len, f) == out_len;
  }
  std::vector<unsigned char> comp(comp_len);
  if (fread(comp.data(), 1, comp_len, f) != comp_len) return false;
  return inflate_all(comp.data(), comp_len, out, out_len, true);
}

}  // namespace

extern "C" {

// Query header: fills dtype_code, ndim, sizes (caller provides sizes[16]).
// Returns 0 on success.
int nrrd_query(const char* path, uint32_t* dtype_code, uint32_t* ndim,
               uint64_t* sizes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  bool ok = parse_header(f, &h);
  fclose(f);
  if (!ok || h.ndim > 16) return -2;
  *dtype_code = h.dtype_code;
  *ndim = h.ndim;
  for (uint32_t i = 0; i < h.ndim; ++i) sizes[i] = h.sizes[i];
  return 0;
}

// Decode the full payload (NRRD element order) into `out` (size out_len).
int nrrd_read_into(const char* path, unsigned char* out, uint64_t out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!parse_header(f, &h)) { fclose(f); return -2; }
  size_t need = total_elems(h) * h.elem_size;
  if (need != out_len) { fclose(f); return -3; }
  bool ok = read_payload(f, h, out, need);
  fclose(f);
  return ok ? 0 : -4;
}

// Convert NRRD → .rawcache (decode once, then loads are a single pread).
int nrrd_to_rawcache(const char* nrrd_path, const char* cache_path) {
  FILE* f = fopen(nrrd_path, "rb");
  if (!f) return -1;
  Header h;
  if (!parse_header(f, &h)) { fclose(f); return -2; }
  size_t need = total_elems(h) * h.elem_size;
  std::vector<unsigned char> buf(need);
  bool ok = read_payload(f, h, buf.data(), need);
  fclose(f);
  if (!ok) return -3;

  std::string tmp = std::string(cache_path) + ".tmp";
  FILE* o = fopen(tmp.c_str(), "wb");
  if (!o) return -4;
  uint32_t magic = kMagic, version = kVersion;
  fwrite(&magic, 4, 1, o);
  fwrite(&version, 4, 1, o);
  fwrite(&h.dtype_code, 4, 1, o);
  fwrite(&h.ndim, 4, 1, o);
  for (uint32_t i = 0; i < h.ndim; ++i) {
    uint64_t s = h.sizes[i];
    fwrite(&s, 8, 1, o);
  }
  fwrite(buf.data(), 1, need, o);
  fclose(o);
  if (rename(tmp.c_str(), cache_path) != 0) return -5;
  return 0;
}

// Read a .rawcache: query (dtype, ndim, sizes) or payload into `out`.
int rawcache_query(const char* path, uint32_t* dtype_code, uint32_t* ndim,
                   uint64_t* sizes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0, version = 0;
  if (fread(&magic, 4, 1, f) != 1 || magic != kMagic) { fclose(f); return -2; }
  fread(&version, 4, 1, f);
  fread(dtype_code, 4, 1, f);
  fread(ndim, 4, 1, f);
  if (*ndim > 16) { fclose(f); return -3; }
  for (uint32_t i = 0; i < *ndim; ++i) fread(&sizes[i], 8, 1, f);
  fclose(f);
  return 0;
}

int rawcache_read_into(const char* path, unsigned char* out, uint64_t out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0, version = 0, dtype = 0, ndim = 0;
  fread(&magic, 4, 1, f);
  if (magic != kMagic) { fclose(f); return -2; }
  fread(&version, 4, 1, f);
  fread(&dtype, 4, 1, f);
  fread(&ndim, 4, 1, f);
  fseek(f, static_cast<long>(ndim) * 8, SEEK_CUR);
  size_t got = fread(out, 1, out_len, f);
  fclose(f);
  return got == out_len ? 0 : -3;
}

}  // extern "C"
