// Native NIfTI-1 decoder: gzip inflate + header parse + voxel cast to fp32,
// with a per-subject call that decodes the modality files on one thread
// each (the port's own copy of the JAX package's runtime/nifti_loader.cc).
//
// The Python reader (data/nifti.py) is the reference: on the files it
// reads, this returns the same fp32 voxels bit for bit. The port's copy
// differs from the JAX one in three places, none of which changes a voxel
// of a file both read: the probe inflates the header only (not the whole
// volume); the scale applies only for a finite slope other than 0 and 1, as
// the Python reader's does; and the unsigned and 64-bit integer voxel types
// (768, 1024, 1280) are read as the Python reader reads them.
//
// Built on first use by xlstm_hved_torch/utils/cuda_build.py:
//   g++ -O3 -fPIC -shared -std=c++17 -Wall nifti_loader.cc -lz -lpthread
//
// C API (all return 0 on success, negative on error):
//   nifti_read_f32(path, out_buf, out_capacity, shape_out[8])
//       decode one .nii/.nii.gz into fp32 (Fortran voxel order preserved,
//       matching the numpy reader); shape_out[0]=ndim, [1..]=dims.
//   nifti_probe(path, shape_out[8])  -> header-only probe.
//   nifti_read_subject_f32(dir, subject, suffixes_csv, out, cap, shape_out)
//       decode all modalities of one subject concurrently (one thread per
//       file) into a stacked (n_mod, ...) fp32 buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kHeaderSize = 348;

struct Header {
  int ndim;
  int64_t dims[7];
  int16_t datatype;
  float vox_offset;
  float scl_slope;
  float scl_inter;
};

// Read a file, inflating if gzip (magic 1f 8b); with a limit > 0, stop once
// that many bytes are out (the probe reads the header only).
int read_all(const char* path, std::vector<uint8_t>& out, size_t limit = 0) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(n);
  if (std::fread(raw.data(), 1, n, f) != static_cast<size_t>(n)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  if (n >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    // gzip: stream-inflate with growth
    z_stream zs{};
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return -3;
    out.resize(limit ? std::max<size_t>(limit, 1 << 16)
                     : static_cast<size_t>(std::max<long>(4 * n, 1 << 20)));
    zs.next_in = raw.data();
    zs.avail_in = static_cast<uInt>(n);
    size_t written = 0;
    int ret = Z_OK;
    while (ret != Z_STREAM_END && (limit == 0 || written < limit)) {
      if (written == out.size()) out.resize(out.size() * 2);
      zs.next_out = out.data() + written;
      zs.avail_out = static_cast<uInt>(out.size() - written);
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs);
        return -4;
      }
      written = out.size() - zs.avail_out;
    }
    inflateEnd(&zs);
    out.resize(written);
  } else {
    out = std::move(raw);
  }
  return 0;
}

int parse_header(const std::vector<uint8_t>& buf, Header* h) {
  if (buf.size() < kHeaderSize) return -5;
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, buf.data(), 4);
  if (sizeof_hdr != kHeaderSize) return -6;  // big-endian unsupported here
  int16_t dim[8];
  std::memcpy(dim, buf.data() + 40, 16);
  h->ndim = dim[0];
  if (h->ndim < 1 || h->ndim > 7) return -7;
  for (int i = 0; i < 7; ++i) h->dims[i] = i < h->ndim ? dim[i + 1] : 1;
  std::memcpy(&h->datatype, buf.data() + 70, 2);
  std::memcpy(&h->vox_offset, buf.data() + 108, 4);
  std::memcpy(&h->scl_slope, buf.data() + 112, 4);
  std::memcpy(&h->scl_inter, buf.data() + 116, 4);
  const uint8_t* magic = buf.data() + 344;
  if (std::memcmp(magic, "n+1", 3) != 0 && std::memcmp(magic, "ni1", 3) != 0)
    return -8;
  return 0;
}

template <typename T>
void cast_to_f32(const uint8_t* src, float* dst, int64_t count, float slope,
                 float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  bool scaled = slope != 0.0f && slope != 1.0f && std::isfinite(slope);
  for (int64_t i = 0; i < count; ++i) {
    float v = static_cast<float>(s[i]);
    dst[i] = scaled ? v * slope + inter : v;
  }
}

int decode_to(const char* path, float* out, int64_t capacity,
              int64_t shape_out[8]) {
  std::vector<uint8_t> buf;
  int rc = read_all(path, buf, out ? 0 : kHeaderSize);
  if (rc != 0) return rc;
  Header h;
  rc = parse_header(buf, &h);
  if (rc != 0) return rc;
  int64_t count = 1;
  for (int i = 0; i < h.ndim; ++i) count *= h.dims[i];
  if (shape_out) {
    shape_out[0] = h.ndim;
    for (int i = 0; i < 7; ++i) shape_out[i + 1] = h.dims[i];
  }
  if (!out) return 0;  // probe only
  if (count > capacity) return -9;
  size_t offset = static_cast<size_t>(h.vox_offset);
  if (offset < kHeaderSize + 4) offset = kHeaderSize + 4;
  if (buf.size() < offset) return -10;
  const uint8_t* vox = buf.data() + offset;
  size_t avail = buf.size() - offset;
  auto need = [&](size_t itemsize) { return count * itemsize <= avail; };
  switch (h.datatype) {
    case 2:  if (!need(1)) return -11;
      cast_to_f32<uint8_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 4:  if (!need(2)) return -11;
      cast_to_f32<int16_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 8:  if (!need(4)) return -11;
      cast_to_f32<int32_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 16: if (!need(4)) return -11;
      cast_to_f32<float>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 64: if (!need(8)) return -11;
      cast_to_f32<double>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 256: if (!need(1)) return -11;
      cast_to_f32<int8_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 512: if (!need(2)) return -11;
      cast_to_f32<uint16_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 768: if (!need(4)) return -11;
      cast_to_f32<uint32_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 1024: if (!need(8)) return -11;
      cast_to_f32<int64_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    case 1280: if (!need(8)) return -11;
      cast_to_f32<uint64_t>(vox, out, count, h.scl_slope, h.scl_inter); break;
    default: return -12;
  }
  return 0;
}

}  // namespace

extern "C" {

int nifti_probe(const char* path, int64_t shape_out[8]) {
  return decode_to(path, nullptr, 0, shape_out);
}

int nifti_read_f32(const char* path, float* out, int64_t capacity,
                   int64_t shape_out[8]) {
  return decode_to(path, out, capacity, shape_out);
}

// Decode several modality files of one subject concurrently into a stacked
// buffer. suffixes_csv e.g. "t1c,t1n,t2f,t2w". All files must share a shape.
int nifti_read_subject_f32(const char* dir, const char* subject,
                           const char* suffixes_csv, float* out,
                           int64_t capacity, int64_t shape_out[8]) {
  std::vector<std::string> suffixes;
  {
    std::string csv(suffixes_csv);
    size_t pos = 0;
    while (pos != std::string::npos) {
      size_t next = csv.find(',', pos);
      suffixes.push_back(csv.substr(
          pos, next == std::string::npos ? next : next - pos));
      pos = next == std::string::npos ? next : next + 1;
    }
  }
  int n = static_cast<int>(suffixes.size());
  // probe the first file for the voxel count
  std::string base = std::string(dir) + "/" + subject + "/" + subject + "-";
  auto path_for = [&](const std::string& suffix) {
    std::string p = base + suffix + ".nii.gz";
    FILE* f = std::fopen(p.c_str(), "rb");
    if (f) { std::fclose(f); return p; }
    return base + suffix + ".nii";
  };
  int64_t shape[8];
  int rc = nifti_probe(path_for(suffixes[0]).c_str(), shape);
  if (rc != 0) return rc;
  int64_t count = 1;
  for (int i = 0; i < shape[0]; ++i) count *= shape[i + 1];
  if (count * n > capacity) return -9;
  if (shape_out) {
    shape_out[0] = shape[0] + 1;
    shape_out[1] = n;
    for (int i = 0; i < 7 - 1; ++i) shape_out[i + 2] = shape[i + 1];
  }
  std::vector<int> rcs(n, 0);
  std::vector<std::thread> threads;
  for (int m = 0; m < n; ++m) {
    threads.emplace_back([&, m]() {
      int64_t sh[8];
      rcs[m] = nifti_read_f32(path_for(suffixes[m]).c_str(), out + m * count,
                              count, sh);
      if (rcs[m] == 0) {
        for (int i = 0; i < shape[0]; ++i)
          if (sh[i + 1] != shape[i + 1]) rcs[m] = -13;
      }
    });
  }
  for (auto& t : threads) t.join();
  for (int m = 0; m < n; ++m)
    if (rcs[m] != 0) return rcs[m];
  return 0;
}

}  // extern "C"
