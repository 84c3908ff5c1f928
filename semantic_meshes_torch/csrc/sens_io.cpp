// Host IO library of semantic_meshes_torch: the ScanNet .sens stream and
// COLMAP images.bin indexers.
//
// Own copy of the JAX package's sens_io.cpp (same functions, structs and
// checks; semantic_meshes_torch/native.py keeps its ctypes and numpy
// layouts in sync and checks them against the size probes below):
//   - sens_parse_header / sens_index: one pass over the stream recording
//     every frame's pose, timestamps and payload offsets (no payload
//     copies),
//   - sens_decode_depth_batch: zlib inflation of many depth frames into
//     one dense uint16 buffer, on one std::thread per hardware thread
//     (the JAX package's copy uses OpenMP; a g++ without OpenMP's
//     runtime builds this one),
//   - colmap_index_images: one pass over images.bin, fixed records plus
//     name spans.
//
// Built by semantic_meshes_torch/_build.py (build_host):
//   g++ -std=c++17 -O3 -fPIC -pthread -Wall -shared sens_io.cpp -lz

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Per-frame metadata record filled by sens_index (laid out for numpy
// structured dtype on the python side; all little-endian host order).
struct FrameRecord {
  float camera_to_world[16];
  uint64_t timestamp_color;
  uint64_t timestamp_depth;
  uint64_t color_offset;
  uint64_t color_size;
  uint64_t depth_offset;
  uint64_t depth_size;
};

struct SensHeader {
  uint32_t version;
  float intrinsic_color[16];
  float extrinsic_color[16];
  float intrinsic_depth[16];
  float extrinsic_depth[16];
  int32_t color_compression;
  int32_t depth_compression;
  uint32_t color_width;
  uint32_t color_height;
  uint32_t depth_width;
  uint32_t depth_height;
  float depth_shift;
  uint64_t num_frames;
  uint64_t frames_start;  // byte offset of the first frame record
  char sensor_name[256];
};

// Parse the .sens header from an in-memory buffer. Returns 0 on success.
int sens_parse_header(const uint8_t* buf, uint64_t size, SensHeader* out) {
  uint64_t off = 0;
  if (size < 4) return -1;
  memcpy(&out->version, buf + off, 4);
  off += 4;
  if (out->version != 4) return -2;
  uint64_t strlen_;
  if (off + 8 > size) return -1;
  memcpy(&strlen_, buf + off, 8);
  off += 8;
  if (off + strlen_ > size) return -1;
  uint64_t ncopy = strlen_ < 255 ? strlen_ : 255;
  memcpy(out->sensor_name, buf + off, ncopy);
  out->sensor_name[ncopy] = 0;
  off += strlen_;
  const uint64_t mat_bytes = 16 * sizeof(float);
  if (off + 4 * mat_bytes + 8 + 16 + 4 + 8 > size) return -1;
  memcpy(out->intrinsic_color, buf + off, mat_bytes); off += mat_bytes;
  memcpy(out->extrinsic_color, buf + off, mat_bytes); off += mat_bytes;
  memcpy(out->intrinsic_depth, buf + off, mat_bytes); off += mat_bytes;
  memcpy(out->extrinsic_depth, buf + off, mat_bytes); off += mat_bytes;
  memcpy(&out->color_compression, buf + off, 4); off += 4;
  memcpy(&out->depth_compression, buf + off, 4); off += 4;
  memcpy(&out->color_width, buf + off, 4); off += 4;
  memcpy(&out->color_height, buf + off, 4); off += 4;
  memcpy(&out->depth_width, buf + off, 4); off += 4;
  memcpy(&out->depth_height, buf + off, 4); off += 4;
  memcpy(&out->depth_shift, buf + off, 4); off += 4;
  memcpy(&out->num_frames, buf + off, 8); off += 8;
  out->frames_start = off;
  return 0;
}

// Walk the frame records, filling `records` (caller allocates max_frames).
// Returns number of frames indexed, or negative on parse error.
int64_t sens_index(const uint8_t* buf, uint64_t size, uint64_t frames_start,
                   FrameRecord* records, uint64_t max_frames) {
  uint64_t off = frames_start;
  uint64_t n = 0;
  while (n < max_frames) {
    if (off == size) break;
    if (off + 16 * 4 + 4 * 8 > size) return -(int64_t)(n + 1);
    FrameRecord& r = records[n];
    memcpy(r.camera_to_world, buf + off, 16 * 4);
    off += 16 * 4;
    memcpy(&r.timestamp_color, buf + off, 8); off += 8;
    memcpy(&r.timestamp_depth, buf + off, 8); off += 8;
    memcpy(&r.color_size, buf + off, 8); off += 8;
    memcpy(&r.depth_size, buf + off, 8); off += 8;
    // validate payload sizes BEFORE advancing: a corrupt size near
    // UINT64_MAX would wrap `off` and pass a post-advance check, leaving
    // out-of-range offsets for the zlib batch decoder to read
    if (r.color_size > size - off) return -(int64_t)(n + 1);
    r.color_offset = off;
    off += r.color_size;
    if (r.depth_size > size - off) return -(int64_t)(n + 1);
    r.depth_offset = off;
    off += r.depth_size;
    n++;
  }
  return (int64_t)n;
}

// Inflate `count` zlib-compressed uint16 depth frames in parallel.
// offsets/sizes index into buf; out is (count * pixels) uint16.
// Returns 0 on success, else 1-based index of the first failing frame.
// One worker per hardware thread (at most `count`), each taking the next
// frame from a shared counter: the dynamic schedule of the JAX package's
// OpenMP loop, without needing OpenMP's runtime.
int64_t sens_decode_depth_batch(const uint8_t* buf,
                                const uint64_t* offsets,
                                const uint64_t* sizes, int64_t count,
                                uint64_t pixels, uint16_t* out) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto work = [&]() {
    for (int64_t i = next.fetch_add(1); i < count; i = next.fetch_add(1)) {
      uLongf dest_len = pixels * sizeof(uint16_t);
      int rc = uncompress(reinterpret_cast<Bytef*>(out + i * pixels),
                          &dest_len, buf + offsets[i],
                          static_cast<uLong>(sizes[i]));
      if (rc != Z_OK || dest_len != pixels * sizeof(uint16_t)) {
        // keep the lowest failing index
        int64_t seen = failed.load();
        while ((seen == 0 || i + 1 < seen) &&
               !failed.compare_exchange_weak(seen, i + 1)) {
        }
      }
    }
  };
  int64_t n_workers = std::max<int64_t>(
      1, std::min<int64_t>(count, std::thread::hardware_concurrency()));
  std::vector<std::thread> workers;
  try {
    for (int64_t w = 1; w < n_workers; w++) workers.emplace_back(work);
  } catch (const std::system_error&) {
    // fewer threads than asked: the ones started and this one finish
  }
  work();
  for (auto& t : workers) t.join();
  return failed.load();
}

int sens_header_size() { return (int)sizeof(SensHeader); }
int sens_record_size() { return (int)sizeof(FrameRecord); }

// ---------------------------------------------------------------------
// COLMAP images.bin indexer. Python parses this file with a per-image
// loop (variable-length names + 2D-point skips defeat numpy
// vectorization); one native pass returns fixed records + name spans.
// Format: u64 count, then per image: i32 id | 4 f64 qvec | 3 f64 tvec |
// i32 camera_id | name\0 | u64 npoints | npoints * (f64 x, f64 y, i64 id).

struct ColmapImageRecord {
  int32_t image_id;
  int32_t camera_id;
  double qvec[4];
  double tvec[3];
  uint64_t name_offset;
  uint64_t name_length;
};

// Returns number of images parsed, or -(1 + failed_index) on error.
int64_t colmap_index_images(const uint8_t* buf, uint64_t size,
                            ColmapImageRecord* recs, uint64_t max_n) {
  uint64_t off = 0;
  if (size < 8) return -1;
  uint64_t count;
  memcpy(&count, buf + off, 8);
  off += 8;
  if (count > max_n) count = max_n;
  for (uint64_t i = 0; i < count; i++) {
    ColmapImageRecord& r = recs[i];
    if (off + 4 + 32 + 24 + 4 > size) return -(int64_t)(i + 1);
    memcpy(&r.image_id, buf + off, 4); off += 4;
    memcpy(r.qvec, buf + off, 32); off += 32;
    memcpy(r.tvec, buf + off, 24); off += 24;
    memcpy(&r.camera_id, buf + off, 4); off += 4;
    r.name_offset = off;
    while (off < size && buf[off] != 0) off++;
    if (off >= size) return -(int64_t)(i + 1);
    r.name_length = off - r.name_offset;
    off++;  // null terminator
    if (off + 8 > size) return -(int64_t)(i + 1);
    uint64_t npoints;
    memcpy(&npoints, buf + off, 8); off += 8;
    // pre-advance check: npoints * 24 can wrap uint64 on corrupt input
    if (npoints > (size - off) / 24) return -(int64_t)(i + 1);
    off += npoints * 24;
  }
  return (int64_t)count;
}

int colmap_image_record_size() { return (int)sizeof(ColmapImageRecord); }

}  // extern "C"
