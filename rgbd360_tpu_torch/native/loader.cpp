// Native rig-capture decoder for rgbd360_tpu_torch (a copy of the
// reference's native/loader.cpp with a plain C interface).
//
// Decodes the boost-archive `sphere_images_*.bin` rig format (the layout
// documented in rgbd360_tpu_torch/io/bin_format.py, matching the reference
// writer at include/Frame360.h:333-347 + the cv::Mat framing of
// OpenNI2_Grabber/third_party/cvSerialization/cvmat_serialization.h)
// straight into caller-owned buffers, and offers a threaded batch decode
// so host I/O overlaps device compute.  The interface is plain C, loaded
// with ctypes (which releases the GIL for the call): no Python or numpy
// headers are needed to build it.  Unlike the reference's copy, the
// sensor images may have any size (every matrix's header carries it), so
// the reduced captures of the tests decode too; every matrix of a file
// must have the size of the first.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kSignature[] = "serialization::archive";
// 8-byte length + 22-byte signature + 7 header bytes + 8 bytes class meta
constexpr size_t kPreamble = 8 + 22 + 7 + 8;
constexpr uint64_t kCv8UC3 = 16;
constexpr uint64_t kCv16UC1 = 2;

struct MatHeader {
  int32_t cols;
  int32_t rows;
  uint64_t elem_size;
  uint64_t elem_type;
};

// Memory-maps a file; unmapped and closed on destruction.
struct Mapped {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  ~Mapped() {
    if (data) munmap((void*)data, size);
    if (fd >= 0) close(fd);
  }
};

bool MapFile(const std::string& path, Mapped* m, std::string* err) {
  m->fd = open(path.c_str(), O_RDONLY);
  if (m->fd < 0) {
    *err = "cannot open " + path;
    return false;
  }
  struct stat st;
  if (fstat(m->fd, &st) != 0) {
    *err = "cannot stat " + path;
    return false;
  }
  m->size = st.st_size;
  if (m->size == 0) {
    *err = path + ": not a boost serialization archive";
    return false;
  }
  void* p = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) {
    m->data = nullptr;
    *err = "cannot mmap " + path;
    return false;
  }
  m->data = (const uint8_t*)p;
  return true;
}

bool CheckArchive(const Mapped& map, const std::string& path, std::string* err) {
  if (map.size < kPreamble + sizeof(MatHeader) ||
      memcmp(map.data + 8, kSignature, sizeof(kSignature) - 1) != 0) {
    *err = path + ": not a boost serialization archive";
    return false;
  }
  return true;
}

// The (rows, cols) of a capture's first matrix.
bool Shape(const std::string& path, int* rows, int* cols, std::string* err) {
  Mapped map;
  if (!MapFile(path, &map, err) || !CheckArchive(map, path, err)) return false;
  MatHeader h;
  memcpy(&h, map.data + kPreamble, sizeof(h));
  *rows = h.rows;
  *cols = h.cols;
  return true;
}

// Decodes `sensors` (rgb, depth) pairs of rows x cols and the timestamp.
bool DecodeOne(const std::string& path, int sensors, int rows, int cols,
               uint8_t* rgb, uint8_t* depth, uint64_t* timestamp,
               std::string* err) {
  Mapped map;
  if (!MapFile(path, &map, err) || !CheckArchive(map, path, err)) return false;
  const uint8_t* buf = map.data;
  const size_t n = map.size;
  const size_t rgb_bytes = size_t(rows) * cols * 3;
  const size_t depth_bytes = size_t(rows) * cols * 2;
  size_t off = kPreamble;
  for (int s = 0; s < sensors; ++s) {
    MatHeader h;
    if (off + sizeof(h) > n) {
      *err = path + ": truncated (rgb header)";
      return false;
    }
    memcpy(&h, buf + off, sizeof(h));
    off += sizeof(h);
    if (h.cols != cols || h.rows != rows || h.elem_size != 3 ||
        h.elem_type != kCv8UC3) {
      *err = path + ": unexpected rgb mat layout";
      return false;
    }
    if (off + rgb_bytes > n) {
      *err = path + ": truncated (rgb data)";
      return false;
    }
    memcpy(rgb + size_t(s) * rgb_bytes, buf + off, rgb_bytes);
    off += rgb_bytes;

    if (off + sizeof(h) > n) {
      *err = path + ": truncated (depth header)";
      return false;
    }
    memcpy(&h, buf + off, sizeof(h));
    off += sizeof(h);
    if (h.cols != cols || h.rows != rows || h.elem_size != 2 ||
        h.elem_type != kCv16UC1) {
      *err = path + ": unexpected depth mat layout";
      return false;
    }
    if (off + depth_bytes > n) {
      *err = path + ": truncated (depth data)";
      return false;
    }
    memcpy(depth + size_t(s) * depth_bytes, buf + off, depth_bytes);
    off += depth_bytes;
  }
  // trailing timestamp mat (may be empty)
  *timestamp = 0;
  if (off + sizeof(MatHeader) <= n) {
    MatHeader h;
    memcpy(&h, buf + off, sizeof(h));
    off += sizeof(h);
    size_t bytes = size_t(h.cols) * h.rows * h.elem_size;
    if (bytes == 8 && off + 8 <= n) memcpy(timestamp, buf + off, 8);
  }
  return true;
}

int Fail(const std::string& msg, char* err, int err_len) {
  if (err_len > 0) snprintf(err, err_len, "%s", msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

// (rows, cols) of the capture's sensor images; 0 on success, else 1 with
// the message in err.
int rgbd360_rig_frame_shape(const char* path, int* rows, int* cols, char* err,
                            int err_len) {
  std::string e;
  if (!Shape(path, rows, cols, &e)) return Fail(e, err, err_len);
  return 0;
}

// One capture into rgb (sensors, rows, cols, 3) u8 and depth (sensors,
// rows, cols) u16 buffers; 0 on success, else 1 with the message in err.
int rgbd360_read_rig_frame(const char* path, int sensors, int rows, int cols,
                           uint8_t* rgb, uint8_t* depth, uint64_t* timestamp,
                           char* err, int err_len) {
  std::string e;
  if (!DecodeOne(path, sensors, rows, cols, rgb, depth, timestamp, &e))
    return Fail(e, err, err_len);
  return 0;
}

// n captures of one shape on up to n_threads threads, into consecutive
// slots of rgb / depth / timestamps; 0 on success, else 1 with the first
// failing file's message in err.
int rgbd360_read_rig_frame_batch(const char* const* paths, int n, int sensors,
                                 int rows, int cols, uint8_t* rgb,
                                 uint8_t* depth, uint64_t* timestamps,
                                 int n_threads, char* err, int err_len) {
  const size_t rgb_frame = size_t(sensors) * rows * cols * 3;
  const size_t depth_frame = size_t(sensors) * rows * cols * 2;
  std::vector<std::string> errors(n);
  std::vector<char> ok(n, 0);
  std::atomic<int> next{0};
  int workers = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int i = next++; i < n; i = next++) {
        ok[i] = DecodeOne(paths[i], sensors, rows, cols, rgb + i * rgb_frame,
                          depth + i * depth_frame, timestamps + i, &errors[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (!ok[i]) return Fail(errors[i], err, err_len);
  return 0;
}

}  // extern "C"
