// Parallel block I/O core for the .wbx dataset container.
//
// The port's copy of weatherbenchx_tpu/native/blockstore.cpp. The
// framework's durable artifacts (AggregationState checkpoints, metric
// outputs, climatologies) are dense arrays. The numpy .npz path serializes
// through zipfile with per-member CRC32 on one thread (~hundreds of MB/s);
// this core does thread-parallel pwrite/pread of raw aligned blocks
// instead, saturating page-cache/NVMe bandwidth, and the lazy reader's
// coalesced positional window reads (lazy.BlockSource). The container
// layout (magic, manifest, offsets) is owned by the Python side
// (weatherbenchx_tpu_torch/io.py), which also has a pure-Python fallback
// reading/writing the identical format.
//
// Exposed as a plain C ABI for ctypes binding.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <atomic>

namespace {

// Full-length pwrite/pread loops (syscalls may write/read short).
int pwrite_full(int fd, const char* buf, int64_t nbytes, int64_t offset) {
  while (nbytes > 0) {
    ssize_t n = ::pwrite(fd, buf, static_cast<size_t>(nbytes), offset);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    buf += n;
    offset += n;
    nbytes -= n;
  }
  return 0;
}

int pread_full(int fd, char* buf, int64_t nbytes, int64_t offset) {
  while (nbytes > 0) {
    ssize_t n = ::pread(fd, buf, static_cast<size_t>(nbytes), offset);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    if (n == 0) return EIO;  // unexpected EOF
    buf += n;
    offset += n;
    nbytes -= n;
  }
  return 0;
}

template <typename Fn>
int run_parallel(int64_t n, int threads, Fn fn) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int e = fn(i);
      if (e != 0) err.store(e);
    }
  };
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return err.load();
}

}  // namespace

extern "C" {

// Writes n blocks at the given absolute offsets. Creates the file if
// needed; existing contents outside the blocks are preserved.
// Returns 0 on success, else an errno value.
int bs_pwrite_blocks(const char* path, int64_t n, const void** ptrs,
                     const int64_t* sizes, const int64_t* offsets,
                     int threads) {
  int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return errno;
  int err = run_parallel(n, threads, [&](int64_t i) {
    return pwrite_full(fd, static_cast<const char*>(ptrs[i]), sizes[i],
                       offsets[i]);
  });
  if (::close(fd) != 0 && err == 0) err = errno;
  return err;
}

// Reads n blocks from the given absolute offsets into caller buffers.
int bs_pread_blocks(const char* path, int64_t n, void** ptrs,
                    const int64_t* sizes, const int64_t* offsets,
                    int threads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return errno;
  int err = run_parallel(n, threads, [&](int64_t i) {
    return pread_full(fd, static_cast<char*>(ptrs[i]), sizes[i], offsets[i]);
  });
  if (::close(fd) != 0 && err == 0) err = errno;
  return err;
}

}  // extern "C"
