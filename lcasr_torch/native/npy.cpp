// A batch of .npy files read by a thread pool (the port's copy of
// lcasr_tpu/native/npy_native.cpp, which is a CPython extension).  Python
// parses each header (dtype, shape, C order) and allocates the destination;
// this reads each file's data from its offset into its destination, the
// files shared among `threads` threads.  ctypes releases the GIL for the
// call, so a duration-sorted training batch of B podcasts loads with B-way
// parallel I/O.
//
// Built by lcasr_torch/native/__init__.py with g++ -O2 -shared -fPIC -pthread.

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// 0, or an errno (-1: the file ends before its data does)
int read_one(const char* path, int64_t offset, int64_t nbytes, char* dest) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return errno;
  int err = 0;
  int64_t done = 0;
  while (done < nbytes) {
    const ssize_t got = pread(fd, dest + done, static_cast<size_t>(nbytes - done), offset + done);
    if (got < 0) {
      if (errno == EINTR) continue;
      err = errno;
      break;
    }
    if (got == 0) {
      err = -1;
      break;
    }
    done += got;
  }
  close(fd);
  return err;
}

}  // namespace

extern "C" {

// Reads file i's nbytes[i] bytes from offsets[i] into dests[i], for i < n;
// errors[i] is 0 or the file's error.  Returns 0, or 1 + the index of the
// first file that failed.
int npy_read_batch(int n, const char* const* paths, const int64_t* offsets,
                   const int64_t* nbytes, void* const* dests, int threads, int* errors) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next++; i < n; i = next++)
      errors[i] = read_one(paths[i], offsets[i], nbytes[i], static_cast<char*>(dests[i]));
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads && t < n; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (errors[i] != 0) return i + 1;
  return 0;
}

}  // extern "C"
