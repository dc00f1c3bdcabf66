// Async tensor file I/O for NVMe offload: the host side of ZeRO-Infinity.
//
// Port of the JAX package's csrc/aio.cpp (reference csrc/aio/: the libaio
// thread pool of deepspeed_aio_thread.cpp and deepspeed_py_aio_handle.cpp).
// A std::thread pool issues pread/pwrite of whole buffers at byte offsets,
// with no libaio or io_uring dependency: submit N operations, overlap them
// with host compute, wait. A file holds the buffer's raw bytes at the given
// offset, exactly as the JAX package's handle writes them, so either
// package reads the other's swap files. The caller keeps every buffer alive
// and unmodified until ds_aio_wait returns.

#include <fcntl.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct AioOp {
  bool write;
  void* buf;
  int64_t nbytes;
  std::string path;
  int64_t offset;
};

struct AioHandle {
  std::vector<std::thread> workers;
  std::queue<AioOp> queue;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  int64_t inflight = 0;
  int64_t errors = 0;
  bool shutdown = false;

  explicit AioHandle(int num_threads) {
    for (int t = 0; t < num_threads; ++t) workers.emplace_back([this] { run(); });
  }

  ~AioHandle() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  void submit(AioOp op) {
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push(std::move(op));
      ++inflight;
    }
    cv_work.notify_one();
  }

  int64_t wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return inflight == 0; });
    int64_t e = errors;
    errors = 0;
    return e;
  }

  static bool do_io(const AioOp& op) {
    int flags = op.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = ::open(op.path.c_str(), flags, 0644);
    if (fd < 0) return false;
    char* p = static_cast<char*>(op.buf);
    int64_t left = op.nbytes, off = op.offset;
    bool ok = true;
    while (left > 0) {
      ssize_t r = op.write ? ::pwrite(fd, p, left, off) : ::pread(fd, p, left, off);
      if (r <= 0) {
        ok = false;
        break;
      }
      p += r;
      off += r;
      left -= r;
    }
    ::close(fd);
    return ok;
  }

  void run() {
    for (;;) {
      AioOp op;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return shutdown || !queue.empty(); });
        if (queue.empty()) return;  // shutdown with drained queue
        op = std::move(queue.front());
        queue.pop();
      }
      bool ok = do_io(op);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) ++errors;
        --inflight;
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ds_aio_handle_create(int num_threads) { return new AioHandle(num_threads > 0 ? num_threads : 1); }

void ds_aio_handle_destroy(void* h) { delete static_cast<AioHandle*>(h); }

void ds_aio_pwrite(void* h, const void* buf, int64_t nbytes, const char* path, int64_t offset) {
  static_cast<AioHandle*>(h)->submit(AioOp{true, const_cast<void*>(buf), nbytes, path, offset});
}

void ds_aio_pread(void* h, void* buf, int64_t nbytes, const char* path, int64_t offset) {
  static_cast<AioHandle*>(h)->submit(AioOp{false, buf, nbytes, path, offset});
}

// Blocks until all submitted ops complete; returns the number of failures.
int64_t ds_aio_wait(void* h) { return static_cast<AioHandle*>(h)->wait(); }

}  // extern "C"
