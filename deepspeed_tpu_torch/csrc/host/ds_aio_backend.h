// Common interface + shared scaffolding for the async-IO backends behind the
// ds_aio C ABI.
//
// The reference's handle (csrc/aio/py_lib/deepspeed_py_aio_handle.cpp) is a
// libaio io_context with a submit/complete thread pool; its queue depth is a
// property of the io_context, not the thread count. Our pool backend
// (ds_aio.cpp) approximates that with pread/pwrite workers — queue depth
// capped at num_threads — and the io_uring backend (ds_aio_uring.cpp) is the
// real equivalent: one driver thread keeping queue_depth kernel-async ops in
// flight. Both share the invariant-bearing machinery here so fd lifecycle,
// group completion, and wait() semantics live in exactly one place:
//   - one submit() call = one DsAioGroup owning the fds;
//   - completing the group's last sub-op closes the fds (long offload runs
//     must not exhaust the fd limit);
//   - sync submitters free the group after observing remaining == 0 under
//     mu_ (never while a worker still touches it);
//   - async group errors latch until the next wait().

#ifndef DS_AIO_BACKEND_H_
#define DS_AIO_BACKEND_H_

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <mutex>

struct DsAioBackend {
  // Sync (async_op == false): block until the whole transfer completes,
  // return 0 or -1. Async: queue and return the number of sub-ops (>0);
  // completion is fenced by wait().
  virtual int64_t submit(bool write, const char* path, void* buf,
                         int64_t nbytes, int64_t offset, bool async_op) = 0;
  // Block until all queued ops finish; return completed sub-op count since
  // the last wait, or -1 if any async group errored since the last wait.
  virtual int64_t wait() = 0;
  virtual const char* name() const = 0;
  virtual ~DsAioBackend() = default;
};

// One submit() call = one group; owns the fds.
struct DsAioGroup {
  int fd;          // buffered fd (always valid)
  int fd_direct;   // O_DIRECT fd, or -1 (filesystem refused / direct off)
  bool async_owned;  // completer deletes the group after the last sub-op
  int64_t remaining;  // guarded by the backend's mu_
  std::atomic<int64_t> errors{0};
  DsAioGroup(int fd_, int fdd_, bool async_, int64_t n)
      : fd(fd_), fd_direct(fdd_), async_owned(async_), remaining(n) {}
};

// Shared submit/complete/wait scaffolding. Subclasses implement the enqueue
// step (how sub-ops reach the worker pool / the ring driver) and call
// complete_one() exactly once per finished sub-op.
class DsAioGroupBackend : public DsAioBackend {
 public:
  int64_t submit(bool write, const char* path, void* buf, int64_t nbytes,
                 int64_t offset, bool async_op) final {
    int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = open(path, flags, 0644);
    if (fd < 0) return -1;
    int fd_direct = -1;
    if (o_direct_ && block_size_ % kDirectAlign == 0) {
      // refused O_DIRECT (e.g. tmpfs) silently degrades to buffered IO
      fd_direct = open(path, flags | O_DIRECT, 0644);
    }
    int64_t split = split_bytes(nbytes);
    int64_t n = split > 0 ? (nbytes + split - 1) / split : 0;
    if (n == 0) {  // zero-byte op: no completer will ever close the fds
      close(fd);
      if (fd_direct >= 0) close(fd_direct);
      return 0;
    }
    auto* group = new DsAioGroup(fd, fd_direct, async_op, n);
    {
      std::lock_guard<std::mutex> lk(mu_);
      enqueue_chunks(write, static_cast<char*>(buf), nbytes, offset, split,
                     group);
      outstanding_ += n;
    }
    cv_.notify_all();
    if (!async_op) {
      int64_t rc;
      {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [&] { return group->remaining == 0; });
        rc = group->errors.load() ? -1 : 0;
      }
      delete group;  // completer already closed the fds
      return rc;
    }
    return n;
  }

  int64_t wait() final {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return outstanding_ == 0; });
    int64_t done = completed_;
    completed_ = 0;
    int64_t failed = async_group_errors_;
    async_group_errors_ = 0;
    return failed ? -1 : done;
  }

 protected:
  static constexpr int64_t kDirectAlign = 4096;

  DsAioGroupBackend(int64_t block_size, bool o_direct)
      : block_size_(block_size > 0 ? block_size : (1 << 20)),
        o_direct_(o_direct) {}

  // Bytes per sub-op for an nbytes transfer (pool: nbytes/num_threads
  // rounded to a block multiple; uring: block_size).
  virtual int64_t split_bytes(int64_t nbytes) const = 0;
  // Queue ceil(nbytes/split) sub-ops for the group. Called with mu_ held.
  virtual void enqueue_chunks(bool write, char* buf, int64_t nbytes,
                              int64_t offset, int64_t split,
                              DsAioGroup* group) = 0;

  // All group completion accounting happens inside one critical section: a
  // sync submitter only observes remaining==0 while holding mu_, i.e.
  // strictly after the close/delete below have finished, so it can never
  // free the group while the completer still touches it.
  void complete_one(DsAioGroup* g, bool ok) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      --outstanding_;
      ++completed_;
      if (!ok) g->errors.fetch_add(1);
      if (--g->remaining == 0) {
        close(g->fd);
        if (g->fd_direct >= 0) close(g->fd_direct);
        if (g->async_owned) {
          if (g->errors.load()) ++async_group_errors_;
          delete g;
        }
      }
    }
    done_cv_.notify_all();
  }

  int64_t block_size_;
  bool o_direct_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  int64_t outstanding_ = 0;         // guarded by mu_
  int64_t completed_ = 0;           // guarded by mu_
  int64_t async_group_errors_ = 0;  // guarded by mu_
  bool shutdown_ = false;           // guarded by mu_
};

// Factory in ds_aio_uring.cpp; returns nullptr when the kernel refuses
// io_uring or lacks IORING_OP_READ/WRITE (pre-5.6), so callers fall back to
// the pool backend.
DsAioBackend* ds_aio_make_uring(int64_t block_size, int queue_depth,
                                bool o_direct);

#endif  // DS_AIO_BACKEND_H_
