// io_uring backend for the ds_aio handle: the TPU-host equivalent of the
// reference's libaio io_context (csrc/aio/py_lib/deepspeed_aio_thread.cpp),
// where queue depth is a property of the kernel submission ring rather than
// of a thread pool. One driver thread keeps up to queue_depth kernel-async
// reads/writes in flight; per-slot 4 KiB-aligned bounce buffers (allocated
// lazily) serve the O_DIRECT path — the reference's pinned-buffer pattern.
// Built on raw syscalls (io_uring_setup/enter/register + mmap'd rings)
// because the image ships no liburing.

#if !defined(__linux__) || !__has_include(<linux/io_uring.h>)

#include "ds_aio_backend.h"

// No io_uring headers on this build host: the pool backend carries all IO.
DsAioBackend* ds_aio_make_uring(int64_t, int, bool) { return nullptr; }

#else

#include <linux/io_uring.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <deque>
#include <thread>
#include <vector>

#include "ds_aio_backend.h"

namespace {

// IORING_OP_READ/WRITE are enum values added in kernel 5.6 headers; use the
// ABI-stable numbers so 5.1-5.5 headers still compile (the runtime probe
// below rejects kernels that cannot execute them).
constexpr uint8_t kOpRead = 22;   // IORING_OP_READ
constexpr uint8_t kOpWrite = 23;  // IORING_OP_WRITE
constexpr unsigned kRegisterProbe = 8;  // IORING_REGISTER_PROBE
constexpr uint16_t kOpSupported = 1;    // IO_URING_OP_SUPPORTED

#ifndef IORING_FEAT_SINGLE_MMAP
#define IORING_FEAT_SINGLE_MMAP (1U << 0)
#endif

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                  min_complete, flags, nullptr, 0));
}

int sys_io_uring_register(int fd, unsigned opcode, void* arg,
                          unsigned nr_args) {
  return static_cast<int>(syscall(__NR_io_uring_register, fd, opcode, arg,
                                  nr_args));
}

// Local mirror of struct io_uring_probe (added in 5.6 headers) — ABI-stable.
struct ProbeResult {
  uint8_t last_op;
  uint8_t ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  struct {
    uint8_t op;
    uint8_t resv;
    uint16_t flags;
    uint32_t resv2;
  } ops[256];
};

// True iff the kernel executes IORING_OP_READ/WRITE (5.6+). A 5.1-5.5
// kernel happily creates rings whose read/write sqes all fail -EINVAL;
// probing here keeps backend=auto from selecting a broken uring.
bool ring_supports_rw(int ring_fd) {
  ProbeResult probe;
  memset(&probe, 0, sizeof(probe));
  if (sys_io_uring_register(ring_fd, kRegisterProbe, &probe, 256) < 0)
    return false;  // pre-5.6: no probe op, and no OP_READ/WRITE either
  return probe.last_op >= kOpWrite &&
         (probe.ops[kOpRead].flags & kOpSupported) &&
         (probe.ops[kOpWrite].flags & kOpSupported);
}

struct Ring {
  int fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;
  // sq ring
  void* sq_ptr = nullptr;
  size_t sq_sz = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  // cq ring
  void* cq_ptr = nullptr;
  size_t cq_sz = 0;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  struct io_uring_cqe* cqes = nullptr;
  // sqe array
  struct io_uring_sqe* sqes = nullptr;
  size_t sqes_sz = 0;
  bool single_mmap = false;

  bool init(unsigned entries) {
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    fd = sys_io_uring_setup(entries, &p);
    if (fd < 0) return false;
    if (!ring_supports_rw(fd)) return false;
    sq_entries = p.sq_entries;
    cq_entries = p.cq_entries;
    sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
    single_mmap = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
    if (single_mmap) sq_sz = cq_sz = sq_sz > cq_sz ? sq_sz : cq_sz;
    sq_ptr = mmap(nullptr, sq_sz, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) return false;
    cq_ptr = single_mmap
                 ? sq_ptr
                 : mmap(nullptr, cq_sz, PROT_READ | PROT_WRITE,
                        MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ptr == MAP_FAILED) return false;
    sqes_sz = p.sq_entries * sizeof(struct io_uring_sqe);
    sqes = static_cast<struct io_uring_sqe*>(
        mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
    if (sqes == MAP_FAILED) return false;
    auto* sq = static_cast<char*>(sq_ptr);
    sq_head = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    auto* cq = static_cast<char*>(cq_ptr);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes = reinterpret_cast<struct io_uring_cqe*>(cq + p.cq_off.cqes);
    return true;
  }

  ~Ring() {
    if (sqes && sqes != MAP_FAILED) munmap(sqes, sqes_sz);
    if (cq_ptr && cq_ptr != MAP_FAILED && !single_mmap) munmap(cq_ptr, cq_sz);
    if (sq_ptr && sq_ptr != MAP_FAILED) munmap(sq_ptr, sq_sz);
    if (fd >= 0) close(fd);
  }
};

struct Chunk {
  DsAioGroup* group;
  char* ubuf;      // user buffer for this chunk
  int64_t len;
  int64_t off;     // file offset
  bool write;
  bool direct;     // submitted on fd_direct through a bounce slot
  int slot = -1;
};

class UringBackend : public DsAioGroupBackend {
 public:
  static UringBackend* create(int64_t block_size, int queue_depth,
                              bool o_direct) {
    auto* b = new UringBackend(block_size, queue_depth, o_direct);
    if (!b->ring_.init(static_cast<unsigned>(queue_depth))) {
      delete b;
      return nullptr;
    }
    if (o_direct) {
      // slots allocate lazily in prep() — queue_depth * block_size up
      // front could be GiBs the handle never uses, and an allocation
      // failure must degrade that chunk to buffered IO, not kill create
      b->slots_.resize(b->qd_, nullptr);
      for (int i = 0; i < b->qd_; ++i) b->free_slots_.push_back(i);
    }
    b->driver_ = std::thread([b] { b->drive(); });
    return b;
  }

  const char* name() const override { return "uring"; }

  ~UringBackend() override {
    if (driver_.joinable()) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        shutdown_ = true;
      }
      cv_.notify_all();
      driver_.join();
    }
    for (char* s : slots_) free(s);
  }

 protected:
  int64_t split_bytes(int64_t) const override { return block_size_; }

  void enqueue_chunks(bool write, char* buf, int64_t nbytes, int64_t offset,
                      int64_t split, DsAioGroup* group) override {
    for (int64_t off = 0; off < nbytes; off += split) {
      auto* c = new Chunk();
      c->group = group;
      c->ubuf = buf + off;
      c->len = off + split <= nbytes ? split : nbytes - off;
      c->off = offset + off;
      c->write = write;
      c->direct = group->fd_direct >= 0 && c->off % kDirectAlign == 0 &&
                  c->len % kDirectAlign == 0;
      incoming_.push_back(c);
    }
  }

 private:
  UringBackend(int64_t block_size, int queue_depth, bool o_direct)
      : DsAioGroupBackend(block_size, o_direct), qd_(queue_depth) {}

  // Finish the (rare) unaligned / short remainder of a chunk synchronously
  // on the buffered fd; returns false on IO error.
  bool finish_sync(Chunk* c, int64_t from) {
    while (from < c->len) {
      ssize_t r = c->write
                      ? pwrite(c->group->fd, c->ubuf + from, c->len - from,
                               c->off + from)
                      : pread(c->group->fd, c->ubuf + from, c->len - from,
                              c->off + from);
      if (r <= 0) return false;
      from += r;
    }
    return true;
  }

  void complete_chunk(Chunk* c, bool ok) {
    if (c->slot >= 0) free_slots_.push_back(c->slot);
    complete_one(c->group, ok);
    delete c;
  }

  // Push one sqe for `c` (direct chunks go through their bounce slot).
  void prep(Chunk* c, unsigned* local_tail) {
    if (c->direct && slots_[c->slot] == nullptr &&
        posix_memalign(reinterpret_cast<void**>(&slots_[c->slot]),
                       kDirectAlign, block_size_) != 0) {
      // can't get an aligned buffer: degrade this chunk to buffered IO
      slots_[c->slot] = nullptr;
      free_slots_.push_back(c->slot);
      c->slot = -1;
      c->direct = false;
    }
    unsigned idx = *local_tail & *ring_.sq_mask;
    struct io_uring_sqe* sqe = &ring_.sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    char* addr = c->ubuf;
    int fd = c->group->fd;
    if (c->direct) {
      addr = slots_[c->slot];
      fd = c->group->fd_direct;
      if (c->write) memcpy(addr, c->ubuf, c->len);
    }
    sqe->opcode = c->write ? kOpWrite : kOpRead;
    sqe->fd = fd;
    sqe->addr = reinterpret_cast<uint64_t>(addr);
    sqe->len = static_cast<unsigned>(c->len);
    sqe->off = static_cast<uint64_t>(c->off);
    sqe->user_data = reinterpret_cast<uint64_t>(c);
    ring_.sq_array[idx] = idx;
    ++*local_tail;
  }

  void drive() {
    std::deque<Chunk*> pending;
    unsigned local_tail = *ring_.sq_tail;
    unsigned credit = 0;  // sqes published but not yet consumed by the kernel
    int64_t inflight = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        while (!incoming_.empty()) {
          pending.push_back(incoming_.front());
          incoming_.pop_front();
        }
        if (pending.empty() && inflight == 0) {
          if (shutdown_) return;
          cv_.wait(lk);
          continue;
        }
      }
      // fill the ring up to queue depth
      unsigned nsub = 0;
      while (inflight < qd_ && !pending.empty()) {
        Chunk* c = pending.front();
        if (c->direct) {
          if (free_slots_.empty()) break;  // all bounce slots busy
          c->slot = free_slots_.back();
          free_slots_.pop_back();
        }
        pending.pop_front();
        prep(c, &local_tail);
        ++nsub;
        ++inflight;
      }
      if (nsub)
        __atomic_store_n(ring_.sq_tail, local_tail, __ATOMIC_RELEASE);
      credit += nsub;
      // enter both submits the outstanding credit and (when there is
      // nothing new to push) blocks for at least one completion; a short
      // submit (r < credit) leaves the remainder in credit for the next
      // pass instead of stranding published sqes forever
      bool block = inflight > 0 && nsub == 0;
      int r = sys_io_uring_enter(ring_.fd, credit, block ? 1 : 0,
                                 block ? IORING_ENTER_GETEVENTS : 0);
      if (r >= 0) {
        credit -= static_cast<unsigned>(r) <= credit
                      ? static_cast<unsigned>(r)
                      : credit;
      } else if (errno != EINTR && errno != EBUSY && errno != EAGAIN) {
        // transient errnos (EINTR signal, EBUSY full cq, EAGAIN kernel
        // resource pressure) retry next pass with credit intact; anything
        // else means the batch was refused outright — the last `credit`
        // published sqes were not consumed, so rewind the tail (a later
        // enter must never replay sqes whose chunks we free here) and fail
        // exactly those chunks plus anything still pending
        local_tail -= credit;
        __atomic_store_n(ring_.sq_tail, local_tail, __ATOMIC_RELEASE);
        for (unsigned i = 0; i < credit; ++i) {
          unsigned idx = (local_tail + i) & *ring_.sq_mask;
          auto* c = reinterpret_cast<Chunk*>(ring_.sqes[idx].user_data);
          --inflight;
          complete_chunk(c, false);
        }
        credit = 0;
        while (!pending.empty()) {
          complete_chunk(pending.front(), false);
          pending.pop_front();
        }
      }
      // reap completions
      unsigned head = *ring_.cq_head;
      unsigned tail = __atomic_load_n(ring_.cq_tail, __ATOMIC_ACQUIRE);
      while (head != tail) {
        struct io_uring_cqe* cqe = &ring_.cqes[head & *ring_.cq_mask];
        auto* c = reinterpret_cast<Chunk*>(cqe->user_data);
        int res = cqe->res;
        ++head;
        --inflight;
        if (res == -EAGAIN) {  // transient: resubmit the whole chunk
          if (c->slot >= 0) {
            free_slots_.push_back(c->slot);
            c->slot = -1;
          }
          pending.push_back(c);
          continue;
        }
        if (res <= 0) {
          complete_chunk(c, false);
          continue;
        }
        if (c->direct && !c->write)
          memcpy(c->ubuf, slots_[c->slot], res);
        bool ok = true;
        if (res < c->len) ok = finish_sync(c, res);
        complete_chunk(c, ok);
      }
      __atomic_store_n(ring_.cq_head, head, __ATOMIC_RELEASE);
    }
  }

  int qd_;
  Ring ring_;
  std::vector<char*> slots_;     // driver-owned aligned bounce buffers
  std::vector<int> free_slots_;  // driver-thread only
  std::thread driver_;
  std::deque<Chunk*> incoming_;  // guarded by mu_ (filled by enqueue_chunks)
};

}  // namespace

DsAioBackend* ds_aio_make_uring(int64_t block_size, int queue_depth,
                                bool o_direct) {
  return UringBackend::create(block_size, queue_depth, o_direct);
}

#endif  // __has_include(<linux/io_uring.h>)
