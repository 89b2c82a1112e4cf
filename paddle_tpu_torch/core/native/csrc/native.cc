// The port's native queue tier: the two queues of the JAX package's host
// runtime that the DataLoader uses, built with g++ at first use and bound
// with ctypes (``__init__.py`` beside this directory).
//
//   1. ptq_*  -- an in-process bounded blocking byte queue (the prefetch
//      buffer of the reference's operators/reader/blocking_queue.h).
//   2. shr_*  -- a POSIX shared-memory ring queue, the transport of the
//      DataLoader's worker processes (the reference's memory-mapped
//      dataloader queues): pickled batches from workers to the parent
//      without a socket. A message larger than the ring is refused (-4).
//
// A flat C ABI; ``ptn_abi_version`` says which.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>

#define API extern "C" __attribute__((visibility("default")))

namespace {

timespec deadline_from_now(double timeout_s) {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  int64_t ns = ts.tv_nsec + (int64_t)((timeout_s - (int64_t)timeout_s) * 1e9);
  ts.tv_sec += (time_t)timeout_s + ns / 1000000000;
  ts.tv_nsec = ns % 1000000000;
  return ts;
}

}  // namespace

// ===========================================================================
// 1. In-process blocking queue (bounded, byte payloads)
// ===========================================================================

struct Ptq {
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::deque<std::string> items;
  size_t capacity;
  bool closed = false;
};

API void* ptq_create(size_t capacity) {
  auto* q = new Ptq();
  q->capacity = capacity ? capacity : 1;
  return q;
}

// 0 ok; -1 timeout; -2 closed
API int ptq_push(void* h, const void* data, size_t n, double timeout_s) {
  auto* q = (Ptq*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_s < 0) {
    q->not_full.wait(lk, pred);
  } else if (!q->not_full.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), pred)) {
    return -1;
  }
  if (q->closed) return -2;
  q->items.emplace_back((const char*)data, n);
  q->not_empty.notify_one();
  return 0;
}

// >=0 size of next item; -1 timeout; -2 closed+empty
API long long ptq_peek_size(void* h, double timeout_s) {
  auto* q = (Ptq*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return q->closed || !q->items.empty(); };
  if (timeout_s < 0) {
    q->not_empty.wait(lk, pred);
  } else if (!q->not_empty.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), pred)) {
    return -1;
  }
  if (q->items.empty()) return -2;
  return (long long)q->items.front().size();
}

// >=0 bytes copied; -1 timeout; -2 closed+empty; -3 buffer too small
API long long ptq_pop(void* h, void* out, size_t max_n, double timeout_s) {
  auto* q = (Ptq*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return q->closed || !q->items.empty(); };
  if (timeout_s < 0) {
    q->not_empty.wait(lk, pred);
  } else if (!q->not_empty.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), pred)) {
    return -1;
  }
  if (q->items.empty()) return -2;
  std::string& s = q->items.front();
  if (s.size() > max_n) return -3;
  memcpy(out, s.data(), s.size());
  long long n = (long long)s.size();
  q->items.pop_front();
  q->not_full.notify_one();
  return n;
}

API size_t ptq_size(void* h) {
  auto* q = (Ptq*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

API void ptq_close(void* h) {
  auto* q = (Ptq*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

API void ptq_destroy(void* h) { delete (Ptq*)h; }

// ===========================================================================
// 2. Shared-memory ring queue (multiprocess dataloader transport)
// ===========================================================================

struct ShmHeader {
  uint64_t magic;
  uint64_t capacity;  // ring bytes
  uint64_t head;      // read offset (logical)
  uint64_t tail;      // write offset (logical)
  uint64_t used;      // bytes in ring
  uint64_t closed;
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
};

struct Shr {
  ShmHeader* hdr;
  uint8_t* data;
  size_t map_bytes;
  std::string name;
};

static const uint64_t kShrMagic = 0x70747173686d7231ULL;

static void shr_copy_in(Shr* r, uint64_t off, const void* src, uint64_t n) {
  uint64_t cap = r->hdr->capacity;
  uint64_t o = off % cap;
  uint64_t first = (n <= cap - o) ? n : cap - o;
  memcpy(r->data + o, src, first);
  if (n > first) memcpy(r->data, (const uint8_t*)src + first, n - first);
}

static void shr_copy_out(Shr* r, uint64_t off, void* dst, uint64_t n) {
  uint64_t cap = r->hdr->capacity;
  uint64_t o = off % cap;
  uint64_t first = (n <= cap - o) ? n : cap - o;
  memcpy(dst, r->data + o, first);
  if (n > first) memcpy((uint8_t*)dst + first, r->data, n - first);
}

API void* shr_create(const char* name, size_t ring_bytes) {
  size_t total = sizeof(ShmHeader) + ring_bytes;
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = (ShmHeader*)mem;
  memset(hdr, 0, sizeof(ShmHeader));
  hdr->capacity = ring_bytes;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_cond_init(&hdr->not_full, &ca);
  hdr->magic = kShrMagic;

  auto* r = new Shr{hdr, (uint8_t*)mem + sizeof(ShmHeader), total, name};
  return r;
}

API void* shr_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = (ShmHeader*)mem;
  if (hdr->magic != kShrMagic) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  auto* r = new Shr{hdr, (uint8_t*)mem + sizeof(ShmHeader),
                    (size_t)st.st_size, name};
  return r;
}

static int shr_lock(ShmHeader* hdr) {
  int rc = pthread_mutex_lock(&hdr->mu);
  if (rc == EOWNERDEAD) {  // a worker died holding the lock
    pthread_mutex_consistent(&hdr->mu);
    return 0;
  }
  return rc;
}

// 0 ok; -1 timeout; -2 closed; -4 message larger than ring
API int shr_push(void* h, const void* data, size_t n, double timeout_s) {
  auto* r = (Shr*)h;
  ShmHeader* hdr = r->hdr;
  uint64_t need = n + 8;
  if (need > hdr->capacity) return -4;
  if (shr_lock(hdr) != 0) return -2;
  timespec dl = deadline_from_now(timeout_s < 0 ? 3600.0 : timeout_s);
  while (!hdr->closed && hdr->capacity - hdr->used < need) {
    int rc = pthread_cond_timedwait(&hdr->not_full, &hdr->mu, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mu);
      return -1;
    }
  }
  if (hdr->closed) {
    pthread_mutex_unlock(&hdr->mu);
    return -2;
  }
  uint64_t len = n;
  shr_copy_in(r, hdr->tail, &len, 8);
  shr_copy_in(r, hdr->tail + 8, data, n);
  hdr->tail += need;
  hdr->used += need;
  pthread_cond_signal(&hdr->not_empty);
  pthread_mutex_unlock(&hdr->mu);
  return 0;
}

// >=0 bytes of message copied; -1 timeout; -2 closed+empty; -3 too small
API long long shr_pop(void* h, void* out, size_t max_n, double timeout_s) {
  auto* r = (Shr*)h;
  ShmHeader* hdr = r->hdr;
  if (shr_lock(hdr) != 0) return -2;
  timespec dl = deadline_from_now(timeout_s < 0 ? 3600.0 : timeout_s);
  while (!hdr->closed && hdr->used == 0) {
    int rc = pthread_cond_timedwait(&hdr->not_empty, &hdr->mu, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mu);
      return -1;
    }
  }
  if (hdr->used == 0) {
    pthread_mutex_unlock(&hdr->mu);
    return -2;
  }
  uint64_t len = 0;
  shr_copy_out(r, hdr->head, &len, 8);
  if (len > max_n) {
    pthread_mutex_unlock(&hdr->mu);
    return -3;
  }
  shr_copy_out(r, hdr->head + 8, out, len);
  hdr->head += len + 8;
  hdr->used -= len + 8;
  pthread_cond_signal(&hdr->not_full);
  pthread_mutex_unlock(&hdr->mu);
  return (long long)len;
}

// size of the next message without consuming it (same error codes as pop)
API long long shr_peek_size(void* h, double timeout_s) {
  auto* r = (Shr*)h;
  ShmHeader* hdr = r->hdr;
  if (shr_lock(hdr) != 0) return -2;
  timespec dl = deadline_from_now(timeout_s < 0 ? 3600.0 : timeout_s);
  while (!hdr->closed && hdr->used == 0) {
    int rc = pthread_cond_timedwait(&hdr->not_empty, &hdr->mu, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mu);
      return -1;
    }
  }
  if (hdr->used == 0) {
    pthread_mutex_unlock(&hdr->mu);
    return -2;
  }
  uint64_t len = 0;
  shr_copy_out(r, hdr->head, &len, 8);
  pthread_mutex_unlock(&hdr->mu);
  return (long long)len;
}

API void shr_close_queue(void* h) {
  auto* r = (Shr*)h;
  if (shr_lock(r->hdr) == 0) {
    r->hdr->closed = 1;
    pthread_cond_broadcast(&r->hdr->not_empty);
    pthread_cond_broadcast(&r->hdr->not_full);
    pthread_mutex_unlock(&r->hdr->mu);
  }
}

API void shr_detach(void* h) {
  auto* r = (Shr*)h;
  munmap((void*)((uint8_t*)r->data - sizeof(ShmHeader)), r->map_bytes);
  delete r;
}

API void shr_unlink(const char* name) { shm_unlink(name); }

API int ptn_abi_version() { return 1; }
