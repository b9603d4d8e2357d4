// Shared-memory SPSC ring buffer: the DataLoader's native batch transport.
//
// Reference analog: the C++ shared-memory tensor path of the reference's
// multiprocess DataLoader (memory/allocation/mmap_allocator.cc +
// operators/reader/buffered_reader.h): worker processes hand whole batches to
// the trainer through shared memory instead of pickling them over a pipe.
//
// Design: one single-producer/single-consumer ring per worker process.
//  * POSIX shm_open + mmap; the parent creates/unlinks, the worker attaches.
//  * Lock-free: head (consumer) and tail (producer) are C++11 atomics with
//    acquire/release ordering; each side owns exactly one index.
//  * Messages are length-prefixed (8 bytes). A message never wraps: if the
//    contiguous space before the end is too small, the producer writes a
//    WRAP sentinel and restarts at offset 0 (classic "bip buffer" discipline).
//  * Blocking behavior (timeouts, polling cadence) stays in Python; C exposes
//    only non-blocking try_push/try_pop so the GIL is never held inside a wait.
//
// Built with: cc -O2 -shared -fPIC shm_ring.cpp -o libshmring.so  (no deps)

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kWrapSentinel = ~0ull;
constexpr uint64_t kHeaderLen = 8;

struct RingHeader {
  std::atomic<uint64_t> head;  // consumer position (bytes)
  std::atomic<uint64_t> tail;  // producer position (bytes)
  uint64_t capacity;           // data[] size in bytes
  uint64_t magic;
};

constexpr uint64_t kMagic = 0x70616464726e6731ull;  // "paddrng1"

inline char* data_of(RingHeader* h) {
  return reinterpret_cast<char*>(h) + sizeof(RingHeader);
}

inline uint64_t used(uint64_t head, uint64_t tail, uint64_t cap) {
  return tail >= head ? tail - head : cap - head + tail;
}

}  // namespace

extern "C" {

// Create (parent) or attach (worker) the ring. Returns nullptr on error.
void* shmring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(RingHeader) + capacity;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
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
  auto* h = static_cast<RingHeader*>(mem);
  h->head.store(0, std::memory_order_relaxed);
  h->tail.store(0, std::memory_order_relaxed);
  h->capacity = capacity;
  h->magic = kMagic;
  return mem;
}

void* shmring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = static_cast<RingHeader*>(mem);
  if (h->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  return mem;
}

uint64_t shmring_capacity(void* ring) {
  return static_cast<RingHeader*>(ring)->capacity;
}

// Bytes of free contiguous-or-wrapped space (one byte kept to tell full/empty).
uint64_t shmring_free_bytes(void* ring) {
  auto* h = static_cast<RingHeader*>(ring);
  uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  return h->capacity - used(head, tail, h->capacity) - 1;
}

// Non-blocking push of one framed message. 0 = ok, -1 = not enough space,
// -2 = message can never fit this ring.
int shmring_try_push(void* ring, const void* buf, uint64_t n) {
  auto* h = static_cast<RingHeader*>(ring);
  uint64_t cap = h->capacity;
  // worst case needs a wrap sentinel header too
  if (n + 2 * kHeaderLen + 1 > cap) return -2;
  uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t free_b = cap - used(head, tail, cap) - 1;
  if (n + 2 * kHeaderLen > free_b) return -1;

  char* base = data_of(h);
  uint64_t contiguous = cap - tail;
  if (contiguous < n + kHeaderLen) {
    // wrap: sentinel tells the consumer to jump to offset 0. The sentinel
    // header itself must fit; if not even 8 bytes remain, the consumer's
    // implicit-wrap rule below covers it.
    if (contiguous >= kHeaderLen) {
      std::memcpy(base + tail, &kWrapSentinel, kHeaderLen);
    }
    tail = 0;
    // re-check space from the wrapped position against the consumer
    if (n + kHeaderLen >= head) {
      // consumer hasn't drained the low region yet; retry later. tail in
      // shared memory is unchanged, so this wrap attempt is invisible.
      return -1;
    }
  }
  std::memcpy(base + tail, &n, kHeaderLen);
  std::memcpy(base + tail + kHeaderLen, buf, n);
  h->tail.store(tail + kHeaderLen + n, std::memory_order_release);
  return 0;
}

// Non-blocking: peek the next message length. -1 = empty.
int64_t shmring_peek_len(void* ring) {
  auto* h = static_cast<RingHeader*>(ring);
  uint64_t cap = h->capacity;
  uint64_t tail = h->tail.load(std::memory_order_acquire);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  for (;;) {
    if (head == tail) return -1;
    uint64_t contiguous = cap - head;
    uint64_t len;
    if (contiguous < kHeaderLen) {
      head = 0;  // implicit wrap: no room for even a sentinel header
      continue;
    }
    std::memcpy(&len, data_of(h) + head, kHeaderLen);
    if (len == kWrapSentinel) {
      head = 0;
      continue;
    }
    return static_cast<int64_t>(len);
  }
}

// Non-blocking pop into out (size max_n). Returns message length, -1 = empty,
// -2 = out buffer too small (message left in place).
int64_t shmring_try_pop(void* ring, void* out, uint64_t max_n) {
  auto* h = static_cast<RingHeader*>(ring);
  uint64_t cap = h->capacity;
  uint64_t tail = h->tail.load(std::memory_order_acquire);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  for (;;) {
    if (head == tail) return -1;
    uint64_t contiguous = cap - head;
    uint64_t len;
    if (contiguous < kHeaderLen) {
      head = 0;
      continue;
    }
    std::memcpy(&len, data_of(h) + head, kHeaderLen);
    if (len == kWrapSentinel) {
      head = 0;
      continue;
    }
    if (len > max_n) return -2;
    std::memcpy(out, data_of(h) + head + kHeaderLen, len);
    h->head.store(head + kHeaderLen + len, std::memory_order_release);
    return static_cast<int64_t>(len);
  }
}

void shmring_detach(void* ring) {
  auto* h = static_cast<RingHeader*>(ring);
  munmap(ring, sizeof(RingHeader) + h->capacity);
}

int shmring_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
