// The pixel upload's host copy: a pool of threads that copies a buffer in
// pieces, the calling thread among them.
//
// Built with g++ by tpuenc_torch/upload.py and bound with ctypes.  Torch's
// own parallel copy runs on its OpenMP pool, whose threads spin for
// milliseconds after every copy; between the encodes of a call they kept
// seven cores busy and slowed the calling thread.  These threads spin for
// at most kSpin after a copy (long enough to span the gap between two
// slabs of one upload), then sleep on a condition variable.
//
// One copy at a time a pool: tpuenc_copy returns once every piece is done.
// Pieces are handed out by one atomic ticket that holds the copy's
// generation, its number of pieces and the next piece to take:
// (generation << 40) | (pieces << 20) | next.  A thread takes a piece only
// by moving the ticket from a value whose next is below its own piece
// count, so a thread late from one copy, holding a stale ticket, can take
// no piece once the copy's last has been taken, and never reads the
// fields of the next copy before they are published with its ticket.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kPiece = 512 << 10;
constexpr auto kSpin = std::chrono::microseconds(500);
constexpr int kGenShift = 40;
constexpr int kPiecesShift = 20;
constexpr uint64_t kField = (uint64_t{1} << kPiecesShift) - 1;  // 20 bits

int64_t next_of(uint64_t t) { return static_cast<int64_t>(t & kField); }
int64_t pieces_of(uint64_t t) {
  return static_cast<int64_t>((t >> kPiecesShift) & kField);
}

struct Pool {
  std::vector<std::thread> threads;
  std::mutex mutex;
  std::condition_variable wake;
  bool stop = false;
  std::atomic<uint64_t> ticket{0};
  std::atomic<int64_t> done{0};
  // The current copy: written before its ticket is published, and read
  // only by a thread that has taken one of its pieces.
  uint8_t* dst = nullptr;
  const uint8_t* src = nullptr;
  int64_t n = 0;

  // Copy pieces of the current copy until none is left.
  void work() {
    uint64_t t = ticket.load(std::memory_order_acquire);
    while (next_of(t) < pieces_of(t)) {
      if (!ticket.compare_exchange_weak(t, t + 1, std::memory_order_acq_rel,
                                        std::memory_order_acquire)) {
        continue;
      }
      const int64_t a = next_of(t) * kPiece;
      const int64_t len = n - a < kPiece ? n - a : kPiece;
      std::memcpy(dst + a, src + a, static_cast<size_t>(len));
      done.fetch_add(1, std::memory_order_release);
      t = ticket.load(std::memory_order_acquire);
    }
  }

  void run() {
    uint64_t seen = 0;
    for (;;) {
      const auto until = std::chrono::steady_clock::now() + kSpin;
      uint64_t gen = ticket.load(std::memory_order_acquire) >> kGenShift;
      while (gen == seen && std::chrono::steady_clock::now() < until) {
        std::this_thread::yield();
        gen = ticket.load(std::memory_order_acquire) >> kGenShift;
      }
      if (gen == seen) {
        std::unique_lock<std::mutex> lock(mutex);
        wake.wait(lock, [&] {
          return stop ||
                 (ticket.load(std::memory_order_acquire) >> kGenShift) != seen;
        });
        if (stop) return;
        gen = ticket.load(std::memory_order_acquire) >> kGenShift;
      }
      seen = gen;
      work();
    }
  }
};

}  // namespace

extern "C" void* tpuenc_copy_pool_new(int32_t threads) {
  Pool* pool = new Pool();
  for (int32_t i = 0; i < threads; ++i) {
    pool->threads.emplace_back([pool] { pool->run(); });
  }
  return pool;
}

extern "C" void tpuenc_copy_pool_free(void* handle) {
  Pool* pool = static_cast<Pool*>(handle);
  {
    std::lock_guard<std::mutex> lock(pool->mutex);
    pool->stop = true;
  }
  pool->wake.notify_all();
  for (auto& t : pool->threads) t.join();
  delete pool;
}

// Copy n bytes from src to dst (not overlapping) on the pool and the
// calling thread.  Returns 0, or -1 for a copy of more pieces than a ticket
// holds (512 GiB).
extern "C" int32_t tpuenc_copy(void* handle, void* dst, const void* src,
                               int64_t n) {
  Pool* pool = static_cast<Pool*>(handle);
  if (n < 0) return -1;
  const int64_t pieces = (n + kPiece - 1) / kPiece;
  if (pieces > static_cast<int64_t>(kField)) return -1;
  if (pieces == 0) return 0;
  // Every piece of the last copy has been taken and copied: no thread can
  // take another until the ticket below is published.
  pool->dst = static_cast<uint8_t*>(dst);
  pool->src = static_cast<const uint8_t*>(src);
  pool->n = n;
  pool->done.store(0, std::memory_order_relaxed);
  const uint64_t gen =
      ((pool->ticket.load(std::memory_order_relaxed) >> kGenShift) + 1) &
      ((uint64_t{1} << (64 - kGenShift)) - 1);
  {
    std::lock_guard<std::mutex> lock(pool->mutex);
    pool->ticket.store((gen << kGenShift) |
                           (static_cast<uint64_t>(pieces) << kPiecesShift),
                       std::memory_order_release);
  }
  pool->wake.notify_all();
  pool->work();
  while (pool->done.load(std::memory_order_acquire) < pieces) {
    std::this_thread::yield();
  }
  return 0;
}
