// Native prefetching file-stream for heat_tpu_torch's data pipeline (the
// port's own copy of heat_tpu/native/src/stream.cpp).
//
// Counterpart of Heat's background-thread slab loader (its partial HDF5
// dataset's `queue_thread`, which overlaps reads with training in Python
// threads). Here the producer is a real OS thread doing pread(2) into a
// ring of `depth` slab buffers while the consumer (Python, via ctypes)
// drains them: IO overlaps compute without holding the GIL.
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Slab {
  std::vector<char> buf;
  int64_t len = 0;
};

struct Stream {
  int fd = -1;
  int64_t chunk = 0;
  int64_t remaining = 0;
  int64_t offset = 0;
  std::vector<Slab> ring;
  size_t head = 0, tail = 0, filled = 0;
  bool eof = false, stop = false;
  int64_t err = 0;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::thread worker;

  void produce() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_prod.wait(lk, [&] { return stop || filled < ring.size(); });
      if (stop) return;
      if (remaining <= 0) {
        eof = true;
        cv_cons.notify_all();
        return;
      }
      Slab &s = ring[head];
      int64_t want = std::min(chunk, remaining);
      lk.unlock();
      int64_t got = 0;
      while (got < want) {
        ssize_t n = ::pread(fd, s.buf.data() + got, want - got, offset + got);
        if (n < 0) {
          std::lock_guard<std::mutex> lg(mu);
          err = -1;
          eof = true;
          cv_cons.notify_all();
          return;
        }
        if (n == 0) break;  // short file
        got += n;
      }
      lk.lock();
      s.len = got;
      offset += got;
      remaining = (got < want) ? 0 : remaining - got;
      head = (head + 1) % ring.size();
      ++filled;
      if (got == 0) eof = true;
      cv_cons.notify_all();
      if (eof) return;
    }
  }
};

}  // namespace

extern "C" {

// Opens a background-prefetched stream over [offset, offset+length) of path.
// chunk_bytes: slab size; depth: number of slabs read ahead.
// Returns an opaque handle or nullptr on failure.
void *ht_stream_open(const char *path, int64_t offset, int64_t length,
                     int64_t chunk_bytes, int32_t depth) {
  if (!path || offset < 0 || length < 0 || chunk_bytes <= 0 || depth <= 0)
    return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  Stream *s = new Stream();
  s->fd = fd;
  s->chunk = chunk_bytes;
  s->remaining = length;
  s->offset = offset;
  s->ring.resize(depth);
  for (auto &sl : s->ring) sl.buf.resize(chunk_bytes);
  s->worker = std::thread([s] { s->produce(); });
  return s;
}

// Copies the next slab into out (cap bytes available). Returns the number of
// bytes copied, 0 at end-of-stream, or a negative error code.
int64_t ht_stream_next(void *h, void *out, int64_t cap) {
  if (!h || !out) return -4;
  Stream *s = static_cast<Stream *>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_cons.wait(lk, [&] { return s->filled > 0 || s->eof; });
  // drain successfully-read slabs before surfacing a late pread error
  if (s->filled == 0) return s->err != 0 ? s->err : 0;
  Slab &sl = s->ring[s->tail];
  if (sl.len > cap) return -3;
  int64_t n = sl.len;
  memcpy(out, sl.buf.data(), n);
  s->tail = (s->tail + 1) % s->ring.size();
  --s->filled;
  s->cv_prod.notify_one();
  return n;
}

void ht_stream_close(void *h) {
  if (!h) return;
  Stream *s = static_cast<Stream *>(h);
  {
    std::lock_guard<std::mutex> lg(s->mu);
    s->stop = true;
  }
  s->cv_prod.notify_all();
  if (s->worker.joinable()) s->worker.join();
  ::close(s->fd);
  delete s;
}

}  // extern "C"
