// The port's copy of native/filelog.cc, unchanged but for the names in
// this comment; built by gome_tpu_torch/native/build.py and bound by
// gome_tpu_torch/bus/native.py.
//
// Native durable file-log queue — the C++ runtime backend for
// bus.filelog.FileQueue (same on-disk format: 4-byte big-endian length
// prefix per record in <name>.log + ASCII committed offset in
// <name>.offset, so the Python and native backends are interchangeable on
// the same files).
//
// Why native: the bus publish path is the per-order host hot loop (the role
// the reference delegates to compiled Go + RabbitMQ, rabbitmq.go:60-84).
// Python-side, each publish costs interpreter overhead comparable to the
// I/O itself; here publish_batch amortizes one syscall+fsync across a
// micro-batch. Exposed via a minimal C ABI consumed with ctypes
// (bus/native.py) — no pybind11 in this image.
//
// Concurrency contract: one process owns a queue directory (same as the
// Python backend); within a process, calls are serialized by a mutex.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Queue {
  std::mutex mu;
  std::string log_path;
  std::string off_path;
  int fd = -1;          // append handle for the log
  bool do_fsync = true;
  std::vector<uint64_t> positions;  // record start offsets (byte pos)
  uint64_t tail = 0;                // byte length of valid log prefix
  uint64_t committed = 0;           // consumer offset (record index)
};

uint32_t load_be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void store_be32(unsigned char* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

// Scan an existing log, building the position index and truncating a torn
// tail record (crash mid-append), mirroring FileQueue._scan_existing.
bool scan_log(Queue* q) {
  FILE* f = fopen(q->log_path.c_str(), "rb");
  if (f == nullptr) return true;  // no log yet
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> data(size > 0 ? size : 0);
  if (size > 0 && fread(data.data(), 1, size, f) != size_t(size)) {
    fclose(f);
    return false;
  }
  fclose(f);
  uint64_t pos = 0;
  uint64_t valid_end = 0;
  while (pos + 4 <= uint64_t(size)) {
    uint32_t n = load_be32(data.data() + pos);
    if (pos + 4 + n > uint64_t(size)) break;  // torn tail
    q->positions.push_back(pos);
    pos += 4 + n;
    valid_end = pos;
  }
  q->tail = valid_end;
  if (valid_end < uint64_t(size)) {
    if (truncate(q->log_path.c_str(), off_t(valid_end)) != 0) return false;
  }
  return true;
}

uint64_t read_committed(const Queue* q) {
  FILE* f = fopen(q->off_path.c_str(), "rb");
  if (f == nullptr) return 0;
  char buf[32] = {0};
  size_t n = fread(buf, 1, sizeof(buf) - 1, f);
  fclose(f);
  (void)n;
  return strtoull(buf, nullptr, 10);
}

bool write_committed(Queue* q, uint64_t offset) {
  std::string tmp = q->off_path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  char buf[32];
  int len = snprintf(buf, sizeof(buf), "%llu", (unsigned long long)offset);
  bool ok = write(fd, buf, len) == len && fsync(fd) == 0;
  close(fd);
  if (!ok) return false;
  return rename(tmp.c_str(), q->off_path.c_str()) == 0;
}

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure.
void* gq_open(const char* path_base, int do_fsync) {
  auto* q = new Queue();
  q->log_path = std::string(path_base) + ".log";
  q->off_path = std::string(path_base) + ".offset";
  q->do_fsync = do_fsync != 0;
  if (!scan_log(q)) {
    delete q;
    return nullptr;
  }
  q->fd = open(q->log_path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (q->fd < 0) {
    delete q;
    return nullptr;
  }
  q->committed = read_committed(q);
  return q;
}

void gq_close(void* h) {
  auto* q = static_cast<Queue*>(h);
  if (q == nullptr) return;
  if (q->fd >= 0) close(q->fd);
  delete q;
}

// Append n records in ONE writev-style buffer + one fsync.
// bodies: concatenated payload bytes; lengths[i]: payload sizes.
// Returns the offset of the FIRST appended record, or -1 on failure.
int64_t gq_publish_batch(void* h, const unsigned char* bodies,
                         const uint32_t* lengths, uint32_t n) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  size_t total = 0;
  for (uint32_t i = 0; i < n; i++) total += 4 + size_t(lengths[i]);
  std::vector<unsigned char> buf(total);
  size_t w = 0;
  const unsigned char* src = bodies;
  std::vector<uint64_t> new_positions;
  new_positions.reserve(n);
  uint64_t pos = q->tail;
  for (uint32_t i = 0; i < n; i++) {
    store_be32(buf.data() + w, lengths[i]);
    memcpy(buf.data() + w + 4, src, lengths[i]);
    new_positions.push_back(pos);
    pos += 4 + lengths[i];
    w += 4 + lengths[i];
    src += lengths[i];
  }
  ssize_t written = write(q->fd, buf.data(), buf.size());
  if (written != ssize_t(buf.size()) || (q->do_fsync && fsync(q->fd) != 0)) {
    // Partial append (disk full/quota) or unconfirmed durability: roll the
    // file back to the last consistent tail so positions never point into
    // garbage and a reopen's scan cannot misparse orphan bytes.
    if (ftruncate(q->fd, off_t(q->tail)) != 0) {
      // Can't even restore consistency: poison the handle (fail-stop).
      close(q->fd);
      q->fd = -1;
    }
    return -1;
  }
  int64_t first = int64_t(q->positions.size());
  q->positions.insert(q->positions.end(), new_positions.begin(),
                      new_positions.end());
  q->tail = pos;
  return first;
}

int64_t gq_end_offset(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return int64_t(q->positions.size());
}

int64_t gq_committed(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return int64_t(q->committed);
}

// Read up to max_n records starting at `offset` into caller buffers.
// out_bodies receives concatenated payloads (capacity out_cap bytes),
// out_lengths[i] their sizes. Returns the number of records read;
// -1 = buffer too small (caller grows and retries); -2 = I/O error.
int64_t gq_read_from(void* h, uint64_t offset, uint32_t max_n,
                     unsigned char* out_bodies, uint64_t out_cap,
                     uint32_t* out_lengths) {
  auto* q = static_cast<Queue*>(h);
  uint64_t start_pos, end_pos, n;
  {
    // Snapshot the byte range under the lock, then do the file I/O outside
    // it so long reads (recovery replay) never stall the publish hot path.
    // Records are immutable once indexed (truncate_to only removes whole
    // records above the committed offset), so the snapshot stays valid.
    std::lock_guard<std::mutex> lock(q->mu);
    uint64_t end = q->positions.size();
    if (offset >= end) return 0;
    n = end - offset;
    if (n > max_n) n = max_n;
    start_pos = q->positions[offset];
    end_pos =
        (offset + n < q->positions.size()) ? q->positions[offset + n] : q->tail;
  }
  FILE* f = fopen(q->log_path.c_str(), "rb");
  if (f == nullptr) return -2;
  uint64_t span = end_pos - start_pos;
  std::vector<unsigned char> raw(span);
  bool ok = fseek(f, long(start_pos), SEEK_SET) == 0 &&
            fread(raw.data(), 1, span, f) == span;
  fclose(f);
  if (!ok) return -2;
  uint64_t w = 0, r = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint32_t len = load_be32(raw.data() + r);
    if (w + len > out_cap) return -1;  // caller buffer too small
    memcpy(out_bodies + w, raw.data() + r + 4, len);
    out_lengths[i] = len;
    w += len;
    r += 4 + len;
  }
  return int64_t(n);
}

// Commit / rollback / truncate mirror the Python backend's contracts.
int gq_commit(void* h, uint64_t offset) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  if (offset < q->committed || offset > q->positions.size()) return -1;
  if (!write_committed(q, offset)) return -2;
  q->committed = offset;
  return 0;
}

int gq_rollback(void* h, uint64_t offset) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  if (offset > q->committed) return -1;
  if (!write_committed(q, offset)) return -2;
  q->committed = offset;
  return 0;
}

int gq_truncate_to(void* h, uint64_t offset) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  if (offset < q->committed) return -1;
  if (offset >= q->positions.size()) return 0;
  uint64_t pos = q->positions[offset];
  // reopen append fd after truncation so the file position is correct
  close(q->fd);
  if (truncate(q->log_path.c_str(), off_t(pos)) != 0) return -2;
  q->fd = open(q->log_path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (q->fd < 0) return -2;
  q->positions.resize(offset);
  q->tail = pos;
  return 0;
}

}  // extern "C"
