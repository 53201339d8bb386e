// Native data-feed engine: multi-threaded MultiSlot text parsing into a
// bounded blocking queue, drained in fixed-size batches.
//
// Reference: paddle/fluid/framework/data_feed.{h,cc} — MultiSlotDataFeed
// (:532) parses the MultiSlot text protocol ("<num> <v...>" per slot per
// line) on worker threads; LoDTensorBlockingQueue
// (operators/reader/lod_tensor_blocking_queue.h) hands batches to the
// trainer. This is the PyTorch port's copy of that C++ ingest path: the
// GIL-free parse + queue live here, Python only moves ready numpy batches
// to the device (where the DataLoader's side-stream copy overlaps the
// step).
//
// C ABI (ctypes-friendly, no pybind11 in this environment):
//   df_create(spec)      spec = "name:f|i:len,..." fixed-length slots
//   df_set_capacity(h, cap)
//   df_add_file(h, path)
//   df_start(h, nthreads)
//   df_next(h, batch, float** fbufs, long long** ibufs) -> rows filled
//   df_parse_errors(h)   (call after df_stop_join for a final count)
//   df_stop_join(h)      stop + join producers, handle stays valid
//   df_destroy(h)
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct SlotSpec {
  std::string name;
  bool is_float;
  int len;  // values per instance (fixed-length slots)
};

struct Instance {
  std::vector<float> fvals;     // concatenated float slots
  std::vector<int64_t> ivals;   // concatenated int slots
};

struct Feed {
  std::vector<SlotSpec> slots;
  std::vector<std::string> files;
  size_t capacity = 1024;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Instance> queue;
  std::vector<std::thread> workers;
  std::atomic<int> live_workers{0};
  std::atomic<size_t> parse_errors{0};
  std::atomic<bool> stop{false};
  bool started = false;
  // rows the consumer waits for (SIZE_MAX while it is not waiting): a
  // producer wakes it only once the queue holds that many, so the
  // consumer sleeps and wakes once a batch, not once a row
  size_t want = SIZE_MAX;

  int flen = 0, ilen = 0;  // per-instance totals

  ~Feed() {
    // wake producers parked on a full queue so join() can't deadlock when
    // the consumer abandons iteration early
    stop = true;
    {
      std::lock_guard<std::mutex> lk(mu);
      cv_push.notify_all();
      cv_pop.notify_all();
    }
    join();
  }

  void join() {
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  bool parse_line(const std::string& line, Instance* out) {
    const char* p = line.c_str();
    char* end = nullptr;
    out->fvals.reserve(flen);
    out->ivals.reserve(ilen);
    for (const auto& s : slots) {
      long n = strtol(p, &end, 10);
      if (end == p || n != s.len) return false;  // strict fixed-length
      p = end;
      for (long k = 0; k < n; ++k) {
        if (s.is_float) {
          float v = strtof(p, &end);
          if (end == p) return false;
          out->fvals.push_back(v);
        } else {
          long long v = strtoll(p, &end, 10);
          if (end == p) return false;
          out->ivals.push_back((int64_t)v);
        }
        p = end;
      }
    }
    return true;
  }

  void worker(size_t start_idx, size_t stride) {
    for (size_t fi = start_idx; fi < files.size() && !stop; fi += stride) {
      std::ifstream in(files[fi]);
      std::string line;
      while (!stop && std::getline(in, line)) {
        // blank/whitespace-only lines are skipped, not errors (matches the
        // Python fallback's `if not toks: continue`)
        if (line.find_first_not_of(" \t\r") == std::string::npos) continue;
        Instance inst;
        if (!parse_line(line, &inst)) {
          parse_errors++;
          continue;
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < capacity || stop; });
        if (stop) break;
        queue.push_back(std::move(inst));
        if (queue.size() >= want) cv_pop.notify_one();
      }
    }
    if (--live_workers == 0) {
      std::lock_guard<std::mutex> lk(mu);
      cv_pop.notify_all();
    }
  }

  void start(int nthreads) {
    flen = ilen = 0;
    for (const auto& s : slots) (s.is_float ? flen : ilen) += s.len;
    live_workers = nthreads;
    started = true;
    for (int i = 0; i < nthreads; ++i)
      workers.emplace_back([this, i, nthreads] { worker(i, nthreads); });
  }

  // Fill row-major [batch, len] buffers; returns rows actually written
  // (may be < batch at end of data; 0 = exhausted). Rows leave the queue
  // in bulk: the consumer waits for as many as it still needs (at most
  // the queue's capacity), takes them under one lock and copies them
  // out after releasing it.
  int next(int batch, float** fbufs, int64_t** ibufs) {
    int rows = 0;
    std::vector<Instance> got;
    while (rows < batch) {
      got.clear();
      {
        std::unique_lock<std::mutex> lk(mu);
        size_t need = std::min<size_t>(batch - rows, capacity);
        want = need;
        cv_pop.wait(lk, [&] {
          return queue.size() >= need || live_workers.load() == 0 || stop;
        });
        want = SIZE_MAX;
        if (stop) break;
        if (queue.empty()) break;  // drained and no producers left
        size_t n = std::min(need, queue.size());
        for (size_t k = 0; k < n; ++k) {
          got.push_back(std::move(queue.front()));
          queue.pop_front();
        }
        cv_push.notify_all();
      }
      for (const auto& inst : got) {
        size_t fo = 0, io = 0, fslot = 0, islot = 0;
        for (const auto& s : slots) {
          if (s.is_float) {
            std::memcpy(fbufs[fslot] + (size_t)rows * s.len,
                        inst.fvals.data() + fo, s.len * sizeof(float));
            fo += s.len;
            fslot++;
          } else {
            std::memcpy(ibufs[islot] + (size_t)rows * s.len,
                        inst.ivals.data() + io, s.len * sizeof(int64_t));
            io += s.len;
            islot++;
          }
        }
        rows++;
      }
    }
    return rows;
  }
};

}  // namespace

extern "C" {

void* df_create(const char* spec) {
  auto* f = new Feed();
  std::stringstream ss(spec);
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    size_t a = tok.find(':'), b = tok.rfind(':');
    if (a == std::string::npos || b == a) {
      delete f;
      return nullptr;
    }
    SlotSpec s;
    s.name = tok.substr(0, a);
    s.is_float = tok.substr(a + 1, b - a - 1) == "f";
    s.len = atoi(tok.c_str() + b + 1);
    if (s.len <= 0) {
      delete f;
      return nullptr;
    }
    f->slots.push_back(s);
  }
  return f->slots.empty() ? (delete f, nullptr) : f;
}

void df_set_capacity(void* h, int cap) {
  static_cast<Feed*>(h)->capacity = cap > 0 ? cap : 1024;
}

void df_add_file(void* h, const char* path) {
  static_cast<Feed*>(h)->files.emplace_back(path);
}

int df_start(void* h, int nthreads) {
  auto* f = static_cast<Feed*>(h);
  if (f->started || nthreads <= 0) return -1;
  f->start(nthreads);
  return 0;
}

int df_next(void* h, int batch, float** fbufs, int64_t** ibufs) {
  return static_cast<Feed*>(h)->next(batch, fbufs, ibufs);
}

long long df_parse_errors(void* h) {
  return (long long)static_cast<Feed*>(h)->parse_errors.load();
}

// Stop producers and join them WITHOUT freeing the handle, so counters can
// be read race-free before df_destroy.
void df_stop_join(void* h) {
  auto* f = static_cast<Feed*>(h);
  f->stop = true;
  {
    std::lock_guard<std::mutex> lk(f->mu);
    f->cv_push.notify_all();
    f->cv_pop.notify_all();
  }
  f->join();
}

void df_destroy(void* h) { delete static_cast<Feed*>(h); }

}  // extern "C"
