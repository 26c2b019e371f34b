// The .sosq sequence streamer: a background-prefetching, zlib-decompressing
// frame reader for live and replayed VO (the port's own copy of
// native/seqloader.cpp, with the same C API and the same .sosq v1 format).
//
// Frames live in one ".sosq" bundle (header + offset table + per-frame zlib
// streams, or raw f32); worker threads decode ahead of the consumer into a
// window of `readahead` frames, so the caller's per-frame cost is one memcpy
// into its buffer and the decode never blocks the VO loop. Host code only:
// no device code here.
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   void* sosq_open(const char* path, int readahead);   // nullptr on failure
//   int   sosq_frames(void* h); int sosq_height(void* h); int sosq_width(void* h);
//   int   sosq_next(void* h, float* dst);      // sequential; 0 on success
//   int   sosq_get(void* h, int idx, float* dst);  // random access; 0 on success
//   void  sosq_close(void* h);
//
// Built by sosvo_torch/data/native_loader.py:
//   g++ -O2 -shared -fPIC -o libseqloader.so seqloader.cpp -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x51534F53;  // "SOSQ" little-endian

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t frames;
  uint32_t height;
  uint32_t width;
  uint32_t compressed;  // 0 raw f32, 1 zlib
};

struct Loader {
  FILE* f = nullptr;
  Header hdr{};
  std::vector<uint64_t> offsets;  // frames+1 entries
  size_t frame_floats = 0;

  // Prefetch machinery.
  int readahead = 4;
  std::map<int, std::vector<float>> ready;  // decoded frames by index
  int next_needed = 0;     // next frame the consumer will ask for
  int next_scheduled = 0;  // next frame a worker should fetch
  bool shutdown = false;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_work;
  std::vector<std::thread> workers;
  std::mutex file_mu;

  bool read_frame_raw(int idx, std::vector<uint8_t>& buf) {
    const uint64_t off = offsets[idx];
    const uint64_t len = offsets[idx + 1] - off;
    buf.resize(len);
    std::lock_guard<std::mutex> lk(file_mu);
    if (fseeko(f, static_cast<off_t>(off), SEEK_SET) != 0) return false;
    return fread(buf.data(), 1, len, f) == len;
  }

  bool decode(int idx, std::vector<float>& out) {
    std::vector<uint8_t> raw;
    if (!read_frame_raw(idx, raw)) return false;
    out.resize(frame_floats);
    if (!hdr.compressed) {
      if (raw.size() != frame_floats * sizeof(float)) return false;
      std::memcpy(out.data(), raw.data(), raw.size());
      return true;
    }
    uLongf dst_len = frame_floats * sizeof(float);
    const int rc = uncompress(reinterpret_cast<Bytef*>(out.data()), &dst_len,
                              raw.data(), raw.size());
    return rc == Z_OK && dst_len == frame_floats * sizeof(float);
  }

  void worker() {
    for (;;) {
      int idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return shutdown ||
                 (next_scheduled < static_cast<int>(hdr.frames) &&
                  next_scheduled < next_needed + readahead);
        });
        if (shutdown) return;
        idx = next_scheduled++;
      }
      std::vector<float> out;
      const bool ok = decode(idx, out);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[idx] = ok ? std::move(out) : std::vector<float>();
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* sosq_open(const char* path, int readahead) {
  auto* L = new Loader();
  L->f = fopen(path, "rb");
  if (!L->f) { delete L; return nullptr; }
  if (fread(&L->hdr, sizeof(Header), 1, L->f) != 1 ||
      L->hdr.magic != kMagic || L->hdr.version != 1) {
    fclose(L->f); delete L; return nullptr;
  }
  L->offsets.resize(L->hdr.frames + 1);
  if (fread(L->offsets.data(), sizeof(uint64_t), L->hdr.frames + 1, L->f) !=
      L->hdr.frames + 1) {
    fclose(L->f); delete L; return nullptr;
  }
  L->frame_floats = static_cast<size_t>(L->hdr.height) * L->hdr.width;
  L->readahead = readahead > 0 ? readahead : 4;
  const int n_workers = L->hdr.compressed ? 2 : 1;
  for (int i = 0; i < n_workers; ++i) {
    L->workers.emplace_back([L] { L->worker(); });
  }
  L->cv_work.notify_all();
  return L;
}

int sosq_frames(void* h) { return static_cast<Loader*>(h)->hdr.frames; }
int sosq_height(void* h) { return static_cast<Loader*>(h)->hdr.height; }
int sosq_width(void* h) { return static_cast<Loader*>(h)->hdr.width; }

int sosq_get(void* h, int idx, float* dst) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || idx >= static_cast<int>(L->hdr.frames)) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  // Random access resets the prefetch window.
  if (idx < L->next_needed || idx >= L->next_scheduled + L->readahead) {
    L->ready.clear();
    L->next_needed = idx;
    L->next_scheduled = idx;
  } else {
    L->next_needed = idx;
  }
  L->cv_work.notify_all();
  L->cv_ready.wait(lk, [&] { return L->ready.count(idx) > 0; });
  auto it = L->ready.find(idx);
  if (it->second.empty()) return -2;  // decode error
  std::memcpy(dst, it->second.data(), L->frame_floats * sizeof(float));
  // Drop everything at or before idx; advance the window.
  L->ready.erase(L->ready.begin(), std::next(it));
  L->next_needed = idx + 1;
  L->cv_work.notify_all();
  return 0;
}

int sosq_next(void* h, float* dst) {
  auto* L = static_cast<Loader*>(h);
  int idx;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    idx = L->next_needed;
  }
  return sosq_get(h, idx, dst);
}

void sosq_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->shutdown = true;
  }
  L->cv_work.notify_all();
  for (auto& t : L->workers) t.join();
  fclose(L->f);
  delete L;
}

}  // extern "C"
