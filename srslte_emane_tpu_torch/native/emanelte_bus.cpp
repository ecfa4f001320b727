// Native OTA-bus core: per-RB SINR adjudication + frame queues.
//
// This is the C++ runtime component playing the role the external
// libemanelte MHAL plays for the reference (timed message bus + SINRTester;
// SURVEY.md §2.3): the per-TTI hot path of large emulations (hundreds of
// nodes) runs here, while Python keeps the control plane and JAX keeps the
// device compute.  Exposed as a plain C ABI consumed via ctypes
// (runtime/native_bus.py), with a NumPy fallback when the .so is absent.
//
// Build: scripts/build_native.sh  (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- SINR core
//
// rx_mw[t][r][p] = tx_mw[t] * gain[t][r] * used[t][p]
// sinr_db[t][r][p] = 10log10( rx / (sum_t' rx[t'] - rx + noise) )
//
// All inputs linear mW / linear gain; one call adjudicates a whole TTI
// (or a batch of TTIs back-to-back by calling repeatedly).
void sinr_per_rb(const float* tx_mw, const float* gain, const float* used,
                 float noise_mw, int T, int R, int P, float* out_sinr_db) {
  std::vector<float> total(R * P, 0.0f);
  // accumulate total received power per (r, p)
  for (int t = 0; t < T; ++t) {
    for (int r = 0; r < R; ++r) {
      const float g = tx_mw[t] * gain[t * R + r];
      float* tot = &total[r * P];
      const float* u = &used[t * P];
      for (int p = 0; p < P; ++p) tot[p] += g * u[p];
    }
  }
  for (int t = 0; t < T; ++t) {
    for (int r = 0; r < R; ++r) {
      const float g = tx_mw[t] * gain[t * R + r];
      const float* u = &used[t * P];
      const float* tot = &total[r * P];
      float* o = &out_sinr_db[(t * R + r) * P];
      for (int p = 0; p < P; ++p) {
        const float rx = g * u[p];
        const float interf = tot[p] - rx + noise_mw;
        const float s = rx / interf;
        o[p] = 10.0f * log10f(s > 1e-12f ? s : 1e-12f);
      }
    }
  }
}

// Cell-aware variant: same-cell emissions are code/resource-multiplexed
// (PRACH preambles, PUCCH cyclic shifts, scheduler-disjoint PUSCH) and do
// NOT interfere with each other; only other-cell energy plus noise does.
// cells: dense cell index per transmitter in [0, C).
void sinr_per_rb_cells(const float* tx_mw, const float* gain,
                       const float* used, const int* cells, int C,
                       float noise_mw, int T, int R, int P,
                       float* out_sinr_db) {
  std::vector<float> total(R * P, 0.0f);
  std::vector<float> by_cell((size_t)C * R * P, 0.0f);
  for (int t = 0; t < T; ++t) {
    float* celltot = &by_cell[(size_t)cells[t] * R * P];
    for (int r = 0; r < R; ++r) {
      const float g = tx_mw[t] * gain[t * R + r];
      float* tot = &total[r * P];
      float* ct = &celltot[r * P];
      const float* u = &used[t * P];
      for (int p = 0; p < P; ++p) {
        const float e = g * u[p];
        tot[p] += e;
        ct[p] += e;
      }
    }
  }
  for (int t = 0; t < T; ++t) {
    const float* celltot = &by_cell[(size_t)cells[t] * R * P];
    for (int r = 0; r < R; ++r) {
      const float g = tx_mw[t] * gain[t * R + r];
      const float* u = &used[t * P];
      const float* tot = &total[r * P];
      const float* ct = &celltot[r * P];
      float* o = &out_sinr_db[(t * R + r) * P];
      for (int p = 0; p < P; ++p) {
        const float rx = g * u[p];
        const float interf = tot[p] - ct[p] + noise_mw;
        const float s = rx / interf;
        o[p] = 10.0f * log10f(s > 1e-12f ? s : 1e-12f);
      }
    }
  }
}

// ---------------------------------------------------------------- frame bus
//
// Multi-producer queues of opaque serialized frames per receiver node.
// Mirrors EMANELTE::MHAL send_msg/get_messages.

struct Frame {
  int src;
  std::vector<uint8_t> data;
};

struct Bus {
  std::mutex mu;
  std::unordered_map<int, std::deque<Frame>> pending;  // rx node -> frames
  uint64_t tti = 0;
};

void* bus_create() { return new Bus(); }
void bus_destroy(void* h) { delete static_cast<Bus*>(h); }

void bus_send(void* h, int src, const int* rx_nodes, int n_rx,
              const uint8_t* data, int len) {
  Bus* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  for (int i = 0; i < n_rx; ++i) {
    Frame f;
    f.src = src;
    f.data.assign(data, data + len);
    b->pending[rx_nodes[i]].push_back(std::move(f));
  }
}

// Drains up to max_frames for node; returns count.  Frame i's src goes to
// srcs[i]; its bytes are copied into buf at offsets[i] (caller sizes buf).
int bus_recv(void* h, int node, uint8_t* buf, int buf_len, int* srcs,
             int* offsets, int* lens, int max_frames) {
  Bus* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  auto& q = b->pending[node];
  int n = 0, off = 0;
  while (!q.empty() && n < max_frames) {
    Frame& f = q.front();
    if (off + static_cast<int>(f.data.size()) > buf_len) break;
    std::memcpy(buf + off, f.data.data(), f.data.size());
    srcs[n] = f.src;
    offsets[n] = off;
    lens[n] = static_cast<int>(f.data.size());
    off += static_cast<int>(f.data.size());
    ++n;
    q.pop_front();
  }
  return n;
}

uint64_t bus_step_tti(void* h) {
  Bus* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  return ++b->tti;
}

}  // extern "C"
