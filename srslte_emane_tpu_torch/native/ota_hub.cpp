// Native OTA hub: the timed message bus + SINR adjudicator as a standalone
// C++ daemon — the role of the external EMANE LTE MHAL (`libemanelte`
// ENB/UE::send_msg/get_messages + SINRTester, SURVEY.md §2.3/§5) for
// multi-process deployments.
//
// Design: payloads are OPAQUE bytes (exactly like EMANE's OTA messages);
// each frame carries a small binary tx-control header (source index,
// duplex domain, tx power, per-PRB occupancy mask) — everything the hub
// needs for the per-RB SINR computation.  One blocking recv per node per
// TTI forms the barrier (the reference's get_messages() pacing); FDD
// downlink/uplink groups adjudicate as independent interference domains.
//
// Wire protocol (little-endian, u32 length prefix, then u8 type):
//   1 HELLO   : u16 node_index  (== row in the pathloss matrix)
//   2 SUBMIT  : u16 n_frames, then per frame:
//               u16 src, u8 is_dl, f32 tx_power_dbm, u16 n_prb,
//               u8 mask[n_prb], u32 len, u8 payload[len]
//   3 BYE
//   4 DELIVER : u32 tti, f32 noise_floor_dbm, u16 n, then per delivery:
//               u16 src, u8 is_dl, f32 sinr_rb[n_prb], u32 len, payload
//
// Usage: ota_hub <port> <n_nodes> <n_prb> <noise_floor_dbm> <pathloss.txt>
// (pathloss.txt: n_nodes rows x n_nodes cols of dB values)

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <vector>

namespace {

struct Frame {
  uint16_t src;
  uint8_t is_dl;
  float tx_power_dbm;
  std::vector<uint8_t> mask;     // n_prb occupancy
  std::vector<uint8_t> payload;  // opaque
};

bool recv_all(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n) {
    ssize_t r = ::send(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

template <typename T>
void put(std::vector<uint8_t>& v, const T& x) {
  const auto* p = reinterpret_cast<const uint8_t*>(&x);
  v.insert(v.end(), p, p + sizeof(T));
}

// per-RB SINR for one duplex group: every other transmitter's energy on the
// same PRB is interference (mirror of runtime/sinr.py per_rb_sinr)
void group_sinr(const std::vector<Frame>& frames,
                const std::vector<float>& pathloss_db, int n_nodes, int n_prb,
                float noise_floor_dbm, std::vector<float>& out) {
  const int T = static_cast<int>(frames.size());
  const float noise_mw = std::pow(10.0f, noise_floor_dbm / 10.0f);
  std::vector<float> rx_mw(static_cast<size_t>(T) * n_nodes * n_prb);
  std::vector<float> total(static_cast<size_t>(n_nodes) * n_prb, 0.0f);
  for (int t = 0; t < T; ++t) {
    const float tx_mw = std::pow(10.0f, frames[t].tx_power_dbm / 10.0f);
    for (int r = 0; r < n_nodes; ++r) {
      const float g =
          tx_mw * std::pow(10.0f, -pathloss_db[frames[t].src * n_nodes + r] / 10.0f);
      for (int p = 0; p < n_prb; ++p) {
        const float v = frames[t].mask[p] ? g : 0.0f;
        rx_mw[(static_cast<size_t>(t) * n_nodes + r) * n_prb + p] = v;
        total[static_cast<size_t>(r) * n_prb + p] += v;
      }
    }
  }
  out.resize(rx_mw.size());
  for (int t = 0; t < T; ++t)
    for (int r = 0; r < n_nodes; ++r)
      for (int p = 0; p < n_prb; ++p) {
        const size_t i = (static_cast<size_t>(t) * n_nodes + r) * n_prb + p;
        const float rx = rx_mw[i];
        const float interf =
            total[static_cast<size_t>(r) * n_prb + p] - rx + noise_mw;
        const float s = rx / interf;
        out[i] = 10.0f * std::log10(s > 1e-12f ? s : 1e-12f);
      }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6) {
    std::fprintf(stderr,
                 "usage: ota_hub <port> <n_nodes> <n_prb> <noise_dbm> "
                 "<pathloss.txt>\n");
    return 2;
  }
  const int port = std::atoi(argv[1]);
  const int n_nodes = std::atoi(argv[2]);
  const int n_prb = std::atoi(argv[3]);
  const float noise_floor_dbm = std::strtof(argv[4], nullptr);
  std::vector<float> pathloss_db(static_cast<size_t>(n_nodes) * n_nodes);
  {
    std::ifstream f(argv[5]);
    for (auto& v : pathloss_db)
      if (!(f >> v)) {
        std::fprintf(stderr, "bad pathloss file\n");
        return 2;
      }
  }

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(srv, n_nodes) != 0) {
    std::perror("bind/listen");
    return 1;
  }
  {  // report the actual port (port 0 = ephemeral) for the launcher
    socklen_t alen = sizeof(addr);
    ::getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
    std::printf("PORT %d\n", ntohs(addr.sin_port));
    std::fflush(stdout);
  }

  std::vector<int> conn(n_nodes, -1);
  for (int i = 0; i < n_nodes; ++i) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) return 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    uint32_t len;
    uint8_t type;
    uint16_t idx;
    if (!recv_all(fd, &len, 4) || !recv_all(fd, &type, 1) || type != 1 ||
        !recv_all(fd, &idx, 2) || idx >= n_nodes)
      return 1;
    conn[idx] = fd;
  }

  constexpr uint32_t kMaxBody = 256u << 20;  // 256 MB sanity cap
  uint32_t tti = 0;
  std::vector<Frame> frames;
  std::vector<uint8_t> body_buf;
  bool running = true;
  while (running) {
    frames.clear();
    for (int nid = 0; nid < n_nodes && running; ++nid) {
      uint32_t len;
      if (!recv_all(conn[nid], &len, 4) || len < 1 || len > kMaxBody) {
        running = false;
        break;
      }
      // read the whole declared body, then parse it with bounds checks —
      // a truncated stream or malformed frame drops the run cleanly
      // instead of desynchronizing the parse or reading out of bounds
      body_buf.resize(len);
      if (!recv_all(conn[nid], body_buf.data(), len)) {
        running = false;
        break;
      }
      const uint8_t type = body_buf[0];
      if (type == 3) {  // BYE: any node leaving ends the emulation
        running = false;
        break;
      }
      size_t off = 1;
      auto take = [&](void* dst, size_t n) -> bool {
        if (off + n > body_buf.size()) return false;
        std::memcpy(dst, body_buf.data() + off, n);
        off += n;
        return true;
      };
      uint16_t n_frames = 0;
      bool ok = type == 2 && take(&n_frames, 2);
      for (int k = 0; ok && k < n_frames; ++k) {
        Frame fr;
        uint16_t np;
        uint32_t plen;
        ok = take(&fr.src, 2) && take(&fr.is_dl, 1) &&
             take(&fr.tx_power_dbm, 4) && take(&np, 2);
        // frames must match the hub's PRB grid: group_sinr indexes
        // mask[p] for p < n_prb, so a mismatched client is an error
        ok = ok && np == n_prb && fr.src < n_nodes;
        if (ok) {
          fr.mask.resize(np);
          ok = take(fr.mask.data(), np) && take(&plen, 4) &&
               plen <= body_buf.size() - off;
        }
        if (ok) {
          fr.payload.resize(plen);
          ok = take(fr.payload.data(), plen);
        }
        if (ok) frames.push_back(std::move(fr));
      }
      if (!ok) {
        std::fprintf(stderr, "ota_hub: malformed SUBMIT from node %d\n", nid);
        running = false;
      }
    }
    if (!running) break;

    // adjudicate DL and UL as independent interference domains (FDD)
    std::vector<float> sinr_dl, sinr_ul;
    std::vector<Frame> g_dl, g_ul;
    for (auto& fr : frames) (fr.is_dl ? g_dl : g_ul).push_back(fr);
    group_sinr(g_dl, pathloss_db, n_nodes, n_prb, noise_floor_dbm, sinr_dl);
    group_sinr(g_ul, pathloss_db, n_nodes, n_prb, noise_floor_dbm, sinr_ul);
    tti = (tti + 1) % 10240;

    for (int rx = 0; rx < n_nodes; ++rx) {
      std::vector<uint8_t> body;
      put<uint8_t>(body, 4);
      put<uint32_t>(body, tti);
      put<float>(body, noise_floor_dbm);
      uint16_t n = 0;
      for (const auto* grp : {&g_dl, &g_ul})
        for (const auto& fr : *grp)
          if (fr.src != rx) ++n;
      put<uint16_t>(body, n);
      for (int d = 0; d < 2; ++d) {
        const auto& grp = d == 0 ? g_dl : g_ul;
        const auto& sinr = d == 0 ? sinr_dl : sinr_ul;
        for (size_t t = 0; t < grp.size(); ++t) {
          const auto& fr = grp[t];
          if (fr.src == rx) continue;
          put<uint16_t>(body, fr.src);
          put<uint8_t>(body, fr.is_dl);
          const float* row = &sinr[(t * n_nodes + rx) * n_prb];
          const auto* rp = reinterpret_cast<const uint8_t*>(row);
          body.insert(body.end(), rp, rp + sizeof(float) * n_prb);
          put<uint32_t>(body, static_cast<uint32_t>(fr.payload.size()));
          body.insert(body.end(), fr.payload.begin(), fr.payload.end());
        }
      }
      uint32_t blen = static_cast<uint32_t>(body.size());
      if (!send_all(conn[rx], &blen, 4) ||
          !send_all(conn[rx], body.data(), body.size()))
        running = false;
    }
  }
  for (int fd : conn)
    if (fd >= 0) ::close(fd);
  ::close(srv);
  return 0;
}
