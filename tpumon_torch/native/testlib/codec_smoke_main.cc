// codec_smoke_main.cc — two-thread smoke of the shared codec core
// (codec/core.hpp) for the sanitizer gate.
//
// The Python extension releases the GIL around encode/decode, so two
// shard threads genuinely run the core concurrently (each on its OWN
// handles — the single-owner contract the binding enforces with its
// busy flag).  This harness reproduces that shape without Python:
// per-thread EncoderCore/DecoderCore pairs churning full frames, plus
// a mutex-shared BurstCore mirroring the binding's fold/harvest
// locking.  Built plain and, with -fsanitize=thread, on request
// (tests/test_torch_codec_native.py, TPUMON_RUN_SANITIZERS=1); any hidden
// shared state (globals, caches) is a report, and a report is a
// failing exit.

#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "core.hpp"

namespace nc = tpumon::codec;

namespace {

nc::BurstCore g_burst;
std::mutex g_burst_mu;  // the binding-level lock the facade holds

void worker(int seed, int* failures) {
  nc::EncoderCore enc(0);
  nc::DecoderCore dec(false);
  unsigned int rng = static_cast<unsigned int>(seed);
  auto next = [&rng]() {
    rng = rng * 1103515245u + 12345u;
    return (rng >> 16) & 0x7FFF;
  };
  std::vector<nc::PendChip> pending;
  std::vector<nc::PendEntry> arena;
  std::vector<void*> released;
  std::string frame;
  for (int step = 0; step < 200; step++) {
    pending.clear();
    arena.clear();
    for (long long chip = 0; chip < 16; chip++) {
      nc::PendChip pc;
      pc.idx = chip;
      pc.begin = arena.size();
      for (long long fid = 100; fid < 120; fid++) {
        arena.emplace_back();
        nc::PendEntry& e = arena.back();
        e.fid = fid;
        int kind = next() % 5;
        if (kind == 0) {
          e.v.kind = nc::NValue::kBlank;
        } else if (kind == 1) {
          e.v.kind = nc::NValue::kInt;
          e.v.i = next();
        } else if (kind == 2) {
          e.v.kind = nc::NValue::kFloat;
          e.v.d = static_cast<double>(next()) / 7.0;
        } else if (kind == 3) {
          e.v.kind = nc::NValue::kStr;
          e.v.s = "v" + std::to_string(next() % 50);
        } else {
          e.v.kind = nc::NValue::kVec;
          for (int k = 0; k < 3; k++) {
            nc::NValue::Elem el;
            el.kind = nc::NValue::kInt;
            el.i = next() % 9;
            e.v.vec.push_back(el);
          }
        }
      }
      pc.end = arena.size();
      pending.push_back(pc);
    }
    enc.encode(&pending, &arena, false, std::string(), &frame,
               &released);
    if (!released.empty()) {
      // no binding above us: cookies are never set, so nothing may be
      // queued for release
      *failures += 1;
      return;
    }
    // strip magic + varint length, apply the payload
    size_t pos = 1;
    unsigned long long len = 0;
    int shift = 0;
    while (true) {
      unsigned char b =
          static_cast<unsigned char>(frame[pos]);
      pos++;
      len |= static_cast<unsigned long long>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    nc::ApplyResult res = dec.apply(
        reinterpret_cast<const uint8_t*>(frame.data()) + pos,
        static_cast<size_t>(len), &released);
    if (!res.error.empty() || !released.empty()) {
      *failures += 1;
      return;
    }
    // the shared burst core, under the binding's lock
    {
      std::lock_guard<std::mutex> g(g_burst_mu);
      g_burst.fold(seed, 155, static_cast<double>(step) / 100.0,
                   static_cast<double>(next()));
      if (step % 50 == 49) {
        std::vector<nc::BurstHarvestEntry> h;
        g_burst.harvest(&h);
      }
    }
  }
  if (dec.mirror_entries() != 16 * 20) *failures += 1;
}

}  // namespace

int main() {
  int f1 = 0, f2 = 0;
  std::thread t1(worker, 1, &f1);
  std::thread t2(worker, 2, &f2);
  t1.join();
  t2.join();
  if (f1 || f2) {
    fprintf(stderr, "codec smoke FAILED (%d/%d)\n", f1, f2);
    return 1;
  }
  printf("codec smoke OK\n");
  return 0;
}
