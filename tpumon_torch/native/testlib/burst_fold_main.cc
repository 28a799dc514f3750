// burst-fold — differential oracle for the burst accumulator fold.
//
// Drives the EXACT fold/harvest arithmetic the live BurstSampler uses
// (burst_fold_value / burst_reset_cell in agent/sampler.hpp — single
// source, no re-implementation) from a scripted sample stream, so
// tests/test_torch_native_agent.py can pin the C++ fold against the
// Python executable spec (tpumon_torch/burst.py BurstAccumulator)
// byte-for-byte under randomized fuzz.
//
// Protocol (stdin, one command per line):
//   S <chip> <fid> <t> <v>   fold one sample (v parses nan/inf/-inf)
//   H                        harvest: for every cell with samples print
//                              V <chip> <fid> <min> <max> <mean> <integral>
//                            one line per cell (fid order = insertion),
//                            each value as "i <int>" or "f <%.17g>"
//                            under the integral-dump emission rule,
//                            then "OK"; stats reset, anchors persist
//   Q                        quit
//
// %.17g round-trips doubles exactly, so equality on the printed form
// is equality on the bits.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

#include "sampler.hpp"

using tpumon::BurstCell;
using tpumon::burst_dumps_as_int;
using tpumon::burst_fold_value;
using tpumon::burst_reset_cell;

static void print_value(double v) {
  if (burst_dumps_as_int(v))
    printf("i %lld", static_cast<long long>(v));
  else
    printf("f %.17g", v);
}

int main() {
  std::map<std::pair<int, int>, BurstCell> cells;
  std::vector<std::pair<int, int>> order;  // insertion order, for output
  char line[256];
  while (fgets(line, sizeof(line), stdin)) {
    if (line[0] == 'S') {
      int chip = 0, fid = 0;
      char tbuf[64], vbuf[64];
      if (sscanf(line + 1, "%d %d %63s %63s", &chip, &fid, tbuf, vbuf)
          != 4)
        continue;
      double t = strtod(tbuf, nullptr);
      double v = strtod(vbuf, nullptr);  // strtod parses nan/inf/-inf
      auto key = std::make_pair(chip, fid);
      if (!cells.count(key)) order.push_back(key);
      burst_fold_value(&cells[key], t, v);
    } else if (line[0] == 'H') {
      for (const auto& key : order) {
        BurstCell& c = cells[key];
        long long count = c.count.load(std::memory_order_relaxed);
        if (!count) continue;
        printf("V %d %d ", key.first, key.second);
        print_value(c.vmin.load(std::memory_order_relaxed));
        printf(" ");
        print_value(c.vmax.load(std::memory_order_relaxed));
        printf(" ");
        print_value(c.vsum.load(std::memory_order_relaxed) /
                    static_cast<double>(count));
        printf(" ");
        print_value(c.integral.load(std::memory_order_relaxed));
        printf("\n");
        burst_reset_cell(&c);
      }
      printf("OK\n");
      fflush(stdout);
    } else if (line[0] == 'Q') {
      break;
    }
  }
  return 0;
}
