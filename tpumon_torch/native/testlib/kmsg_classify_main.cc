// kmsg_classify_main.cc — stdin->stdout harness over the agent's kmsg
// classifier, so tests can pin the C++ classifier and the Python one
// (tpumon_torch/kmsg.py classify_line) to the same corpus
// (tests/test_torch_native_agent.py).
//
//   kmsg-classify [BUS=INDEX ...]    e.g. 0000:18:00=0 0000:28:00=1
//
// Each argument maps a GPU's PCI bus id to its index (the bus map the
// NVML source builds).  One input line per message; output "<etype>
// <chip>" per line (0 -1 for not-an-event).

#include <iostream>
#include <string>

#include "kmsg.hpp"

int main(int argc, char** argv) {
  tpumon::BusMap buses;
  for (int i = 1; i < argc; i++) {
    std::string arg = argv[i];
    size_t eq = arg.rfind('=');
    tpumon::BusKey key;
    if (eq == std::string::npos ||
        !tpumon::kmsg_bus_key(arg.substr(0, eq), &key)) {
      std::cerr << "kmsg-classify: not BUS=INDEX: " << arg << "\n";
      return 2;
    }
    buses[key] = std::stoi(arg.substr(eq + 1));
  }
  std::string line;
  while (std::getline(std::cin, line)) {
    int chip = -1;
    int etype = tpumon::kmsg_classify(line, buses, &chip);
    std::cout << etype << " " << chip << "\n";
  }
  return 0;
}
