// tpu-operator — control-plane CLI.
//
// Subcommands:
//   reconcile   read cluster-state JSON on stdin, write
//               {"actions": [...], "status": {...}, "requeue": bool}
//               on stdout. One edge of the level-triggered loop; the
//               store driver (kube shim or the Python fake cluster in
//               tests) applies the actions and calls again. Equivalent
//               of one DGLJobReconciler.Reconcile pass
//               (controllers/dgljob_controller.go:105-318).
//   version     print the group/version string.
//
// Flags:
//   --watcher-image IMG   image for the watcher initContainers
//                         (parity: --watcher-loop-image, main.go:62).
#include <iostream>
#include <sstream>
#include <string>

#include "json.hpp"
#include "reconciler.hpp"

namespace {

int RunReconcile(const std::string& watcher_image) {
  std::stringstream buffer;
  buffer << std::cin.rdbuf();
  cp::Json state;
  try {
    state = cp::Json::parse(buffer.str());
  } catch (const std::exception& e) {
    std::cerr << "tpu-operator: bad state JSON: " << e.what() << "\n";
    return 2;
  }
  cp::ReconcileResult r = cp::Reconcile(state, watcher_image);
  cp::Json out = cp::Json::object();
  out["actions"] = r.actions;
  out["status"] = r.status;
  out["requeue"] = r.requeue;
  std::cout << out.dump(2) << "\n";
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string watcher_image = "tpu-watcher:latest";
  std::string cmd;
  for (int i = 1; i < argc; i++) {
    std::string arg = argv[i];
    if (arg == "--watcher-image" && i + 1 < argc) {
      watcher_image = argv[++i];
    } else if (cmd.empty()) {
      cmd = arg;
    }
  }
  if (cmd == "reconcile") return RunReconcile(watcher_image);
  if (cmd == "version") {
    std::cout << cp::kGroupVersion << "\n";
    return 0;
  }
  std::cerr << "usage: tpu-operator [--watcher-image IMG] "
               "{reconcile|version}\n"
               "  reconcile: cluster-state JSON on stdin -> actions JSON "
               "on stdout\n";
  return 2;
}
