// tpu-watcher — the barrier binary (watcher-loop equivalent).
//
// Runs as an initContainer; blocks until every pod named in WATCHERFILE
// reaches the wanted state, then exits 0 so the next container starts.
// Contract parity with watcher-loop (watcher-loop/app/server.go:40-43,
// options/options.go:55-61):
//
//   WATCHERFILE   hostfile-format file: `ip port podname ...` per line;
//                 lines whose podname ends in "launcher" are skipped
//                 (server.go:108-120)
//   WATCHERMODE   ready    -> all pods Running or Succeeded
//                 finished -> all pods Succeeded
//   NAMESPACE     accepted for parity (unused by the file backend)
//
// Pod status backend: instead of a k8s informer, status is read through
// a pluggable source —
//   --status-dir DIR   file per pod: DIR/<podname> holds the pod phase
//                      string (Pending/Running/Succeeded/Failed). In
//                      deployment a 10-line sidecar (or the kube shim)
//                      materializes this view from the API server; in
//                      tests the fake cluster writes it directly.
//   --status-cmd CMD   a shell command printing the phase for "$POD"
//                      (one subprocess per watched pod per tick — debug
//                      backend; O(pods) API load).
//   --status-batch-cmd CMD
//                      a shell command printing `podname phase` lines
//                      for every pod in scope — ONE subprocess (one
//                      apiserver LIST) per tick regardless of pod
//                      count. This is the production backend (the
//                      reference amortizes the same way with a shared
//                      informer cache, watcher-loop/app/server.go:84-100);
//                      the image wires it to a single label-scoped
//                      `kubectl get pods`.
// Poll cadence 500 ms, matching the reference's ticker
// (watcher-loop/controllers/controller.go:140-152). A pod whose status
// turns Failed makes the watcher exit 1 (the barrier can never open).
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iostream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

std::vector<std::string> ReadWatchedPods(const std::string& path) {
  std::vector<std::string> pods;
  std::ifstream in(path);
  std::string line;
  while (std::getline(in, line)) {
    std::istringstream ls(line);
    std::string ip, port, podname;
    ls >> ip >> port >> podname;
    if (podname.empty() || ip.empty() || ip[0] == '#') continue;
    // The launcher watches others; it is never a barrier target.
    if (podname.size() >= 8 &&
        podname.compare(podname.size() - 8, 8, "launcher") == 0) {
      continue;
    }
    pods.push_back(podname);
  }
  return pods;
}

std::string PodPhaseFromDir(const std::string& dir,
                            const std::string& pod) {
  std::ifstream in(dir + "/" + pod);
  std::string phase;
  if (in) in >> phase;
  return phase;
}

std::string PodPhaseFromCmd(const std::string& cmd,
                            const std::string& pod) {
  std::string full = "POD=" + pod + " " + cmd;
  FILE* p = popen(full.c_str(), "r");
  if (p == nullptr) return "";
  char buf[128] = {0};
  std::string out;
  while (fgets(buf, sizeof(buf), p) != nullptr) out += buf;
  pclose(p);
  while (!out.empty() && (out.back() == '\n' || out.back() == ' ')) {
    out.pop_back();
  }
  return out;
}

std::map<std::string, std::string> PodPhasesFromBatchCmd(
    const std::string& cmd) {
  std::map<std::string, std::string> phases;
  FILE* p = popen(cmd.c_str(), "r");
  if (p == nullptr) return phases;
  char buf[256];
  std::string out;
  while (fgets(buf, sizeof(buf), p) != nullptr) out += buf;
  pclose(p);
  std::istringstream lines(out);
  std::string line;
  while (std::getline(lines, line)) {
    std::istringstream ls(line);
    std::string pod, phase;
    ls >> pod >> phase;
    if (!pod.empty() && !phase.empty()) phases[pod] = phase;
  }
  return phases;
}

}  // namespace

int main(int argc, char** argv) {
  const char* wf = std::getenv("WATCHERFILE");
  const char* wm = std::getenv("WATCHERMODE");
  std::string watch_file = wf != nullptr ? wf : "";
  std::string mode = wm != nullptr ? wm : "ready";
  std::string status_dir, status_cmd, status_batch_cmd;
  int timeout_ms = -1;
  int poll_ms = 500;

  for (int i = 1; i < argc; i++) {
    std::string arg = argv[i];
    auto next = [&]() -> std::string {
      return i + 1 < argc ? argv[++i] : "";
    };
    if (arg == "--watch-file") watch_file = next();
    else if (arg == "--mode") mode = next();
    else if (arg == "--status-dir") status_dir = next();
    else if (arg == "--status-cmd") status_cmd = next();
    else if (arg == "--status-batch-cmd") status_batch_cmd = next();
    else if (arg == "--timeout-ms") timeout_ms = std::stoi(next());
    else if (arg == "--poll-ms") poll_ms = std::stoi(next());
  }
  if (const char* d = std::getenv("TPU_WATCHER_STATUS_DIR");
      status_dir.empty() && d != nullptr) {
    status_dir = d;
  }
  if (watch_file.empty() ||
      (status_dir.empty() && status_cmd.empty() &&
       status_batch_cmd.empty())) {
    std::cerr << "tpu-watcher: need WATCHERFILE (or --watch-file) and "
                 "--status-dir/--status-cmd/--status-batch-cmd\n";
    return 2;
  }
  if (mode != "ready" && mode != "finished") {
    std::cerr << "tpu-watcher: WATCHERMODE must be ready|finished\n";
    return 2;
  }

  // Pods leave the watch set once they hit the wanted state, like the
  // reference's delete-from-watch-set workers (controller.go:219-254).
  // The watch file is re-read every poll: the operator appends worker
  // lines as pods get IPs, so the set can grow while waiting.
  std::set<std::string> satisfied;
  int waited_ms = 0;
  while (true) {
    std::vector<std::string> pods = ReadWatchedPods(watch_file);
    bool all_done = !pods.empty();
    // Batch backend: ONE list per tick covers every watched pod —
    // O(1) subprocesses/apiserver calls however many workers the job
    // has. Only taken when some pod still needs a status read.
    std::map<std::string, std::string> batch;
    bool have_batch = false;
    for (const std::string& pod : pods) {
      if (satisfied.count(pod) != 0) continue;
      std::string phase;
      if (!status_batch_cmd.empty()) {
        if (!have_batch) {
          batch = PodPhasesFromBatchCmd(status_batch_cmd);
          have_batch = true;
        }
        auto it = batch.find(pod);
        if (it != batch.end()) phase = it->second;
      } else {
        phase = status_dir.empty() ? PodPhaseFromCmd(status_cmd, pod)
                                   : PodPhaseFromDir(status_dir, pod);
      }
      if (phase == "Failed") {
        std::cerr << "tpu-watcher: pod " << pod << " Failed\n";
        return 1;
      }
      bool ok = mode == "finished"
                    ? phase == "Succeeded"
                    : (phase == "Running" || phase == "Succeeded");
      if (ok) {
        satisfied.insert(pod);
      } else {
        all_done = false;
      }
    }
    if (all_done) return 0;
    if (timeout_ms >= 0 && waited_ms >= timeout_ms) {
      std::cerr << "tpu-watcher: timed out after " << waited_ms << " ms\n";
      return 1;
    }
    usleep(static_cast<useconds_t>(poll_ms) * 1000);
    waited_ms += poll_ms;
  }
}
