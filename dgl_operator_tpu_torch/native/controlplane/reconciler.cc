#include "reconciler.hpp"

#include <algorithm>
#include <ctime>
#include <string>
#include <vector>

namespace cp {
namespace {

std::string JobName(const Json& job) {
  return job.get("metadata").get("name").as_string();
}
std::string JobNamespace(const Json& job) {
  const std::string& ns = job.get("metadata").get("namespace").as_string();
  return ns.empty() ? "default" : ns;
}
std::string PartitionMode(const Json& job) {
  const std::string& m = job.get("spec").get("partitionMode").as_string();
  return m.empty() ? kModeTPUAPI : m;  // kubebuilder default parity
}
std::string CleanPolicy(const Json& job) {
  const std::string& p = job.get("spec").get("cleanPodPolicy").as_string();
  return p.empty() ? kCleanRunning : p;
}
bool CleanUpPods(const Json& job) {
  return CleanPolicy(job) != kCleanNone;  // isCleanUpPods parity
}

const Json& ReplicaSpec(const Json& job, const std::string& rtype) {
  return job.get("spec").get("replicaSpecs").get(rtype);
}

// Effective replica count. The reference injects a defaulted partitioner
// spec (replicas=1) for DGL-API mode inside Reconcile (:181-189); we
// fold that defaulting in here so ComputePhase sees it too.
int Replicas(const Json& job, const std::string& rtype) {
  const Json& spec = ReplicaSpec(job, rtype);
  if (spec.is_null()) {
    if (rtype == kReplicaPartitioner && PartitionMode(job) == kModeTPUAPI) {
      return 1;
    }
    return rtype == kReplicaLauncher ? 1 : 0;
  }
  return static_cast<int>(spec.get("replicas").as_int(
      rtype == kReplicaPartitioner || rtype == kReplicaLauncher ? 1 : 0));
}

int SlotsPerWorker(const Json& job) {
  return static_cast<int>(job.get("spec").get("slotsPerWorker").as_int(1));
}

// ---- multi-host TPU slice scheduling --------------------------------
// The reference wires worker pods for its fabric with live hostfile
// ConfigMap updates (dgljob_controller.go:897-1063, 1416-1437). On GKE
// a multi-host TPU slice additionally needs (a) accelerator/topology
// node selectors so the gang lands on one slice's nodes and (b) the
// per-worker libtpu env (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES) that
// multi-host runtimes read when no GKE metadata server injects them.
// spec.tpu: {accelerator: string, topology: string} — topology is
// derived from total chip count (slotsPerWorker x workers) when unset.

std::string TpuAccelerator(const Json& job) {
  return job.get("spec").get("tpu").get("accelerator").as_string();
}

std::string TpuTopology(const Json& job) {
  const std::string t = job.get("spec").get("tpu").get("topology")
                            .as_string();
  if (!t.empty()) return t;
  // Only the v5e family's 2-D slice shapes are derivable from a chip
  // count; other families (v4/v5p are 3-D) must set topology
  // explicitly — a wrong guess would stamp a selector no node matches
  // and wedge the gang Pending forever.
  if (TpuAccelerator(job).find("v5-lite") == std::string::npos) {
    return "";
  }
  static const struct { int chips; const char* topo; } kShapes[] = {
      {1, "1x1"},  {4, "2x2"},   {8, "2x4"},    {16, "4x4"},
      {32, "4x8"}, {64, "8x8"},  {128, "8x16"}, {256, "16x16"}};
  const int chips = SlotsPerWorker(job) * Replicas(job, kReplicaWorker);
  for (const auto& s : kShapes) {
    if (s.chips == chips) return s.topo;
  }
  return "";  // irregular count: schedule by accelerator alone
}

// Comma-separated worker hostnames, index order. Worker pod names equal
// their headless-service names (BuildWorkerService), so these resolve
// in-cluster without waiting for pod IPs; the mounted hostfile carries
// the live IPs (UpdateConfigMap) exactly like the reference's.
std::string TpuWorkerHostnames(const Json& job) {
  std::string out;
  const int n = Replicas(job, kReplicaWorker);
  for (int i = 0; i < n; ++i) {
    if (i) out += ",";
    out += JobName(job) + kWorkerSuffix + "-" + std::to_string(i);
  }
  return out;
}

std::string NowISO() {
  char buf[32];
  std::time_t t = std::time(nullptr);
  std::tm tm_utc;
  gmtime_r(&t, &tm_utc);
  std::strftime(buf, sizeof(buf), "%Y-%m-%dT%H:%M:%SZ", &tm_utc);
  return buf;
}

Json MakeMeta(const Json& job, const std::string& name) {
  Json meta = Json::object();
  meta["name"] = name;
  meta["namespace"] = JobNamespace(job);
  Json labels = Json::object();
  labels["app"] = JobName(job);
  meta["labels"] = labels;
  Json owner = Json::object();
  owner["apiVersion"] = kGroupVersion;
  owner["kind"] = kJobKind;
  owner["name"] = JobName(job);
  // A real API server rejects ownerReferences without uid
  // ("metadata.ownerReferences.uid: uid must not be empty"); carry it
  // through from the snapshot when present (FakeCluster jobs may omit
  // it, which only the fake tolerates).
  const std::string& uid = job.get("metadata").get("uid").as_string();
  if (!uid.empty()) owner["uid"] = uid;
  owner["controller"] = true;
  owner["blockOwnerDeletion"] = true;
  Json owners = Json::array();
  owners.push_back(owner);
  meta["ownerReferences"] = owners;
  return meta;
}

void AddEnv(Json* container, const std::string& name,
            const std::string& value) {
  Json e = Json::object();
  e["name"] = name;
  e["value"] = value;
  (*container)["env"].push_back(e);
}

void AddPort(Json* container, const std::string& name, int port) {
  Json p = Json::object();
  p["name"] = name;
  p["containerPort"] = port;
  p["protocol"] = "TCP";
  (*container)["ports"].push_back(p);
}

void AddMount(Json* container, const std::string& vol,
              const std::string& path) {
  Json m = Json::object();
  m["name"] = vol;
  m["mountPath"] = path;
  (*container)["volumeMounts"].push_back(m);
}

// ConfigMap projection volume with the exec wrapper executable and the
// rendezvous files read-only (mode parity: dgljob_controller.go
// scriptsMode 0555 / hostfileMode 0444).
Json ConfigVolume(const Json& job) {
  Json items = Json::array();
  auto add = [&items](const char* key, int mode) {
    Json it = Json::object();
    it["key"] = key;
    it["path"] = key;
    it["mode"] = mode;
    items.push_back(it);
  };
  add("exec.sh", 0555);
  add("hostfile", 0444);
  add("partfile", 0444);
  add("leadfile", 0444);
  Json v = Json::object();
  v["name"] = "tpugraph-config";
  Json src = Json::object();
  src["name"] = JobName(job) + kConfigSuffix;
  src["items"] = items;
  Json cmv = Json::object();
  cmv["configMap"] = src;
  v["volumeSource"] = cmv;
  return v;
}

Json WatcherInitContainer(const Json& job, const std::string& name,
                          const std::string& watch_file,
                          const std::string& mode,
                          const std::string& image) {
  Json c = Json::object();
  c["name"] = name;
  c["image"] = image;
  // Env contract parity: watcher-loop/app/options/options.go:55-61.
  AddEnv(&c, "NAMESPACE", JobNamespace(job));
  AddEnv(&c, "WATCHERFILE",
         std::string(kConfMountPath) + "/" + watch_file);
  AddEnv(&c, "WATCHERMODE", mode);
  // Scope the image's one-LIST-per-tick status backend to this job's
  // pods (every pod the reconciler builds carries app=<job>).
  AddEnv(&c, "WATCH_SELECTOR", "app=" + JobName(job));
  AddMount(&c, "tpugraph-config", kConfMountPath);
  return c;
}

// Deep-copy the user pod template's first container, or an empty one.
Json TemplateContainer(const Json& rspec) {
  const Json& containers =
      rspec.get("template").get("spec").get("containers");
  if (containers.is_array() && containers.size() > 0) {
    return containers.elems()[0];
  }
  return Json::object();
}

Json FinishPod(const Json& job, const std::string& name,
               const std::string& rtype, Json container, Json volumes,
               Json init_containers, const std::string& service_account) {
  Json pod = Json::object();
  pod["apiVersion"] = "v1";
  pod["kind"] = "Pod";
  Json meta = MakeMeta(job, name);
  meta["labels"]["tpu.graph/replica-name"] = name;
  meta["labels"]["tpu.graph/replica-type"] = rtype;
  Json ann = Json::object();
  ann["tpu.graph/replica-type"] = rtype;
  meta["annotations"] = ann;
  pod["metadata"] = meta;
  Json spec = Json::object();
  spec["restartPolicy"] = "Never";
  Json containers = Json::array();
  containers.push_back(container);
  spec["containers"] = containers;
  if (init_containers.size() > 0) spec["initContainers"] = init_containers;
  spec["volumes"] = volumes;
  if (!service_account.empty()) {
    spec["serviceAccountName"] = service_account;
  }
  pod["spec"] = spec;
  return pod;
}

// Sorted copy of the pods of one replica type that already have an IP.
std::vector<const Json*> PodsOfType(const JsonArray& pods,
                                    const std::string& rtype,
                                    bool need_ip) {
  std::vector<const Json*> out;
  for (const Json& p : pods) {
    if (p.get("metadata").get("annotations")
            .get("tpu.graph/replica-type").as_string() != rtype) {
      continue;
    }
    if (need_ip && p.get("status").get("podIP").as_string().empty()) {
      continue;
    }
    out.push_back(&p);
  }
  std::sort(out.begin(), out.end(), [](const Json* a, const Json* b) {
    return a->get("metadata").get("name").as_string() <
           b->get("metadata").get("name").as_string();
  });
  return out;
}

}  // namespace

// ---------------------------------------------------------------------
// Status + phase machine
// ---------------------------------------------------------------------

Json BuildStatus(const Json& job, const JsonArray& pods) {
  Json statuses = Json::object();
  for (const char* rtype :
       {kReplicaLauncher, kReplicaWorker, kReplicaPartitioner}) {
    Json rs = Json::object();
    rs["pending"] = 0;
    rs["starting"] = 0;
    rs["running"] = 0;
    rs["succeeded"] = 0;
    rs["failed"] = 0;
    rs["evicted"] = 0;
    statuses[rtype] = rs;
  }
  for (const Json& pod : pods) {
    const std::string& rtype = pod.get("metadata").get("annotations")
                                   .get("tpu.graph/replica-type").as_string();
    if (!statuses.has(rtype)) continue;
    const std::string& phase = pod.get("status").get("phase").as_string();
    Json& rs = statuses[rtype];
    if (phase == "Pending") {
      rs["pending"] = rs.get("pending").as_int() + 1;
    } else if (phase == "Running") {
      rs["running"] = rs.get("running").as_int() + 1;
    } else if (phase == "Succeeded") {
      rs["succeeded"] = rs.get("succeeded").as_int() + 1;
    } else if (phase == "Failed") {
      rs["failed"] = rs.get("failed").as_int() + 1;
      // kubelet reports node-pressure evictions as Failed pods with
      // status.reason Evicted; track them so the job phase can say WHY
      // (the reference declares the Evicted phase but never sets it,
      // dgljob_types.go:48 — this exceeds parity). A controller-
      // declared stall (reason Stalled, set from the job-health
      // snapshot: the pod looks Running but its trainer stopped
      // heartbeating) is the same transient condition — replace the
      // pod, don't fail the job.
      const std::string& reason =
          pod.get("status").get("reason").as_string();
      if (reason == "Evicted" || reason == "Stalled") {
        rs["evicted"] = rs.get("evicted").as_int() + 1;
      }
    }
  }
  for (const char* rtype :
       {kReplicaLauncher, kReplicaWorker, kReplicaPartitioner}) {
    Json& rs = statuses[rtype];
    rs["ready"] = std::to_string(rs.get("running").as_int()) + "/" +
                  std::to_string(Replicas(job, rtype));
  }
  Json status = Json::object();
  status["replicaStatuses"] = statuses;
  return status;
}

std::string ComputePhase(const Json& job, const Json& replica_statuses) {
  // Spec sanity gate (genJobPhase nil checks :1472-1482). A launcher
  // spec is mandatory; a worker spec is mandatory unless Skip mode
  // (launcher-only jobs); the partitioner spec is defaulted by
  // Replicas() in TPU-API mode — Skip jobs no longer stall in Pending.
  bool skip = PartitionMode(job) == kModeSkip;
  if (ReplicaSpec(job, kReplicaLauncher).is_null() ||
      (!skip && ReplicaSpec(job, kReplicaWorker).is_null())) {
    return kPhasePending;
  }

  const std::string& prev = job.get("status").get("phase").as_string();
  if (prev == kPhaseCompleted) return kPhaseCompleted;  // sticky terminal
  if (prev == kPhaseFailed) return kPhaseFailed;

  auto count = [&replica_statuses](const char* rtype, const char* field) {
    return replica_statuses.get(rtype).get(field).as_int();
  };
  int launcher_want = Replicas(job, kReplicaLauncher);
  int worker_want = Replicas(job, kReplicaWorker);
  int part_want = skip ? 0 : Replicas(job, kReplicaPartitioner);

  // Branch order is genJobPhase parity (:1485-1509); the part_want > 0
  // guards keep zero-replica partitioner specs from reading as
  // "all partitioners running".
  if (part_want > 0 && count(kReplicaPartitioner, "running") == part_want) {
    return kPhasePartitioning;
  }
  if (part_want > 0 &&
      count(kReplicaPartitioner, "succeeded") == part_want &&
      count(kReplicaWorker, "running") == 0) {
    return kPhasePartitioned;
  }
  if (count(kReplicaLauncher, "running") == launcher_want &&
      count(kReplicaWorker, "running") == worker_want) {
    return kPhaseTraining;
  }
  if (count(kReplicaLauncher, "evicted") > 0 ||
      count(kReplicaWorker, "evicted") > 0 ||
      count(kReplicaPartitioner, "evicted") > 0) {
    return kPhaseEvicted;   // transient: self-healing replaces the pod
  }
  if (count(kReplicaLauncher, "failed") > 0 ||
      count(kReplicaWorker, "failed") > 0 ||
      count(kReplicaPartitioner, "failed") > 0) {
    return kPhaseFailed;
  }
  if (count(kReplicaLauncher, "succeeded") == launcher_want) {
    return kPhaseCompleted;
  }
  return kPhaseStarting;
}

// ---------------------------------------------------------------------
// Object builders
// ---------------------------------------------------------------------

Json BuildConfigMap(const Json& job, const JsonArray& pods) {
  // exec.sh keeps the exact kubexec.sh calling convention the fabric's
  // ShellFabric speaks: `sh exec.sh <pod> '<cmd>'`
  // (buildConfigMap parity, dgljob_controller.go:875-879).
  std::string execsh =
      "#!/bin/sh\n"
      "set -x\n"
      "POD_NAME=$1; shift\n"
      "${TPU_OPERATOR_KUBECTL:-kubectl} exec ${POD_NAME} -- /bin/sh -c "
      "\"$*\"\n";

  // hostfile: `ip port podname slots=N` per running worker, sorted by
  // pod name so ranks are stable (updateHostfileInConfigMap :1416-1437).
  std::string hostfile, partfile, leadfile;
  int slots = SlotsPerWorker(job);
  int i = 0;
  for (const Json* p : PodsOfType(pods, kReplicaWorker, true)) {
    hostfile += p->get("status").get("podIP").as_string() + " " +
                std::to_string(kTPUPort) + " " + JobName(job) +
                kWorkerSuffix + "-" + std::to_string(i++) +
                " slots=" + std::to_string(slots) + "\n";
  }
  for (const Json* p : PodsOfType(pods, kReplicaPartitioner, true)) {
    partfile += p->get("status").get("podIP").as_string() + " " +
                std::to_string(kTPUPort) + " " + JobName(job) +
                kPartitionerSuffix + "\n";
  }
  for (const Json* p : PodsOfType(pods, kReplicaLauncher, true)) {
    leadfile += p->get("status").get("podIP").as_string() + " " +
                std::to_string(kTPUPort) + " " + JobName(job) +
                kLauncherSuffix + "\n";
  }

  Json cm = Json::object();
  cm["apiVersion"] = "v1";
  cm["kind"] = "ConfigMap";
  cm["metadata"] = MakeMeta(job, JobName(job) + kConfigSuffix);
  Json data = Json::object();
  data["exec.sh"] = execsh;
  data["hostfile"] = hostfile;
  data["partfile"] = partfile;
  data["leadfile"] = leadfile;
  cm["data"] = data;
  return cm;
}

Json BuildLauncherPod(const Json& job, const std::string& watcher_image) {
  std::string name = JobName(job) + kLauncherSuffix;
  Json c = TemplateContainer(ReplicaSpec(job, kReplicaLauncher));
  if (c.get("name").as_string().empty()) c["name"] = "launcher";
  AddEnv(&c, kEnvKube, "1");
  AddEnv(&c, kEnvExecPath, std::string(kConfMountPath) + "/exec.sh");
  AddEnv(&c, kEnvHostfile, std::string(kConfMountPath) + "/hostfile");
  AddMount(&c, "tpugraph-config", kConfMountPath);

  Json inits = Json::array();
  if (PartitionMode(job) != kModeSkip) {
    // Barrier 1: block until the partitioner pod finishes
    // (initContainer order parity, dgljob_controller.go:1098-1194).
    inits.push_back(WatcherInitContainer(
        job, "watcher-partitioner", "partfile", "finished", watcher_image));
  }
  if (Replicas(job, kReplicaWorker) > 0) {
    // Barrier 2: block until every worker pod is Running.
    inits.push_back(WatcherInitContainer(
        job, "watcher-worker", "hostfile", "ready", watcher_image));
  }

  Json volumes = Json::array();
  volumes.push_back(ConfigVolume(job));
  return FinishPod(job, name, kReplicaLauncher, c, volumes, inits, name);
}

// ---- gang scheduling -----------------------------------------------
// TPU slice workers are all-or-nothing: a half-scheduled gang wedges
// jax.distributed.initialize forever, so the worker scale-out emits a
// PodGroup FIRST and stamps every worker into it. The reference ships
// only the RBAC for this (deploy/v1alpha1/dgl-operator.yaml:3148-3154,
// scheduling.{incubator.k8s.io,sigs.dev,volcano.sh} podgroups); here
// the controller actually drives it.
std::string GangScheduler(const Json& job) {
  // "" (default) = gang scheduling off; "volcano" | "coscheduling"
  return job.get("spec").get("gangScheduler").as_string();
}

std::string GangSchedulerName(const Json& job) {
  const std::string& override_name =
      job.get("spec").get("schedulerName").as_string();
  if (!override_name.empty()) return override_name;
  return GangScheduler(job) == "volcano" ? "volcano"
                                         : "scheduler-plugins-scheduler";
}

std::string PodGroupName(const Json& job) {
  return JobName(job) + "-gang";
}

Json BuildPodGroup(const Json& job) {
  Json pg = Json::object();
  // coscheduling = sig scheduler-plugins, which serves
  // scheduling.x-k8s.io/v1alpha1 (the older scheduling.sigs.k8s.io
  // group is long retired)
  pg["apiVersion"] = GangScheduler(job) == "volcano"
                         ? "scheduling.volcano.sh/v1beta1"
                         : "scheduling.x-k8s.io/v1alpha1";
  pg["kind"] = "PodGroup";
  pg["metadata"] = MakeMeta(job, PodGroupName(job));
  Json spec = Json::object();
  // the gate protects the scale-out: every worker or none
  spec["minMember"] = Replicas(job, kReplicaWorker);
  pg["spec"] = spec;
  return pg;
}

// Stamp a worker pod into the job's gang: scheduler selection plus the
// group membership markers both scheduler families understand
// (volcano: the scheduling.k8s.io/group-name annotation; sig
// scheduler-plugins: the scheduling.x-k8s.io/pod-group label).
void ApplyGang(const Json& job, Json* pod) {
  if (GangScheduler(job).empty()) return;
  (*pod)["spec"]["schedulerName"] = GangSchedulerName(job);
  (*pod)["metadata"]["annotations"]["scheduling.k8s.io/group-name"] =
      PodGroupName(job);
  (*pod)["metadata"]["labels"]["scheduling.x-k8s.io/pod-group"] =
      PodGroupName(job);
}

Json BuildWorkerPod(const Json& job, int index) {
  std::string name =
      JobName(job) + kWorkerSuffix + "-" + std::to_string(index);
  Json c = TemplateContainer(ReplicaSpec(job, kReplicaWorker));
  if (c.get("name").as_string().empty()) c["name"] = "worker";
  // Exec-fabric-driven by default, like the reference's sleep workers
  // (:930-932); a template command overrides for self-rendezvous pods.
  if (c.get("command").size() == 0) {
    Json cmd = Json::array();
    cmd.push_back("sleep");
    c["command"] = cmd;
    Json args = Json::array();
    args.push_back("365d");
    c["args"] = args;
  }
  AddEnv(&c, kEnvKube, "1");
  AddEnv(&c, kEnvHostfile, std::string(kConfMountPath) + "/hostfile");
  AddEnv(&c, kEnvRank, std::to_string(index));
  // jax.distributed coordinator = worker-0's headless service
  // (SURVEY.md §2 "TPU-native equivalent"; replaces torch master_addr).
  AddEnv(&c, kEnvCoordinator,
         JobName(job) + kWorkerSuffix + "-0:" +
             std::to_string(kCoordinatorPort));
  AddPort(&c, "fabric", kTPUPort);
  AddPort(&c, "coordinator", kCoordinatorPort);
  // slotsPerWorker maps to TPU chips per pod (google.com/tpu), the
  // moral successor of slots in the MPI hostfile sense.
  if (c.get("resources").is_null()) {
    Json lim = Json::object();
    lim["google.com/tpu"] = SlotsPerWorker(job);
    Json res = Json::object();
    res["limits"] = lim;
    c["resources"] = res;
  }
  // multi-host TPU slice wiring: per-worker libtpu env. The worker's
  // slice-local id is its index; the hostname list is the full gang in
  // index order (the static view of the hostfile the ConfigMap serves
  // live — reference analog dgljob_controller.go:1416-1437).
  const std::string accel = TpuAccelerator(job);
  if (!accel.empty()) {
    AddEnv(&c, "TPU_WORKER_ID", std::to_string(index));
    AddEnv(&c, "TPU_WORKER_HOSTNAMES", TpuWorkerHostnames(job));
  }
  AddMount(&c, "tpugraph-config", kConfMountPath);
  AddMount(&c, "shm", "/dev/shm");

  Json volumes = Json::array();
  volumes.push_back(ConfigVolume(job));
  Json shm = Json::object();
  shm["name"] = "shm";
  Json ed = Json::object();
  ed["medium"] = "Memory";
  Json eds = Json::object();
  eds["emptyDir"] = ed;
  shm["volumeSource"] = eds;
  volumes.push_back(shm);
  Json pod = FinishPod(job, name, kReplicaWorker, c, volumes,
                       Json::array(), "");
  if (!accel.empty()) {
    // land the gang on one TPU slice's node pool: GKE schedules TPU
    // slices by accelerator type + physical topology node selectors
    Json sel = Json::object();
    sel["cloud.google.com/gke-tpu-accelerator"] = accel;
    const std::string topo = TpuTopology(job);
    if (!topo.empty()) {
      sel["cloud.google.com/gke-tpu-topology"] = topo;
    }
    pod["spec"]["nodeSelector"] = sel;
  }
  ApplyGang(job, &pod);
  return pod;
}

Json BuildPartitionerPod(const Json& job) {
  std::string name = JobName(job) + kPartitionerSuffix;
  // Partitioner reuses the worker template but runs the launcher's
  // command under PHASE_ENV=Partitioner (:1025-1034) — tpurun switches
  // on that env to run phases 1-2.
  const Json& wspec = ReplicaSpec(job, kReplicaWorker);
  Json c = TemplateContainer(wspec.is_null()
                                 ? ReplicaSpec(job, kReplicaLauncher)
                                 : wspec);
  if (c.get("name").as_string().empty()) c["name"] = "partitioner";
  Json launcher_c = TemplateContainer(ReplicaSpec(job, kReplicaLauncher));
  if (!launcher_c.get("command").is_null()) {
    c["command"] = launcher_c.get("command");
  }
  if (!launcher_c.get("args").is_null()) {
    c["args"] = launcher_c.get("args");
  }
  AddEnv(&c, kEnvKube, "1");
  AddEnv(&c, kEnvPhase, "Partitioner");
  AddEnv(&c, kEnvExecPath, std::string(kConfMountPath) + "/exec.sh");
  AddMount(&c, "tpugraph-config", kConfMountPath);

  Json volumes = Json::array();
  volumes.push_back(ConfigVolume(job));
  return FinishPod(job, name, kReplicaPartitioner, c, volumes,
                   Json::array(), name);
}

Json BuildWorkerService(const Json& job, const std::string& worker_name) {
  Json svc = Json::object();
  svc["apiVersion"] = "v1";
  svc["kind"] = "Service";
  svc["metadata"] = MakeMeta(job, worker_name);
  Json spec = Json::object();
  spec["clusterIP"] = "None";  // headless (buildServiceForWorker :496-519)
  Json sel = Json::object();
  sel["tpu.graph/replica-name"] = worker_name;
  spec["selector"] = sel;
  Json ports = Json::array();
  Json p1 = Json::object();
  p1["name"] = "fabric";
  p1["port"] = kTPUPort;
  ports.push_back(p1);
  Json p2 = Json::object();
  p2["name"] = "coordinator";
  p2["port"] = kCoordinatorPort;
  ports.push_back(p2);
  spec["ports"] = ports;
  svc["spec"] = spec;
  return svc;
}

Json BuildServiceAccount(const Json& job, const std::string& name) {
  Json sa = Json::object();
  sa["apiVersion"] = "v1";
  sa["kind"] = "ServiceAccount";
  sa["metadata"] = MakeMeta(job, name);
  return sa;
}

namespace {
Json ExecRole(const Json& job, const std::string& name,
              const JsonArray& exec_pod_names) {
  Json role = Json::object();
  role["apiVersion"] = "rbac.authorization.k8s.io/v1";
  role["kind"] = "Role";
  role["metadata"] = MakeMeta(job, name);
  Json rules = Json::array();
  Json watch = Json::object();
  Json g1 = Json::array();
  g1.push_back("");
  watch["apiGroups"] = g1;
  Json r1 = Json::array();
  r1.push_back("pods");
  watch["resources"] = r1;
  Json v1 = Json::array();
  v1.push_back("get");
  v1.push_back("list");
  v1.push_back("watch");
  watch["verbs"] = v1;
  rules.push_back(watch);
  // pods/exec scoped to the exact target pod names
  // (least-privilege parity: buildRole :1346-1358).
  Json exec = Json::object();
  Json g2 = Json::array();
  g2.push_back("");
  exec["apiGroups"] = g2;
  Json r2 = Json::array();
  r2.push_back("pods/exec");
  exec["resources"] = r2;
  exec["resourceNames"] = exec_pod_names;
  Json v2 = Json::array();
  v2.push_back("create");
  exec["verbs"] = v2;
  rules.push_back(exec);
  role["rules"] = rules;
  return role;
}
}  // namespace

Json BuildLauncherRole(const Json& job) {
  JsonArray targets;
  for (int i = 0; i < Replicas(job, kReplicaWorker); i++) {
    targets.push_back(Json(JobName(job) + kWorkerSuffix + "-" +
                           std::to_string(i)));
  }
  return ExecRole(job, JobName(job) + kLauncherSuffix, targets);
}

Json BuildPartitionerRole(const Json& job) {
  JsonArray targets;
  targets.push_back(Json(JobName(job) + kLauncherSuffix));
  return ExecRole(job, JobName(job) + kPartitionerSuffix, targets);
}

Json BuildRoleBinding(const Json& job, const std::string& name) {
  Json rb = Json::object();
  rb["apiVersion"] = "rbac.authorization.k8s.io/v1";
  rb["kind"] = "RoleBinding";
  rb["metadata"] = MakeMeta(job, name);
  Json subj = Json::object();
  subj["kind"] = "ServiceAccount";
  subj["name"] = name;
  subj["namespace"] = JobNamespace(job);
  Json subjects = Json::array();
  subjects.push_back(subj);
  rb["subjects"] = subjects;
  Json ref = Json::object();
  ref["apiGroup"] = "rbac.authorization.k8s.io";
  ref["kind"] = "Role";
  ref["name"] = name;
  rb["roleRef"] = ref;
  return rb;
}

// ---------------------------------------------------------------------
// Reconcile
// ---------------------------------------------------------------------

namespace {

bool Contains(const Json& arr, const std::string& name) {
  for (const Json& v : arr.elems()) {
    if (v.as_string() == name) return true;
  }
  return false;
}

const Json* FindPod(const JsonArray& pods, const std::string& name) {
  for (const Json& p : pods) {
    if (p.get("metadata").get("name").as_string() == name) return &p;
  }
  return nullptr;
}

void Act(ReconcileResult* r, const std::string& op, Json object) {
  Json a = Json::object();
  a["op"] = op;
  a["object"] = std::move(object);
  r->actions.push_back(a);
}

void ActDelete(ReconcileResult* r, const std::string& kind,
               const std::string& name) {
  Json a = Json::object();
  a["op"] = "delete";
  a["kind"] = kind;
  a["name"] = name;
  r->actions.push_back(a);
}

void DeleteWorkersAndServices(const Json& job, const JsonArray& pods,
                              const Json& existing, ReconcileResult* r) {
  // deleteWorkersAndServices parity (:749-808): drop every worker pod
  // and its headless service.
  for (const Json* p : PodsOfType(pods, kReplicaWorker, false)) {
    ActDelete(r, "Pod", p->get("metadata").get("name").as_string());
  }
  for (const Json& s : existing.get("services").elems()) {
    ActDelete(r, "Service", s.as_string());
  }
}

}  // namespace

ReconcileResult Reconcile(const Json& state,
                          const std::string& watcher_image) {
  ReconcileResult result;
  const Json& job = state.get("job");
  if (job.is_null()) return result;  // deleted: nothing to do
  const JsonArray& pods = state.get("pods").elems();
  const Json& existing = state.get("existing");
  std::string name = JobName(job);
  std::string mode = PartitionMode(job);

  const std::string& prev_phase = job.get("status").get("phase").as_string();
  bool finished =
      prev_phase == kPhaseCompleted || prev_phase == kPhaseFailed;

  // ---- terminated-job handling (Reconcile :135-173) ------------------
  if (finished) {
    bool failed = prev_phase == kPhaseFailed;
    bool requeue =
        failed && job.get("status").get("completionTime").is_null();
    if (CleanUpPods(job)) {
      DeleteWorkersAndServices(job, pods, existing, &result);
    }
    if (requeue) {
      // Retry path: delete the failed launcher so it gets recreated.
      const Json* launcher = FindPod(pods, name + kLauncherSuffix);
      if (launcher != nullptr &&
          launcher->get("status").get("phase").as_string() == "Failed") {
        ActDelete(&result, "Pod",
                  launcher->get("metadata").get("name").as_string());
      }
      result.requeue = true;
    }
    result.status = job.get("status");
    if (result.status.get("completionTime").is_null()) {
      result.status["completionTime"] = NowISO();
    }
    return result;
  }

  // ---- eviction self-healing (exceeds reference parity: DGLJob
  // declares the Evicted phase but never sets or handles it,
  // dgljob_types.go:48). A kubelet eviction leaves the pod Failed with
  // status.reason Evicted; deleting it here lets the creation branches
  // below reschedule a replacement on the next pass, and ComputePhase
  // reports Evicted until the replacement runs.
  for (const Json& p : pods) {
    const std::string& preason = p.get("status").get("reason").as_string();
    if (p.get("status").get("phase").as_string() == "Failed" &&
        (preason == "Evicted" || preason == "Stalled")) {
      ActDelete(&result, "Pod",
                p.get("metadata").get("name").as_string());
      result.requeue = true;
    }
  }

  const Json* launcher = FindPod(pods, name + kLauncherSuffix);
  bool launcher_done =
      launcher != nullptr &&
      (launcher->get("status").get("phase").as_string() == "Succeeded" ||
       launcher->get("status").get("phase").as_string() == "Failed");

  if (!launcher_done) {
    // ---- ConfigMap with live rendezvous files (:209,523-543) ---------
    Json desired_cm = BuildConfigMap(job, pods);
    const Json& observed_cm = state.get("configMap");
    if (observed_cm.is_null()) {
      Act(&result, "create", desired_cm);
    } else if (observed_cm.get("data") != desired_cm.get("data")) {
      Act(&result, "update", desired_cm);
    }

    // ---- RBAC (launcher always; partitioner in TPU-API mode) ---------
    struct RbacSet {
      std::string account;
      Json role;
    };
    std::vector<RbacSet> rbac;
    rbac.push_back({name + kLauncherSuffix, BuildLauncherRole(job)});
    if (mode == kModeTPUAPI) {
      rbac.push_back({name + kPartitionerSuffix, BuildPartitionerRole(job)});
    }
    for (auto& set : rbac) {
      if (!Contains(existing.get("serviceAccounts"), set.account)) {
        Act(&result, "create", BuildServiceAccount(job, set.account));
      }
      if (!Contains(existing.get("roles"), set.account)) {
        Act(&result, "create", set.role);
      }
      if (!Contains(existing.get("roleBindings"), set.account)) {
        Act(&result, "create", BuildRoleBinding(job, set.account));
      }
    }

    // ---- launcher pod (:267-273) -------------------------------------
    if (launcher == nullptr) {
      Act(&result, "create", BuildLauncherPod(job, watcher_image));
    }
  }

  // ---- partitioner pod (TPU-API mode, :275-280) ----------------------
  if (mode == kModeTPUAPI &&
      FindPod(pods, name + kPartitionerSuffix) == nullptr &&
      !launcher_done) {
    Act(&result, "create", BuildPartitionerPod(job));
  }

  // ---- workers gated on phase (:282-302): only AFTER the partitioner
  // succeeded does the cluster scale out — Skip mode has no gate.
  bool workers_due = prev_phase == kPhasePartitioned ||
                     prev_phase == kPhaseTraining ||
                     prev_phase == kPhaseEvicted ||
                     (mode == kModeSkip && !launcher_done);
  if (workers_due) {
    // gang gate first: the PodGroup must exist before any worker pod
    // is admitted, or the scheduler places a partial gang
    if (!GangScheduler(job).empty() &&
        !Contains(existing.get("podGroups"), PodGroupName(job))) {
      Act(&result, "create", BuildPodGroup(job));
    }
    for (int i = 0; i < Replicas(job, kReplicaWorker); i++) {
      std::string wname = name + kWorkerSuffix + "-" + std::to_string(i);
      if (FindPod(pods, wname) == nullptr) {
        Act(&result, "create", BuildWorkerPod(job, i));
      }
      if (!Contains(existing.get("services"), wname)) {
        Act(&result, "create", BuildWorkerService(job, wname));
      }
    }
  }

  // ---- status (:306-315) ---------------------------------------------
  Json status = BuildStatus(job, pods);
  status["phase"] = ComputePhase(job, status.get("replicaStatuses"));
  const Json& start = job.get("status").get("startTime");
  status["startTime"] = start.is_null() ? Json(NowISO()) : start;
  const std::string& new_phase = status.get("phase").as_string();
  if (new_phase == kPhaseCompleted || new_phase == kPhaseFailed) {
    const Json& done_at = job.get("status").get("completionTime");
    status["completionTime"] = done_at.is_null() ? Json(NowISO()) : done_at;
  }
  result.status = status;
  return result;
}

}  // namespace cp
