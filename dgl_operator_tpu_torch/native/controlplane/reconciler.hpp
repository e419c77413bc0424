// TPUGraphJob reconciler — the control-plane state machine.
//
// Native C++ equivalent of the reference's Go operator
// (controllers/dgljob_controller.go). The reconciler here is a PURE
// FUNCTION over a snapshot of cluster state: it never talks to an API
// server. Callers (the `tpu-operator` CLI, the Python fake cluster in
// tests, a kube shim in deployment) feed it the job + observed child
// objects and apply the returned actions. That split keeps the entire
// phase machine unit-testable in-process — the same property the
// reference gets from envtest (controllers/suite_test.go:55-87), with
// no embedded etcd needed.
//
// Capability parity map (reference -> here):
//   genJobPhase (:1471-1509)            -> ComputePhase
//   buildLatestJobStatus (:320-396)     -> BuildStatus
//   Reconcile (:105-318)                -> Reconcile
//   buildConfigMap (:874-893)           -> BuildConfigMap
//   update{Hostfile,Partfile,Leadfile}  -> RenderHostfile/Partfile/Leadfile
//     InConfigMap (:1416-1469)
//   buildLauncherPod (:1066-1317)       -> BuildLauncherPod
//   buildWorkerOrPartitionerPod(:897-)  -> BuildWorkerPod/BuildPartitionerPod
//   buildServiceForWorker (:496-519)    -> BuildWorkerService
//   buildRole/buildPartitionerRole      -> BuildLauncherRole/BuildPartitionerRole
//   deleteWorkersAndServices (:749-808) -> cleanup actions per CleanPodPolicy
//
// TPU-first divergences (SURVEY.md §7):
//  - Worker pods carry `google.com/tpu` resources and the
//    jax.distributed coordinator env (worker-0 : COORDINATOR_PORT)
//    instead of 20 host ports + torch.distributed rendezvous.
//  - The exec wrapper rendered into the ConfigMap is the fabric's
//    `exec.sh` (launcher/fabric.py ShellFabric contract).
//  - Skip partition mode is a first-class path through the phase
//    machine (the reference leaves Skip jobs stuck in Pending because
//    genJobPhase returns Pending whenever the partitioner spec is nil).
#pragma once

#include <string>

#include "json.hpp"

namespace cp {

// ---- constants (parity: api/v1alpha1/dgljob_types.go) ----------------
inline constexpr int kTPUPort = 30050;          // DGL_PORT parity
inline constexpr int kCoordinatorPort = 8476;   // jax.distributed default
inline constexpr char kGroupVersion[] = "tpu.graph/v1alpha1";
inline constexpr char kJobKind[] = "TPUGraphJob";

// Phases (dgljob_types.go:40-50).
inline constexpr char kPhaseStarting[] = "Starting";
inline constexpr char kPhasePending[] = "Pending";
inline constexpr char kPhasePartitioning[] = "Partitioning";
inline constexpr char kPhasePartitioned[] = "Partitioned";
inline constexpr char kPhaseTraining[] = "Training";
inline constexpr char kPhaseCompleted[] = "Completed";
inline constexpr char kPhaseFailed[] = "Failed";
inline constexpr char kPhaseEvicted[] = "Evicted";

// Replica types (dgljob_types.go:76-82).
inline constexpr char kReplicaLauncher[] = "Launcher";
inline constexpr char kReplicaWorker[] = "Worker";
inline constexpr char kReplicaPartitioner[] = "Partitioner";

// Partition modes (dgljob_types.go:110-127; "TPU-API" is the DGL-API
// equivalent: the operator injects a partitioner pod).
inline constexpr char kModeTPUAPI[] = "TPU-API";
inline constexpr char kModeExternal[] = "External";  // ParMETIS parity
inline constexpr char kModeSkip[] = "Skip";

// CleanPodPolicy (dgljob_types.go).
inline constexpr char kCleanAll[] = "All";
inline constexpr char kCleanRunning[] = "Running";
inline constexpr char kCleanNone[] = "None";

// Pod-name suffixes.
inline constexpr char kLauncherSuffix[] = "-launcher";
inline constexpr char kWorkerSuffix[] = "-worker";
inline constexpr char kPartitionerSuffix[] = "-partitioner";
inline constexpr char kConfigSuffix[] = "-config";

// Env contract (parity: DGL_OPERATOR_* dgljob_controller.go:58-63,
// names match dgl_operator_tpu_torch/parallel/bootstrap.py and
// launcher/fabric.py).
inline constexpr char kEnvPhase[] = "TPU_OPERATOR_PHASE_ENV";
inline constexpr char kEnvHostfile[] = "TPU_OPERATOR_HOSTFILE_PATH";
inline constexpr char kEnvExecPath[] = "TPU_OPERATOR_EXEC_PATH";
inline constexpr char kEnvCopyPath[] = "TPU_OPERATOR_COPY_PATH";
inline constexpr char kEnvRank[] = "TPU_OPERATOR_RANK";
inline constexpr char kEnvCoordinator[] = "TPU_OPERATOR_COORDINATOR";
inline constexpr char kEnvKube[] = "TPU_OPERATOR_ENV";
inline constexpr char kConfMountPath[] = "/etc/tpugraph";

struct ReconcileResult {
  Json actions = Json::array();  // ordered actions for the store driver
  Json status;                   // desired job .status (object)
  bool requeue = false;
};

// Pure phase computation from spec replica counts + tallied replica
// statuses (genJobPhase parity, with the Skip-mode fix described above).
std::string ComputePhase(const Json& job, const Json& replica_statuses);

// Tally observed pods into {Launcher,Worker,Partitioner} x
// {pending,starting,running,succeeded,failed} + "ready" strings
// (buildLatestJobStatus parity).
Json BuildStatus(const Json& job, const JsonArray& pods);

// Object builders (exposed for tests).
Json BuildConfigMap(const Json& job, const JsonArray& pods);
Json BuildLauncherPod(const Json& job, const std::string& watcher_image);
Json BuildWorkerPod(const Json& job, int index);
Json BuildPartitionerPod(const Json& job);
Json BuildWorkerService(const Json& job, const std::string& worker_name);
Json BuildServiceAccount(const Json& job, const std::string& name);
Json BuildLauncherRole(const Json& job);
Json BuildPartitionerRole(const Json& job);
Json BuildRoleBinding(const Json& job, const std::string& name);

// The reconciler. `state` is:
//   { "job": {...},
//     "pods": [...],                 // observed child pods
//     "configMap": {...}|null,       // observed config map
//     "existing": { "serviceAccounts": [..], "roles": [..],
//                    "roleBindings": [..], "services": [..] } }
// `watcher_image` parallels the manager's --watcher-loop-image flag
// (main.go:62-63).
ReconcileResult Reconcile(const Json& state, const std::string& watcher_image);

}  // namespace cp
