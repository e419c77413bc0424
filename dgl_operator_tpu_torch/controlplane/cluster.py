"""FakeCluster — in-process object store the reconciler drives.

Plays the role envtest plays for the reference (suite_test.go:55-87): a
real reconciler against a cluster with no kubelet, so pods never run on
their own — tests flip pod phases by hand and assert the job phase
machine responds (dgljob_controller_test.go:151-213). The same
apply-actions surface is what a production kube shim implements against
the real API server.

It also materializes the watcher status view: every pod's phase is
mirrored to ``<status_dir>/<podname>`` so a real ``tpu-watcher`` process
can run its barrier against this cluster (watcher tests do exactly
that).

The port's copy of the JAX package's ``controlplane/cluster.py``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional


class FakeCluster:
    def __init__(self, status_dir: Optional[str] = None):
        self.pods: Dict[str, Dict[str, Any]] = {}
        self.config_maps: Dict[str, Dict[str, Any]] = {}
        self.services: Dict[str, Dict[str, Any]] = {}
        self.service_accounts: Dict[str, Dict[str, Any]] = {}
        self.roles: Dict[str, Dict[str, Any]] = {}
        self.role_bindings: Dict[str, Dict[str, Any]] = {}
        self.pod_groups: Dict[str, Dict[str, Any]] = {}
        self.status_dir = status_dir
        self._next_ip = 1
        self.events: List[str] = []   # applied-action audit trail

    # ---- store snapshot fed to the reconciler ------------------------
    def state(self, job: Dict[str, Any],
              config_name: str) -> Dict[str, Any]:
        return {
            "job": job,
            "pods": [copy.deepcopy(p) for p in
                     sorted(self.pods.values(),
                            key=lambda p: p["metadata"]["name"])],
            "configMap": copy.deepcopy(
                self.config_maps.get(config_name)),
            "existing": {
                "serviceAccounts": sorted(self.service_accounts),
                "roles": sorted(self.roles),
                "roleBindings": sorted(self.role_bindings),
                "services": sorted(self.services),
                "podGroups": sorted(self.pod_groups),
            },
        }

    # ---- action application ------------------------------------------
    def apply(self, actions: List[Dict[str, Any]]) -> None:
        for a in actions:
            op = a["op"]
            if op in ("create", "update"):
                obj = a["object"]
                kind = obj.get("kind")
                name = obj["metadata"]["name"]
                self._bucket(kind)[name] = obj
                self.events.append(f"{op}:{kind}/{name}")
                if kind == "Pod" and op == "create":
                    # admission: new pods start Pending with no IP
                    obj.setdefault("status", {"phase": "Pending"})
                    self._mirror_status(name)
            elif op == "delete":
                kind, name = a["kind"], a["name"]
                self._bucket(kind).pop(name, None)
                self.events.append(f"delete:{kind}/{name}")
                if kind == "Pod":
                    self._unmirror_status(name)

    def _bucket(self, kind: str) -> Dict[str, Dict[str, Any]]:
        return {
            "Pod": self.pods,
            "ConfigMap": self.config_maps,
            "Service": self.services,
            "ServiceAccount": self.service_accounts,
            "Role": self.roles,
            "RoleBinding": self.role_bindings,
            "PodGroup": self.pod_groups,
        }[kind]

    # ---- the "kubelet" tests play by hand ----------------------------
    def set_pod_phase(self, name: str, phase: str,
                      assign_ip: bool = True,
                      reason: Optional[str] = None) -> None:
        pod = self.pods[name]
        pod.setdefault("status", {})["phase"] = phase
        if reason is not None:   # e.g. kubelet evictions: Failed/Evicted
            pod["status"]["reason"] = reason
        if assign_ip and not pod["status"].get("podIP"):
            pod["status"]["podIP"] = f"10.1.0.{self._next_ip}"
            self._next_ip += 1
        self._mirror_status(name)

    def pod_names(self) -> List[str]:
        return sorted(self.pods)

    def _mirror_status(self, name: str) -> None:
        if self.status_dir is None:
            return
        os.makedirs(self.status_dir, exist_ok=True)
        phase = self.pods[name].get("status", {}).get("phase", "Pending")
        with open(os.path.join(self.status_dir, name), "w") as f:
            f.write(phase + "\n")

    def _unmirror_status(self, name: str) -> None:
        if self.status_dir is None:
            return
        try:
            os.remove(os.path.join(self.status_dir, name))
        except FileNotFoundError:
            pass
