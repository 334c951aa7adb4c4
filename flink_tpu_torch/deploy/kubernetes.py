"""Kubernetes deployment: manifest generation for a job cluster (port of
``flink_tpu/deploy/kubernetes.py``: the pods run ``python -m
flink_tpu_torch``).

Analog of the reference's ``flink-kubernetes``
(``KubernetesClusterDescriptor.java:68`` + the pod/ConfigMap builders in
``kubeclient/decorators/``) — redesigned for the process model here: instead
of an in-cluster client creating resources imperatively, this module RENDERS
the manifests (the `kubectl apply` workflow), because the coordinator and
workers are plain CLI entrypoints:

- **coordinator**: a ``Job`` running ``flink_tpu_torch coordinate --job M:F
  --workers N`` with ``spawn=False`` — it listens for worker registrations
  and drives deploy/checkpoints/shutdown;
- **workers**: an indexed ``StatefulSet`` of ``flink_tpu_torch worker`` pods, each
  dialing the coordinator Service and serving its data plane on the pod IP
  (``--bind 0.0.0.0 --advertise $(POD_IP)``);
- a headless ``Service`` fronts the coordinator's control port.

GPU pods: set ``tpu_resource`` (e.g. ``{"nvidia.com/gpu": 1}``, the card's
device-plugin resource) to attach accelerators to workers: a resource dict
on the worker container's limits, the ``ExternalResourceOptions``/GPU-driver
slot of the reference (SURVEY §2.2 "External resource framework").  A worker
runs on the card unless its ``worker_args`` say ``--device cpu``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def render_job_cluster(name: str, image: str, job: str, n_workers: int = 2,
                       namespace: str = "default",
                       control_port: int = 6123,
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_interval_ms: int = 0,
                       tpu_resource: Optional[Dict[str, Any]] = None,
                       env: Optional[Dict[str, str]] = None,
                       worker_args: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Render the manifest list (Service, coordinator Job, worker
    StatefulSet) for one job cluster.  ``job`` is the ``module:function``
    reference baked into ``image``."""
    labels = {"app": name, "managed-by": "flink-tpu"}
    envs = [{"name": k, "value": v} for k, v in (env or {}).items()]

    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"{name}-coordinator", "namespace": namespace,
                     "labels": labels},
        "spec": {
            "clusterIP": "None",
            "selector": {**labels, "component": "coordinator"},
            "ports": [{"name": "control", "port": control_port}],
        },
    }

    coord_cmd = ["python", "-m", "flink_tpu_torch", "coordinate",
                 "--job", job, "--workers", str(n_workers),
                 "--listen", f"0.0.0.0:{control_port}"]
    if checkpoint_dir:
        coord_cmd += ["--checkpoint-dir", checkpoint_dir,
                      "--checkpoint-interval", str(checkpoint_interval_ms)]
    coordinator = {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": f"{name}-coordinator", "namespace": namespace,
                     "labels": labels},
        "spec": {
            "backoffLimit": 0,
            "template": {
                "metadata": {"labels": {**labels,
                                        "component": "coordinator"}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "coordinator",
                        "image": image,
                        "command": coord_cmd,
                        "env": envs,
                        "ports": [{"containerPort": control_port}],
                    }],
                },
            },
        },
    }

    worker_container: Dict[str, Any] = {
        "name": "worker",
        "image": image,
        "command": ["/bin/sh", "-c",
                    " ".join([
                        "exec python -m flink_tpu_torch worker",
                        "--index ${POD_INDEX}",
                        f"--workers {n_workers}",
                        f"--job {job}",
                        f"--coordinator {name}-coordinator:{control_port}",
                        "--bind 0.0.0.0 --advertise ${POD_IP}",
                        *(worker_args or [])])],
        "env": envs + [
            {"name": "POD_IP",
             "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}}},
            {"name": "POD_INDEX",
             "valueFrom": {"fieldRef": {"fieldPath":
                                        "metadata.labels['apps.kubernetes."
                                        "io/pod-index']"}}},
        ],
    }
    if tpu_resource:
        worker_container["resources"] = {"limits": dict(tpu_resource)}

    worker_svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"{name}-worker", "namespace": namespace,
                     "labels": labels},
        "spec": {
            # governing headless Service of the StatefulSet: gives workers
            # stable per-pod DNS ({name}-worker-0.{name}-worker...)
            "clusterIP": "None",
            "selector": {**labels, "component": "worker"},
            "ports": [{"name": "data", "port": 6124}],
        },
    }

    workers = {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {"name": f"{name}-worker", "namespace": namespace,
                     "labels": labels},
        "spec": {
            "serviceName": f"{name}-worker",
            "replicas": n_workers,
            "selector": {"matchLabels": {**labels, "component": "worker"}},
            "template": {
                "metadata": {"labels": {**labels, "component": "worker"}},
                "spec": {"containers": [worker_container]},
            },
        },
    }
    return [svc, worker_svc, coordinator, workers]


def to_yaml(manifests: List[Dict[str, Any]]) -> str:
    """Multi-document YAML for ``kubectl apply -f -``."""
    import yaml

    return "---\n".join(
        yaml.safe_dump(m, sort_keys=False) for m in manifests)
